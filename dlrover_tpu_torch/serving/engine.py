"""ServeEngine and ServeExecutor: continuous-batching decode on one card
(port of ``dlrover_tpu/serving/engine.py``, its single-worker core).

``ServeEngine`` owns the config, the serve programs, the parameters and
the KV pool. A "program" is the set of closures built for one key (the
device, slot count, prefill chunk, mesh, KV precision, prefix-pool size
and draft length): the decode step, the prefill chunk, the verify step
when speculative decode is on, and the prefix pool's page copies. Built
programs are kept under their key (at most four), and
``compile_count`` counts builds. Each step runs under
``torch.inference_mode()`` and updates the pool in place, as the
reference donates it. The parameters are held in the config's compute
dtype: ``apply`` casts each layer to the same values as it runs.

``ServeExecutor`` runs the loop: admission into a fixed slot batch
(``serve_slots``), prefill chunked into the decode stream so a long
prompt cannot stall the batch, one decode step for the whole batch, and
a bounded window (``serve_window``) of decode calls whose tokens are
read on the host only once they are that many steps old: greedy
selection happens on the device, so step k+1 never waits for step k's
host copy. With ``spec_draft_len`` K > 0 each step is a verify step over
the drafts of a host n-gram proposer, which emits token for token what
plain greedy decode emits (``models.llama.verify_step``).

Elasticity on one device: ``prewarm`` builds the program of a
candidate knob set (or device) beside the active one and runs one dummy
step of each kind; ``retune`` swaps knobs through the program cache,
repacking live slots on the host when the slot count changes
(``kv_cache.migrate_slots_host``); ``live_resize`` takes a host
snapshot of ``{"params", "cache"[, "prefix"]}`` and restores it onto
the new device, live requests' pages included. The executor applies
``request_resize`` / ``request_retune`` at a drained boundary, polls
the master for serve plans and acks them (``report_serve_config``),
and pushes runtime reports through ``serving.slo``.

The engine serves on one device: ``devices`` defaults to the card and
raises without one; the tests pass ``devices=[torch.device("cpu")]``.
Several devices or ranks raise (ROADMAP A16c). ``router_client`` is any
object with ``serve_lease(max_requests=)``, ``serve_complete(**record)``
and ``serve_touch()``; with ``get_parallel_config()``,
``report_serve_config(**fields)`` and ``report_node_runtime(**fields)``
it also carries the plan loop and the runtime reports (the reference's
``MasterClient`` has all six).
"""

from __future__ import annotations

import collections
import itertools
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.models.common import tree_leaves, tree_map
from dlrover_tpu_torch.parallel.mesh import mesh_axes_key, topology_key
from dlrover_tpu_torch.serving.kv_cache import (
    KVCacheSpec,
    copy_page_to_pool,
    copy_page_to_slot,
    init_kv_cache,
    init_prefix_pool,
    migrate_slots_host,
    resolve_kv_precision,
    serve_shardings,
)
from dlrover_tpu_torch.serving.prefix_index import PrefixIndex
from dlrover_tpu_torch.serving.spec_decode import NgramProposer
from dlrover_tpu_torch.telemetry import (
    EventKind,
    SpanName,
    emit_event,
    get_registry,
    names as tm,
    span,
    trace_scope,
)
from dlrover_tpu_torch.telemetry.metrics import LATENCY_BUCKETS
from dlrover_tpu_torch.telemetry.trace_context import new_trace_id

logger = get_logger("serving.engine")


def _one_device(devices):
    """The one device of ``devices`` (None: the card); several raise."""
    devices = list(devices) if devices is not None else [None]
    if len(devices) != 1:
        raise NotImplementedError(
            f"serving over {len(devices)} devices is not ported yet "
            "(ROADMAP A16c)")
    return resolve_device(devices[0])


@dataclass
class ServeProgram:
    """One built serving world: its step closures and its pool layout."""

    decode: Callable
    prefill: Callable
    device: torch.device
    # {"params": ..., "cache"[, "prefix"]: ...} path -> spec (whole leaves
    # on one device)
    shardings: Dict[str, Any]
    spec: KVCacheSpec
    prefill_chunk: int
    # prefix-pool page copies (None while the pool is off)
    admit_copy: Optional[Callable] = None
    publish_copy: Optional[Callable] = None
    # speculative decode: the verify step and its draft length K (None /
    # 0 = off); mixed per-slot draft lengths ride its n_draft mask
    verify: Optional[Callable] = None
    spec_k: int = 0


def _resolve_knob(value, name: str, default):
    if value is not None:
        return value
    from dlrover_tpu_torch.common.config import get_context

    return getattr(get_context(), name, default)


def _fit_prefill_chunk(requested: int, pool_depth: int) -> int:
    """The largest divisor of the pool depth <= the requested chunk.

    Chunk cursors advance in whole chunks (only the last chunk is
    partial), so chunk starts are multiples of C, and with C | T every
    padded write window [start, start+C) lies inside the pool (the
    reference's ``dynamic_update_slice`` would clamp a window crossing
    the end onto earlier pages)."""
    want = max(1, min(int(requested), int(pool_depth)))
    for cand in range(want, 0, -1):
        if pool_depth % cand == 0:
            return cand
    return 1


def _h2d(array, device: torch.device) -> torch.Tensor:
    """A host array onto ``device`` without waiting for the copy: through
    a page-locked buffer, which the caching host allocator keeps until
    the copy has run."""
    t = torch.as_tensor(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _unflatten(pairs) -> Dict:
    tree: Dict = {}
    for path, leaf in pairs:
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


class ServeEngine:
    """Owns (config, serve programs, params, KV pool) on one device."""

    def __init__(self, config, strategy=None,
                 serve_slots: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 kv_precision: Optional[str] = None,
                 max_seq: int = 0, page_size: int = 16,
                 prefix_pool_pages: Optional[int] = None,
                 spec_draft_len: Optional[int] = None,
                 devices=None):
        from dlrover_tpu_torch.parallel.strategy import Strategy

        self._device = _one_device(devices)
        self._config = config
        self._base_strategy = strategy or Strategy(rule_set="llama")
        self.serve_slots = max(1, int(_resolve_knob(
            serve_slots, "serve_slots", 8)))
        self.kv_precision = resolve_kv_precision(kv_precision)
        self._max_seq = int(max_seq or config.max_seq_len)
        self._page_size = int(page_size)
        self._pool_depth = self._page_size * max(
            1, math.ceil(self._max_seq / self._page_size))
        self.prefill_chunk = _fit_prefill_chunk(
            int(_resolve_knob(prefill_chunk, "serve_prefill_chunk", 32)),
            self._pool_depth)
        self.prefix_pool_pages = max(0, int(_resolve_knob(
            prefix_pool_pages, "serve_prefix_pool_pages", 0)))
        # the master switch pins the draft length to 0 when off
        self.spec_enabled = bool(_resolve_knob(
            None, "serve_spec_enabled", True))
        self.spec_draft_len = (max(0, int(_resolve_knob(
            spec_draft_len, "serve_spec_draft_len", 0)))
            if self.spec_enabled else 0)
        self._programs: "collections.OrderedDict[str, ServeProgram]" = (
            collections.OrderedDict())
        self._program_cache_cap = 4
        self.compile_count = 0
        self.program: Optional[ServeProgram] = None
        self.params = None
        self.cache = None
        # the shared prefix pool's pages and the host index that owns
        # their meaning (None while the knob is 0)
        self.pool = None
        self.prefix_index: Optional[PrefixIndex] = None

    @property
    def device(self) -> torch.device:
        return self._device

    # -- program cache -------------------------------------------------------

    def _spec(self) -> KVCacheSpec:
        return KVCacheSpec.from_model(
            self._config, num_slots=self.serve_slots,
            max_seq=self._max_seq, page_size=self._page_size,
            precision=self.kv_precision,
            prefix_pool_pages=self.prefix_pool_pages,
        )

    def _program_key(self, strategy, device: torch.device) -> str:
        return (topology_key([device])
                + f"|slots={self.serve_slots}"
                + f"|pc={self.prefill_chunk}"
                + f"|mesh={mesh_axes_key(strategy.mesh)}"
                + f"|kvp={self.kv_precision}"
                + f"|ppp={self.prefix_pool_pages}"
                + f"|spec={self.spec_draft_len}")

    def _build(self, device: Optional[torch.device] = None) -> ServeProgram:
        device = self._device if device is None else device
        strategy = self._base_strategy.adjust_to_world(1)
        key = self._program_key(strategy, device)
        reg = get_registry()
        cached = self._programs.get(key)
        if cached is not None:
            self._programs.move_to_end(key)
            reg.counter(tm.PROGRAM_CACHE_HITS,
                        help="rebuilds served from the program cache").inc()
            return cached
        reg.counter(tm.PROGRAM_CACHE_MISSES,
                    help="rebuilds that had to build").inc()
        program = self._compile(strategy, device)
        self.compile_count += 1
        self._programs[key] = program
        while len(self._programs) > self._program_cache_cap:
            self._programs.popitem(last=False)
        return program

    def _compile(self, strategy, device: torch.device) -> ServeProgram:
        from dlrover_tpu_torch.models import llama

        config = self._config
        spec = self._spec()
        shardings = serve_shardings(
            strategy.mesh.axis_sizes(), spec, llama.param_shapes(config),
            base_rule_set=strategy.rule_set)

        def decode(params, cache, tokens, active):
            return llama.decode_step(params, cache, tokens, active, config,
                                     spec)

        @torch.inference_mode()
        def prefill(params, cache, tokens, slot, start, n_valid):
            cache, last_logits = llama.prefill_chunk(
                params, cache, tokens, slot, start, n_valid, config, spec)
            # the final chunk's first token stays on the device: the
            # executor folds it into the decode batch, so admission never
            # waits on a host argmax
            return cache, last_logits, torch.argmax(last_logits).to(
                torch.int32)

        verify = None
        spec_k = int(self.spec_draft_len)
        if spec_k > 0:
            if spec_k + 1 > spec.max_seq:
                raise ValueError(f"spec_draft_len {spec_k} does not fit a "
                                 f"pool of {spec.max_seq} rows")

            def verify(params, cache, tokens, active, n_draft):
                return llama.verify_step(params, cache, tokens, active,
                                         n_draft, config, spec)

        admit_copy = publish_copy = None
        if spec.prefix_pool_pages > 0:
            @torch.inference_mode()
            def admit_copy(cache, pool, slot, dst_start, src_page):
                return copy_page_to_slot(cache, pool, slot, dst_start,
                                         src_page, spec)

            @torch.inference_mode()
            def publish_copy(pool, cache, slot, src_start, dst_page):
                return copy_page_to_pool(pool, cache, slot, src_start,
                                         dst_page, spec)

        logger.info("serve program built on %s: slots=%d chunk=%d kv=%s "
                    "spec_k=%d", device, spec.num_slots,
                    self.prefill_chunk, spec.precision, spec_k)
        return ServeProgram(
            decode=decode, prefill=prefill, device=device,
            shardings=shardings, spec=spec,
            prefill_chunk=self.prefill_chunk,
            admit_copy=admit_copy, publish_copy=publish_copy,
            verify=verify, spec_k=spec_k,
        )

    # -- lifecycle -----------------------------------------------------------

    def _place(self, params) -> Dict:
        """The serving copy of a parameter tree (tensors or numpy
        leaves): on the engine's device in the compute dtype, never
        sharing memory with the tree given."""
        from dlrover_tpu_torch.interop import params_from_numpy

        dtype = self._config.compute_dtype
        if not all(isinstance(t, torch.Tensor) for t in tree_leaves(params)):
            params = params_from_numpy(params, self._device)

        def leaf(t):
            t = t.detach()
            out = t.to(self._device,
                       dtype=dtype if t.is_floating_point() else t.dtype)
            if out.data_ptr() == t.data_ptr():
                out = out.clone()
            return out

        return tree_map(leaf, params)

    def prepare(self, params) -> None:
        """Build the program for the engine's device and lay ``params``
        (a torch or numpy tree) and a zeroed pool out on it."""
        self.program = self._build()
        self.params = self._place(params)
        self.cache = self.fresh_cache()
        self.reset_prefix()
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def fresh_cache(self) -> Dict[str, torch.Tensor]:
        return init_kv_cache(self.program.spec, self._device)

    def reset_prefix(self) -> None:
        """(Re)build an empty prefix pool and index for the active
        program (or drop them while the knob is 0)."""
        spec = self.program.spec
        if spec.prefix_pool_pages <= 0:
            self.pool = None
            self.prefix_index = None
            return
        self.pool = init_prefix_pool(spec, self._device)
        self.prefix_index = PrefixIndex(spec.page_size,
                                        spec.prefix_pool_pages)

    # -- promotion (training -> serving) -------------------------------------

    def load_from_snapshot(self, snapshot) -> None:
        """Promote a trainer's ``checkpoint.HostSnapshot`` (its
        ``params/<path>`` leaves), a ``TrainState`` or a parameter tree
        into the serving copy: one host-to-device copy, no storage round
        trip."""
        tree = getattr(snapshot, "tree", None)
        if tree is not None:
            params = _unflatten((name[len("params/"):], t)
                                for name, t in tree.items()
                                if name.startswith("params/"))
        else:
            params = getattr(snapshot, "params", snapshot)
        if self.program is None:
            self.prepare(params)
            return
        self.params = self._place(params)

    def load_from_checkpoint(self, ckpt_dir: str,
                             step: Optional[int] = None) -> Optional[int]:
        """Promote a training checkpoint (``checkpoint.
        ElasticCheckpointManager``'s, written at any world) into the
        serving copy, reading its parameters only. Returns the restored
        step, None when the directory holds no checkpoint."""
        from dlrover_tpu_torch.checkpoint import ElasticCheckpointManager

        mgr = ElasticCheckpointManager(ckpt_dir, staging_dir="")
        try:
            out = mgr.restore_params(step)
        finally:
            mgr.close()
        if out is None:
            return None
        step, flat = out
        params = _unflatten(flat.items())
        if self.program is None:
            self.prepare(params)
        else:
            self.params = self._place(params)
        logger.info("promoted training checkpoint step %d into the "
                    "serving tier", step)
        return step

    # -- elasticity ----------------------------------------------------------

    def _set_knobs(self, serve_slots=None, prefill_chunk=None,
                   prefix_pool_pages=None, spec_draft_len=None) -> None:
        if serve_slots is not None:
            self.serve_slots = max(1, int(serve_slots))
        if prefill_chunk is not None:
            self.prefill_chunk = _fit_prefill_chunk(
                int(prefill_chunk), self._pool_depth)
        if prefix_pool_pages is not None:
            self.prefix_pool_pages = max(0, int(prefix_pool_pages))
        if spec_draft_len is not None:
            # a K-only change lives in the program (the verify step's
            # token shape), not in the pool's spec
            self.spec_draft_len = (max(0, int(spec_draft_len))
                                   if self.spec_enabled else 0)

    def _knobs(self):
        return (self.serve_slots, self.prefill_chunk,
                self.prefix_pool_pages, self.spec_draft_len)

    def _restore_knobs(self, knobs) -> None:
        (self.serve_slots, self.prefill_chunk, self.prefix_pool_pages,
         self.spec_draft_len) = knobs

    def prewarm(self, devices=None, serve_slots: Optional[int] = None,
                prefill_chunk: Optional[int] = None,
                prefix_pool_pages: Optional[int] = None,
                spec_draft_len: Optional[int] = None) -> bool:
        """Build the program for a device or knob set the engine may
        switch to, without switching the active one. When a build
        happened, run one dummy decode step and one dummy prefill chunk
        (and one verify step and one admit/publish page copy with those
        knobs on) on a fresh pool: nothing is compiled in eager
        PyTorch, but the run allocates the new shapes' buffers and
        loads every kernel module the path reaches, so the switch that
        follows builds and loads nothing. Returns whether a build
        happened."""
        device = (self._device if devices is None
                  else _one_device(devices))
        prev = self._knobs()
        self._set_knobs(serve_slots, prefill_chunk, prefix_pool_pages,
                        spec_draft_len)
        try:
            before = self.compile_count
            program = self._build(device)
            built = self.compile_count > before
            if built and self.params is not None:
                self._dummy_steps(program)
                logger.info("prewarmed standby serve program on %s "
                            "(slots=%d)", device, program.spec.num_slots)
        finally:
            self._restore_knobs(prev)
        return built

    def _dummy_steps(self, program: ServeProgram) -> None:
        dev = program.device
        params = (self.params if dev == self._device
                  else tree_map(lambda t: t.to(dev), self.params))
        cache = init_kv_cache(program.spec, dev)
        s = program.spec.num_slots
        tokens = torch.zeros((s,), dtype=torch.int32, device=dev)
        active = torch.zeros((s,), dtype=torch.bool, device=dev)
        with torch.inference_mode():
            program.decode(params, cache, tokens, active)
            chunk = torch.zeros((program.prefill_chunk,), dtype=torch.int32,
                                device=dev)
            program.prefill(params, cache, chunk, 0, 0, 1)
            if program.verify is not None:
                draft = torch.zeros((s, program.spec_k + 1),
                                    dtype=torch.int32, device=dev)
                n_draft = torch.zeros((s,), dtype=torch.int32, device=dev)
                program.verify(params, cache, draft, active, n_draft)
            if program.admit_copy is not None:
                pool = init_prefix_pool(program.spec, dev)
                program.admit_copy(cache, pool, 0, 0, 0)
                program.publish_copy(pool, cache, 0, 0, 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def snapshot(self):
        """A host copy of ``{"params", "cache"[, "prefix"]}``, the
        resize's source: live slots' pages ride it, so leased requests
        continue instead of restarting from their prompts. The prefix
        pool rides it too (the host index names pool page ids, which
        survive the copy)."""
        from dlrover_tpu_torch.checkpoint import HostSnapshot

        tree = {"params": self.params, "cache": self.cache}
        if self.pool is not None:
            tree["prefix"] = self.pool
        return HostSnapshot.take(tree, kind="serving")

    def live_resize(self, devices=None, snapshot=None,
                    reason: str = "") -> int:
        """Drain (the caller's) -> snapshot -> rebuild (the program
        cache: nothing built when prewarmed) -> restore the parameters
        and the live pages onto the new device -> synchronize.
        ``devices``: a list of one device (None: the card); several
        raise. Returns the number of programs built."""
        device = _one_device(devices)
        old_n = 1 if self.program is not None else 0
        t0 = time.monotonic()
        emit_event(EventKind.SERVE_RESIZE_BEGIN, world_from=old_n,
                   reason=reason)
        with span(SpanName.LIVE_RESHARD, world_from=old_n):
            if snapshot is None:
                snapshot = self.snapshot()
            # the old copies go before the restore allocates the new
            self.params = self.cache = self.pool = None
            self._device = device
            builds_before = self.compile_count
            self.program = self._build()
            tree = snapshot.restore_tree(device)
            self.params, self.cache = tree["params"], tree["cache"]
            if "prefix" in tree and self.program.spec.prefix_pool_pages > 0:
                self.pool = tree["prefix"]
            elif self.program.spec.prefix_pool_pages > 0:
                # a snapshot without pool pages cannot carry the index:
                # rebuild it clean
                self.reset_prefix()
            else:
                self.pool = None
                self.prefix_index = None
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        recompiled = self.compile_count - builds_before
        seconds = time.monotonic() - t0
        reg = get_registry()
        reg.counter(
            tm.SERVE_RESIZES,
            help="serving worlds resized live (no dropped requests)").inc()
        reg.histogram(
            tm.SERVE_RESIZE_TIME,
            help="drain -> snapshot -> restore wall seconds (serving)",
        ).observe(seconds)
        emit_event(EventKind.SERVE_RESIZE_DONE, world_from=old_n,
                   world_to=1, reshard_seconds=round(seconds, 3),
                   recompiled=recompiled)
        logger.info("serve resize onto %s in %.2fs (%s)", device, seconds,
                    "program cache hit" if not recompiled else "built")
        return recompiled

    def retune(self, serve_slots: Optional[int] = None,
               prefill_chunk: Optional[int] = None,
               prefix_pool_pages: Optional[int] = None,
               spec_draft_len: Optional[int] = None,
               slot_map: Optional[Dict[int, int]] = None) -> int:
        """Apply serve knobs on the current device through the program
        cache (the caller drains first). A slot-count change repacks the
        live slots on the host through ``slot_map`` (old -> new); a
        change of the chunk or K alone swaps the program and moves no
        state. The parameters stay where they are (the reference sends
        them through the host; the values are the same).

        The prefix pool: a pool-size change rebuilds it empty (page ids
        mean nothing across capacities); a chunk change flushes the
        index (published pages depend on the chunk windows that computed
        them); a slot-only change carries both (the pool has no slot
        dimension). On failure every knob and the active program are
        restored, then the error is raised. Returns the number of
        programs built."""
        prev = self._knobs()
        prev_state = (self.program, self.cache, self.pool, self.prefix_index)
        prev_program = self.program
        old_spec = prev_program.spec if prev_program is not None else None
        try:
            self._set_knobs(serve_slots, prefill_chunk, prefix_pool_pages,
                            spec_draft_len)
            builds_before = self.compile_count
            new_program = self._build()
            chunk_changed = (prev_program is not None
                             and new_program.prefill_chunk
                             != prev_program.prefill_chunk)
            if old_spec is not None and new_program.spec == old_spec:
                # a pure program swap: the pool is already laid out for it
                self.program = new_program
                if chunk_changed and self.prefix_index is not None:
                    self.prefix_index.flush()
                return self.compile_count - builds_before
            self.program = new_program
            if old_spec is not None and self.cache is not None and \
                    old_spec.num_slots != new_program.spec.num_slots:
                host = {k: v.cpu() for k, v in self.cache.items()}
                moved = migrate_slots_host(host, old_spec, new_program.spec,
                                           slot_map or {})
                self.cache = {k: _h2d(v, self._device)
                              for k, v in moved.items()}
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
            if self.prefix_pool_pages != prev[2]:
                self.reset_prefix()
            elif chunk_changed and self.prefix_index is not None:
                self.prefix_index.flush()
            return self.compile_count - builds_before
        except Exception:
            self._restore_knobs(prev)
            # the active program and the state it was laid out for: the
            # failure may come after the program, the slots' pool or the
            # prefix pool was swapped, and a program over a pool of
            # another spec would fail every later call
            (self.program, self.cache, self.pool,
             self.prefix_index) = prev_state
            raise

    # -- shared prefix pool (radix-indexed KV reuse, copy-on-admit) ----------

    def prefix_enabled(self) -> bool:
        return (self.program is not None
                and self.program.spec.prefix_pool_pages > 0
                and self.pool is not None
                and self.prefix_index is not None)

    def _prefix_align(self) -> int:
        """Matched prefixes round down to lcm(page_size, prefill_chunk),
        so the unmatched tail's chunk windows start where a full prefill
        would start them: the reused continuation runs the same chunk
        calls over the same rows, which is what makes it bit for bit."""
        pg = self.program.spec.page_size
        c = self.program.prefill_chunk
        return pg * c // math.gcd(pg, c)

    def prefix_match(self, prompt: List[int]):
        """``(matched_tokens, handle)`` of the longest usable prefix of
        ``prompt``, its pages pinned, or ``(0, None)``. The match stays
        strictly below ``len(prompt)``: a final prefill chunk always
        runs (its last logits give the first token)."""
        if not self.prefix_enabled():
            return 0, None
        align = self._prefix_align()
        pg = self.program.spec.page_size
        cap_tokens = ((len(prompt) - 1) // align) * align
        if cap_tokens <= 0:
            return 0, None
        handle = self.prefix_index.match(
            prompt, max_pages=cap_tokens // pg, align_pages=align // pg)
        if handle is None:
            return 0, None
        return handle.tokens, handle

    def prefix_admit(self, slot: int, handle) -> None:
        """Copy the matched pool pages into the slot's leading rows."""
        pg = self.program.spec.page_size
        for i, page_id in enumerate(handle.pages):
            self.cache = self.program.admit_copy(
                self.cache, self.pool, slot, i * pg, page_id)

    def prefix_publish(self, slot: int, prompt: List[int]):
        """Index and copy the full pages of a completed prefill into the
        pool (pages present are skipped; a full pool skips the rest).
        Returns ``(pages_published, pages_evicted)``."""
        if not self.prefix_enabled():
            return 0, 0
        pg = self.program.spec.page_size
        evict_before = self.prefix_index.evictions
        new_pages = self.prefix_index.publish(prompt)
        for idx, page_id in new_pages:
            self.pool = self.program.publish_copy(
                self.pool, self.cache, slot, idx * pg, page_id)
        return (len(new_pages),
                self.prefix_index.evictions - evict_before)

    def prefix_release(self, handle) -> None:
        """Unpin a hit's pages (idempotent)."""
        if self.prefix_index is not None:
            self.prefix_index.release(handle)
        elif handle is not None:
            handle.released = True

    def prefix_stats(self) -> Dict[str, Any]:
        """Cumulative pool counters and occupancy ({} while off)."""
        if self.prefix_index is None:
            return {}
        out = dict(self.prefix_index.stats())
        out["pool_bytes"] = self.program.spec.prefix_pool_bytes()
        out["used_bytes"] = (out["used_pages"]
                             * self.program.spec.prefix_page_bytes())
        return out


# -- the continuous-batching executor ----------------------------------------

# per-process executor sequence, carried by SERVE_START / SERVE_END
_serve_seq = itertools.count(1)


@dataclass
class ServeRequestState:
    """Host-side bookkeeping for one leased request in a slot."""

    request_id: str
    prompt: List[int]
    max_new_tokens: int
    eos_id: int = -1
    cursor: int = 0            # prompt tokens prefilled so far
    generated: List[int] = field(default_factory=list)
    t_admit: float = 0.0
    t_first_token: Optional[float] = None
    trace_id: str = ""
    # local submissions stamp their enqueue time (queue wait)
    t_submit: Optional[float] = None
    # prompt tokens whose pages came from the prefix pool, and the pin
    # over those pages (admit -> completion)
    prefix_hit_tokens: int = 0
    prefix_handle: Any = None
    # speculative decode: the request's draft proposer and its ledger
    draft_state: Any = None
    spec_drafted_tokens: int = 0
    spec_accepted_tokens: int = 0


@dataclass
class _InflightDecode:
    tokens: torch.Tensor              # device [S] next tokens
    owners: Dict[int, str]            # slot -> request_id at dispatch
    # slots whose FIRST token (the prefill's device argmax) rides this
    # entry: materialization appends it and stamps TTFT
    firsts: Optional[Dict[int, str]] = None


class ServeExecutor:
    """Continuous batching over a fixed slot batch.

    One loop iteration: admission -> at most one prefill chunk per
    admitting slot -> ONE decode step for the whole batch -> lagged
    materialization of the oldest call in the window (``serve_window``).
    ``admission="static"`` admits a full batch together and makes the
    next batch wait for the last request of the current one.

    Each step's token tensor is a new tensor: the window's entries keep
    theirs, and a prefill's first token goes into a copy of the batch's
    tokens (the reference's out-of-place ``.at[slot].set``), so no entry
    is rewritten before it is read.
    """

    def __init__(self, engine: ServeEngine, router_client=None,
                 admission: str = "continuous",
                 serve_window: Optional[int] = None,
                 eos_id: int = -1, max_new_default: int = 16,
                 plan_poll_secs: Optional[float] = None,
                 registry=None, report_hook=None,
                 spec_proposer: Optional[Callable] = None):
        from dlrover_tpu_torch.common.config import get_context

        ctx = get_context()
        self._engine = engine
        self._client = router_client
        self._admission = admission
        self._window_cap = max(0, int(_resolve_knob(
            serve_window, "serve_window", 2)))
        self._eos_default = int(eos_id)
        self._max_new_default = int(max_new_default)
        self._plan_poll = float(
            plan_poll_secs if plan_poll_secs is not None
            else getattr(ctx, "plan_poll_secs", 30.0))
        self._last_plan_poll = 0.0
        self._seen_plan = ""
        self._last_touch = 0.0
        self._local_queue: "collections.deque" = collections.deque()
        self._window: "collections.deque[_InflightDecode]" = (
            collections.deque())
        self._slots: List[Optional[ServeRequestState]] = []
        self._active_host: List[bool] = []
        self._tokens: Optional[torch.Tensor] = None
        self._active: Optional[torch.Tensor] = None
        self._resize_devices = None
        self._resize_requested = False
        self._resize_trace_id = ""
        self._retune_request: Optional[Dict[str, Any]] = None
        self.completed: List[Dict[str, Any]] = []
        self.decode_steps = 0
        self._local_id_seq = 0
        # a factory of one draft proposer per request (tests force
        # acceptance patterns through it; default: the n-gram proposer)
        self._spec_proposer_factory = spec_proposer
        self._spec_drafted_total = 0
        self._spec_accepted_total = 0
        self._serve_seq = next(_serve_seq)
        # slot-time ledger: every slot-second of the loop charged to one
        # class, so the classes sum to slots x wall
        self._ledger: Dict[str, float] = {
            k: 0.0 for k in ("decode", "prefill", "admitted_idle",
                             "vacant", "resize_frozen")}
        self._ledger_mark: Optional[float] = None
        self._slot_seconds = 0.0
        self._serve_wall = 0.0
        self._ledger_enabled = bool(
            getattr(ctx, "telemetry_enabled", True))
        reg = registry if registry is not None else get_registry()
        self._c_tokens = reg.counter(
            tm.SERVE_TOKENS, help="tokens generated by this worker")
        self._c_decode = reg.counter(
            tm.SERVE_DECODE_STEPS, help="batched decode steps dispatched")
        self._c_prefill = reg.counter(
            tm.SERVE_PREFILL_CHUNKS, help="prefill chunks dispatched")
        self._c_admitted = reg.counter(
            tm.SERVE_ADMISSIONS, help="requests admitted into slots")
        self._g_occupancy = reg.gauge(
            tm.SERVE_SLOT_OCCUPANCY,
            help="slots holding a live request, after admission")
        self._h_step = reg.histogram(
            tm.SERVE_STEP_TIME, buckets=LATENCY_BUCKETS,
            help="per-decode-step wall seconds")
        self._h_prefill_e2e = reg.histogram(
            tm.SERVE_PREFILL_TIME, buckets=LATENCY_BUCKETS,
            help="admit -> first token host-visible wall seconds")
        self._c_phits = reg.counter(
            tm.SERVE_PREFIX_HITS,
            help="admissions whose leading pages came from the pool")
        self._c_pmisses = reg.counter(
            tm.SERVE_PREFIX_MISSES,
            help="admissions that walked the index and found nothing")
        self._c_pevict = reg.counter(
            tm.SERVE_PREFIX_EVICTIONS,
            help="pool pages evicted to make room for a publish")
        self._c_psaved = reg.counter(
            tm.SERVE_PREFIX_SAVED_TOKENS,
            help="prefill tokens skipped via copy-on-admit")
        self._g_pool_used = reg.gauge(
            tm.SERVE_PREFIX_POOL_USED_PAGES,
            help="prefix-pool pages currently indexed")
        self._g_pool_bytes = reg.gauge(
            tm.SERVE_PREFIX_POOL_BYTES,
            help="prefix-pool bytes in use on the device")
        self._c_spec_steps = reg.counter(
            tm.SERVE_SPEC_VERIFY_STEPS,
            help="batched multi-token verify steps dispatched")
        self._c_spec_drafted = reg.counter(
            tm.SERVE_SPEC_DRAFTED,
            help="draft tokens proposed into verify steps")
        self._c_spec_accepted = reg.counter(
            tm.SERVE_SPEC_ACCEPTED,
            help="draft tokens accepted (matched the greedy argmax)")
        self._c_spec_wasted = reg.counter(
            tm.SERVE_SPEC_WASTED,
            help="draft tokens rejected by verify (computed, unused)")
        self._g_spec_rate = reg.gauge(
            tm.SERVE_SPEC_ACCEPT_RATE,
            help="accepted/drafted over this worker's lifetime "
                 "(-1 until the first draft)")
        self._g_spec_rate.set(-1.0)
        # node runtime reports ride the client when it carries them
        # (pass a hook to set the cadence)
        if report_hook is None and router_client is not None and \
                hasattr(router_client, "report_node_runtime"):
            from dlrover_tpu_torch.serving.slo import ServeRuntimeReportHook

            report_hook = ServeRuntimeReportHook(router_client, registry=reg)
        self._report_hook = report_hook or None

    # -- local submission (router-less mode) ---------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 0,
               request_id: str = "", eos_id: Optional[int] = None) -> str:
        """Enqueue a request on the worker-local queue."""
        # a monotonic sequence: ids derived from queue lengths could
        # collide and break the window's owner guard
        self._local_id_seq += 1
        rid = request_id or f"local-{self._local_id_seq}"
        self._local_queue.append({
            "request_id": rid,
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens or self._max_new_default),
            "eos_id": (self._eos_default if eos_id is None
                       else int(eos_id)),
            "trace_id": "req-" + new_trace_id()[len("inc-"):],
            "submit_ts": time.monotonic(),
        })
        return rid

    # -- elasticity hooks ----------------------------------------------------

    def request_resize(self, devices=None, trace_id: str = ""):
        """Resize at the next boundary. ``trace_id`` threads the incident
        that asked for it onto the SERVE_RESIZE_* events."""
        self._resize_devices = (list(devices)
                                if devices is not None else None)
        self._resize_trace_id = str(trace_id or "")
        self._resize_requested = True

    def request_retune(self, serve_slots: Optional[int] = None,
                       prefill_chunk: Optional[int] = None,
                       prefix_pool_pages: Optional[int] = None,
                       spec_draft_len: Optional[int] = None,
                       plan_id: str = "", prewarm: bool = False):
        """Retune at the next boundary (acked under ``plan_id``)."""
        self._retune_request = {
            "serve_slots": serve_slots,
            "prefill_chunk": prefill_chunk,
            "prefix_pool_pages": prefix_pool_pages,
            "spec_draft_len": spec_draft_len,
            "plan_id": plan_id,
            "prewarm": bool(prewarm),
        }

    # -- loop ----------------------------------------------------------------

    def _ensure_prepared(self):
        if self._engine.program is None:
            raise RuntimeError("engine.prepare(params) first")
        s = self._engine.program.spec.num_slots
        if len(self._slots) != s:
            if any(r is not None for r in self._slots):
                # a direct engine.retune between serve() calls: the
                # supported path is request_retune, which repacks them
                raise RuntimeError(
                    "engine slot width changed with live requests; use "
                    "ServeExecutor.request_retune")
            self._slots = [None] * s
            self._active_host = [False] * s
        if self._tokens is None or int(self._tokens.shape[0]) != s:
            dev = self._engine.device
            self._tokens = torch.zeros((s,), dtype=torch.int32, device=dev)
            self._active = _h2d(self._active_host, dev)

    def _apply_resize(self):
        self._resize_requested = False
        devices, self._resize_devices = self._resize_devices, None
        trace_id, self._resize_trace_id = self._resize_trace_id, ""
        tokens_host = self._tokens.cpu()
        active_host = list(self._active_host)
        if trace_id:
            # the SERVE_RESIZE_* events join the incident that asked
            with trace_scope(trace_id):
                self._engine.live_resize(devices, reason="executor")
        else:
            self._engine.live_resize(devices, reason="executor")
        dev = self._engine.device
        self._tokens = _h2d(tokens_host, dev)
        self._active_host = active_host
        self._active = _h2d(active_host, dev)

    def _apply_retune(self):
        req, self._retune_request = self._retune_request, None
        new_slots = req.get("serve_slots")
        new_chunk = req.get("prefill_chunk")
        new_ppp = req.get("prefix_pool_pages")
        new_spec_k = req.get("spec_draft_len")
        plan_id = req.get("plan_id", "")
        if new_chunk is not None:
            fitted = _fit_prefill_chunk(int(new_chunk),
                                        self._engine._pool_depth)
            if fitted != int(new_chunk):
                # the plan's chunk does not divide the pool depth:
                # applying the fitted chunk while acking the plan would
                # have the master choose it again every window
                logger.warning(
                    "serve plan %s wants prefill_chunk=%s but the pool "
                    "depth %d fits %d; negative-acking", plan_id,
                    new_chunk, self._engine._pool_depth, fitted)
                self._ack_plan(plan_id, apply_failed=True)
                return
            if int(new_chunk) != self._engine.prefill_chunk:
                # prompts mid-prefill started their chunks at multiples
                # of the old chunk: they restart from 0 (prefill rewrites
                # its rows)
                for slot, state in enumerate(self._slots):
                    if (state is not None and not self._active_host[slot]
                            and state.cursor > 0):
                        state.cursor = 0
        live = [i for i, r in enumerate(self._slots) if r is not None]
        cur_slots = self._engine.program.spec.num_slots
        # the bookkeeping moves only when the width does, as the pages do
        slots_changing = (new_slots is not None
                          and int(new_slots) != cur_slots)
        if slots_changing and len(live) > int(new_slots):
            logger.warning("serve retune to %s slots declined: %d live "
                           "requests", new_slots, len(live))
            self._ack_plan(plan_id, apply_failed=True)
            return
        slot_map = ({old: new for new, old in enumerate(live)}
                    if slots_changing else {i: i for i in live})
        tokens_host = (self._tokens.cpu() if self._tokens is not None
                       else None)  # None: no serve() yet, no live slot
        if req.get("prewarm"):
            # build the candidate before the swap, so the drained pause
            # builds nothing
            try:
                self._engine.prewarm(serve_slots=new_slots,
                                     prefill_chunk=new_chunk,
                                     prefix_pool_pages=new_ppp,
                                     spec_draft_len=new_spec_k)
            except Exception:  # noqa: BLE001 — prewarm is an
                # optimization; the retune decides the outcome
                logger.warning("serve prewarm failed", exc_info=True)
        try:
            self._engine.retune(
                serve_slots=new_slots, prefill_chunk=new_chunk,
                prefix_pool_pages=new_ppp, spec_draft_len=new_spec_k,
                slot_map=slot_map)
        except Exception:  # noqa: BLE001 — a bad plan must not kill
            # serving; the engine restored its knobs and program
            logger.exception("serve retune failed; continuing with the "
                             "previous config")
            self._ack_plan(plan_id, apply_failed=True)
            return
        if slots_changing:
            s = self._engine.program.spec.num_slots
            slots: List[Optional[ServeRequestState]] = [None] * s
            active = [False] * s
            tokens = torch.zeros((s,), dtype=torch.int32)
            for old, new in slot_map.items():
                slots[new] = self._slots[old]
                active[new] = self._active_host[old]
                tokens[new] = tokens_host[old]
            self._slots, self._active_host = slots, active
            dev = self._engine.device
            self._tokens = _h2d(tokens, dev)
            self._active = _h2d(active, dev)
        self._ack_plan(plan_id)

    def _ack_plan(self, plan_id: str, apply_failed: bool = False):
        if not plan_id or self._client is None or not hasattr(
                self._client, "report_serve_config"):
            return
        self._report_config(plan_id=plan_id, apply_failed=apply_failed)

    def _report_config(self, plan_id: str = "",
                       apply_failed: bool = False):
        """The config this worker runs, for the master's optimizer (a
        non-empty ``plan_id`` acks that plan)."""
        if self._client is None or not hasattr(self._client,
                                               "report_serve_config"):
            return
        program = self._engine.program
        stats = self._engine.prefix_stats()
        looked = stats.get("hits", 0) + stats.get("misses", 0)
        # -1 = no observation yet (the optimizer then uses its prior)
        hit_rate = stats["hits"] / looked if stats and looked else -1.0
        try:
            self._client.report_serve_config(
                world=1,
                serve_slots=int(program.spec.num_slots),
                prefill_chunk=int(program.prefill_chunk),
                kv_precision=str(program.spec.precision),
                max_seq=int(program.spec.max_seq),
                num_layers=int(program.spec.num_layers),
                kv_heads=int(program.spec.num_kv_heads),
                head_dim=int(program.spec.head_dim),
                prefix_pool_pages=int(program.spec.prefix_pool_pages),
                page_size=int(program.spec.page_size),
                prefix_hit_rate=float(hit_rate),
                spec_draft_len=int(program.spec_k),
                # -1 = no draft observed yet: K > 0 is priced only from
                # evidence
                spec_accept_rate=float(
                    self._spec_accepted_total / self._spec_drafted_total
                    if self._spec_drafted_total else -1.0),
                plan_id=plan_id, apply_failed=bool(apply_failed),
            )
        except Exception:  # noqa: BLE001 — a dead master must not
            # block serving
            logger.debug("serve config report failed", exc_info=True)

    def _poll_plan(self):
        """Take a new serve plan from the master (at most every
        ``plan_poll_secs``) as a retune request."""
        if self._client is None or self._plan_poll <= 0 or not hasattr(
                self._client, "get_parallel_config"):
            return
        now = time.monotonic()
        if now - self._last_plan_poll < self._plan_poll:
            return
        self._last_plan_poll = now
        try:
            cfg = self._client.get_parallel_config()
        except Exception:  # noqa: BLE001 — master briefly away: the
            # next poll retries
            logger.debug("serve plan poll failed", exc_info=True)
            return
        plan_id = getattr(cfg, "plan_id", "") or ""
        slots = int(getattr(cfg, "serve_slots", 0) or 0)
        chunk = int(getattr(cfg, "serve_prefill_chunk", 0) or 0)
        # the pool and draft-length knobs leave a value unchanged at -1
        # (0 is a real value: off), their siblings at 0
        ppp = int(getattr(cfg, "serve_prefix_pool_pages", -1))
        sk = int(getattr(cfg, "serve_spec_draft_len", -1))
        if not plan_id or plan_id == self._seen_plan \
                or not (slots or chunk or ppp >= 0 or sk >= 0):
            return
        self._seen_plan = plan_id
        self.request_retune(serve_slots=slots or None,
                            prefill_chunk=chunk or None,
                            prefix_pool_pages=ppp if ppp >= 0 else None,
                            spec_draft_len=sk if sk >= 0 else None,
                            plan_id=plan_id,
                            prewarm=bool(getattr(cfg, "prewarm", True)))

    def _set_active(self, slot: int, value: bool) -> None:
        self._active_host[slot] = value
        self._active = _h2d(self._active_host, self._engine.device)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slots) if r is None]

    def _lease(self, n: int) -> List[Dict[str, Any]]:
        out = []
        while n > 0 and self._local_queue:
            out.append(self._local_queue.popleft())
            n -= 1
        if n > 0 and self._client is not None:
            try:
                out.extend(self._client.serve_lease(max_requests=n))
            except Exception:  # noqa: BLE001 — a dead master must not
                # kill serving; the worker drains its admitted slots
                logger.debug("serve lease failed", exc_info=True)
        return out

    def _admit(self):
        free = self._free_slots()
        if not free:
            return
        if self._admission == "static" and len(free) != len(self._slots):
            return  # static batching: wait for the whole batch
        leases = self._lease(len(free))
        max_seq = self._engine.program.spec.max_seq
        for req in leases:
            slot = free.pop(0)
            state = ServeRequestState(
                request_id=str(req["request_id"]),
                prompt=[int(t) for t in req["prompt"]],
                max_new_tokens=int(req.get("max_new_tokens")
                                   or self._max_new_default),
                eos_id=int(req.get("eos_id", self._eos_default)),
                trace_id=str(req.get("trace_id", "") or ""),
                t_submit=req.get("submit_ts"),
                t_admit=time.monotonic(),
            )
            if len(state.prompt) + state.max_new_tokens > max_seq:
                # the pool cannot hold this request: complete it as
                # errored, with an error-coded event
                emit_event(
                    EventKind.SERVE_REQUEST_EVICTED,
                    error_code="SERVE_REQUEST_EVICTED",
                    trace_id=state.trace_id,
                    request_id=state.request_id,
                    prompt_tokens=len(state.prompt),
                    max_seq=max_seq,
                )
                self._complete(state, error_code="SERVE_REQUEST_EVICTED")
                continue
            matched, handle = self._engine.prefix_match(state.prompt)
            if handle is not None:
                # copy-on-admit: the prefill below starts at the
                # unmatched tail, on the chunk windows a full prefill
                # would run from that cursor
                self._engine.prefix_admit(slot, handle)
                state.cursor = matched
                state.prefix_hit_tokens = matched
                state.prefix_handle = handle
                self._c_phits.inc()
                self._c_psaved.inc(matched)
                emit_event(
                    EventKind.SERVE_PREFIX_HIT,
                    trace_id=state.trace_id,
                    request_id=state.request_id, slot=slot,
                    hit_tokens=matched, prompt_tokens=len(state.prompt),
                )
            elif self._engine.prefix_enabled():
                self._c_pmisses.inc()
            self._slots[slot] = state
            self._c_admitted.inc()
            if not free:
                break
        self._g_occupancy.set(sum(1 for r in self._slots if r is not None))
        if self._engine.prefix_enabled():
            stats = self._engine.prefix_stats()
            self._g_pool_used.set(stats.get("used_pages", 0))
            self._g_pool_bytes.set(stats.get("used_bytes", 0))

    def _prefill_tick(self):
        """At most ONE chunk per admitting slot, so prefill interleaves
        with the decode stream instead of stalling it."""
        program = self._engine.program
        c = program.prefill_chunk
        firsts: Dict[int, str] = {}
        for slot, state in enumerate(self._slots):
            if state is None or state.cursor >= len(state.prompt) \
                    or self._active_host[slot]:
                continue
            chunk = state.prompt[state.cursor:state.cursor + c]
            n_valid = len(chunk)
            padded = np.zeros((c,), np.int32)
            padded[:n_valid] = chunk
            with span(SpanName.SERVE_PREFILL, slot=slot):
                self._engine.cache, _last_logits, first_tok = (
                    program.prefill(
                        self._engine.params, self._engine.cache,
                        _h2d(padded, program.device), slot, state.cursor,
                        n_valid))
            self._c_prefill.inc()
            state.cursor += n_valid
            emit_event(
                EventKind.SERVE_PREFILL_CHUNK,
                trace_id=state.trace_id, request_id=state.request_id,
                slot=slot, cursor=state.cursor,
                prompt_tokens=len(state.prompt),
            )
            if state.cursor >= len(state.prompt):
                # publish the prompt's full pages before decode appends
                # rows past them
                published, evicted = self._engine.prefix_publish(
                    slot, state.prompt)
                if evicted:
                    self._c_pevict.inc(evicted)
                    emit_event(
                        EventKind.SERVE_PREFIX_EVICTED,
                        trace_id=state.trace_id,
                        request_id=state.request_id, pages=evicted,
                    )
                # the first token stays on the device, in a new copy of
                # the batch's tokens (the window's entries keep theirs);
                # TTFT and finish detection happen at materialization
                tokens = self._tokens.clone()
                tokens[slot] = first_tok
                self._tokens = tokens
                firsts[slot] = state.request_id
                self._set_active(slot, True)
        if firsts:
            self._window.append(_InflightDecode(
                tokens=self._tokens, owners={}, firsts=firsts))

    def _finished(self, state: ServeRequestState) -> bool:
        if len(state.generated) >= state.max_new_tokens:
            return True
        return bool(state.eos_id >= 0 and state.generated
                    and state.generated[-1] == state.eos_id)

    def _complete(self, state: ServeRequestState, error_code: str = ""):
        now = time.monotonic()
        if state.prefix_handle is not None:
            self._engine.prefix_release(state.prefix_handle)
            state.prefix_handle = None
        record = {
            "request_id": state.request_id,
            "tokens": list(state.generated),
            "ttft_s": (round(state.t_first_token - state.t_admit, 6)
                       if state.t_first_token else None),
            "e2e_s": round(now - state.t_admit, 6),
            "error_code": error_code,
            "prefix_hit_tokens": int(state.prefix_hit_tokens),
            "spec_drafted_tokens": int(state.spec_drafted_tokens),
            "spec_accepted_tokens": int(state.spec_accepted_tokens),
        }
        emit_event(
            EventKind.SERVE_REQUEST_DONE,
            trace_id=state.trace_id, request_id=state.request_id,
            tokens=len(state.generated), ttft_s=record["ttft_s"],
            e2e_s=record["e2e_s"], done_error_code=error_code or None,
        )
        if state.t_submit is not None:
            record["queue_wait_s"] = round(state.t_admit - state.t_submit, 6)
        self.completed.append(record)
        self._c_tokens.inc(len(state.generated))
        if self._client is not None:
            wire = {k: v for k, v in record.items() if k != "queue_wait_s"}
            try:
                if state.trace_id:
                    with trace_scope(state.trace_id):
                        self._client.serve_complete(**wire)
                else:
                    self._client.serve_complete(**wire)
            except Exception:  # noqa: BLE001 — the router re-leases on
                # lease timeout; a lost completion is served again
                logger.warning("serve completion report failed",
                               exc_info=True)

    def _retire(self, slot: int):
        state = self._slots[slot]
        self._slots[slot] = None
        self._set_active(slot, False)
        self._complete(state)

    # -- slot-time ledger ----------------------------------------------------

    def _classify(self) -> List[str]:
        """Per-slot ledger class under the current host state."""
        out = []
        for i, state in enumerate(self._slots):
            if state is None:
                out.append("vacant")
            elif self._active_host[i]:
                out.append("decode")
            elif state.cursor < len(state.prompt):
                out.append("prefill")
            else:
                # prefilled, not yet decoding (the window's lag)
                out.append("admitted_idle")
        return out

    def _charge_slots(self, now: float, override: Optional[str] = None,
                      classes: Optional[List[str]] = None):
        """Charge the wall time since the previous mark: ``dt`` a slot,
        each slot to one class (``override``: every slot to that class,
        the resize or retune freeze; ``classes``: a classification
        captured before the interval, for the prefill interval)."""
        if not self._ledger_enabled:
            return
        mark = self._ledger_mark
        self._ledger_mark = now
        if mark is None:
            return
        dt = now - mark
        if dt <= 0 or not self._slots:
            return
        self._slot_seconds += dt * len(self._slots)
        if override is not None:
            self._ledger[override] += dt * len(self._slots)
            return
        if classes is None or len(classes) != len(self._slots):
            classes = self._classify()
        for cls in classes:
            self._ledger[cls] += dt

    def slot_ledger(self) -> Dict[str, float]:
        """The slot-seconds partition, its total (the classes' sum) and
        the serve-loop wall it partitions."""
        out = {k: round(v, 6) for k, v in self._ledger.items()}
        out["slot_seconds"] = round(self._slot_seconds, 6)
        out["serve_wall_s"] = round(self._serve_wall, 6)
        return out

    def _materialize_oldest(self):
        entry = self._window.popleft()
        host = entry.tokens.cpu().tolist()
        for slot, rid in (entry.firsts or {}).items():
            state = self._slots[slot]
            if state is None or state.request_id != rid:
                continue
            state.generated.append(host[slot])
            # TTFT: the first token host-visible
            state.t_first_token = time.monotonic()
            self._h_prefill_e2e.observe(state.t_first_token - state.t_admit)
            emit_event(
                EventKind.SERVE_FIRST_TOKEN,
                trace_id=state.trace_id, request_id=state.request_id,
                slot=slot,
                ttft_s=round(state.t_first_token - state.t_admit, 6),
            )
            if self._finished(state):
                # later entries' tokens for this slot fail the owner
                # guard once retired
                self._retire(slot)
        for slot, rid in entry.owners.items():
            state = self._slots[slot]
            if state is None or state.request_id != rid:
                continue  # completed or reassigned meanwhile
            state.generated.append(host[slot])
            if state.t_first_token is None:
                state.t_first_token = time.monotonic()
            if self._finished(state):
                self._retire(slot)

    def _drain_window(self):
        while self._window:
            self._materialize_oldest()

    # -- speculative decode (n-gram draft + batched verify) ------------------

    def _spec_step(self):
        """ONE verify step for the whole batch: up to K drafts a slot
        from its own history, then the accepted prefix committed. Its
        one host read is spread over up to K+1 tokens a slot. The caller
        drained the window, so the host history is current."""
        program = self._engine.program
        k = program.spec_k
        s = program.spec.num_slots
        tokens_h = np.zeros((s, k + 1), np.int32)
        n_draft_h = np.zeros((s,), np.int32)
        owners: Dict[int, str] = {}
        for slot, state in enumerate(self._slots):
            if state is None or not self._active_host[slot]:
                continue
            owners[slot] = state.request_id
            tokens_h[slot, 0] = state.generated[-1]
            # a verify step emits up to n+1 tokens: the draft never runs
            # the request past max_new_tokens
            budget = min(k, state.max_new_tokens - len(state.generated) - 1)
            if budget <= 0:
                continue
            if state.draft_state is None:
                factory = self._spec_proposer_factory
                state.draft_state = (factory() if factory is not None
                                     else NgramProposer())
            draft = state.draft_state.propose(
                state.prompt + state.generated, budget)[:budget]
            if draft:
                tokens_h[slot, 1:1 + len(draft)] = draft
                n_draft_h[slot] = len(draft)
        dev = program.device
        try:
            with span(SpanName.SERVE_DECODE, step=self.decode_steps):
                greedy_d, accepted_d, next_d, self._engine.cache = (
                    program.verify(
                        self._engine.params, self._engine.cache,
                        _h2d(tokens_h, dev), self._active,
                        _h2d(n_draft_h, dev)))
        except Exception:  # noqa: BLE001 — a failed verify step must not
            # kill serving or charge the ledger: ``length`` is its last
            # write, so nothing was committed; the batch takes one plain
            # decode step instead (the same stream, minus the speculation)
            logger.warning("verify step failed; falling back to a plain "
                           "decode step", exc_info=True)
            next_tokens, _lg, self._engine.cache = program.decode(
                self._engine.params, self._engine.cache, self._tokens,
                self._active)
            self._tokens = next_tokens
            host = next_tokens.cpu().tolist()
            for slot, rid in owners.items():
                state = self._slots[slot]
                if state is None or state.request_id != rid:
                    continue
                state.generated.append(host[slot])
                if self._finished(state):
                    self._retire(slot)
            return
        self._tokens = next_d
        greedy_h = greedy_d.cpu().tolist()
        accepted_h = accepted_d.cpu().tolist()
        self._c_spec_steps.inc()
        for slot, rid in owners.items():
            state = self._slots[slot]
            if state is None or state.request_id != rid:
                continue
            drafted = int(n_draft_h[slot])
            accepted = min(accepted_h[slot], drafted)
            state.spec_drafted_tokens += drafted
            state.spec_accepted_tokens += accepted
            self._spec_drafted_total += drafted
            self._spec_accepted_total += accepted
            if drafted:
                self._c_spec_drafted.inc(drafted)
                self._c_spec_accepted.inc(accepted)
                self._c_spec_wasted.inc(drafted - accepted)
            # commit greedy[0..accepted], stopping at eos / max_new where
            # the serial stream would stop
            for i in range(accepted + 1):
                state.generated.append(greedy_h[slot][i])
                if self._finished(state):
                    self._retire(slot)
                    break
        if self._spec_drafted_total:
            self._g_spec_rate.set(self._spec_accepted_total
                                  / self._spec_drafted_total)

    def _touch(self):
        if self._client is None or not hasattr(self._client, "serve_touch"):
            return
        now = time.monotonic()
        if now - self._last_touch < 5.0:
            return
        self._last_touch = now
        try:
            self._client.serve_touch()
        except Exception:  # noqa: BLE001 — liveness is best-effort
            logger.debug("serve touch failed", exc_info=True)

    def serve(self, max_steps: int = 0, until_idle: bool = True):
        """Run the loop (admit -> prefill tick -> decode -> lagged
        materialization) until the queue and the slots drain, or for
        ``max_steps`` decode steps. Returns the completion records so
        far."""
        self._ensure_prepared()
        self._report_config()
        program = self._engine.program
        emit_event(EventKind.SERVE_START, slots=program.spec.num_slots,
                   prefill_chunk=program.prefill_chunk,
                   kv_precision=program.spec.precision,
                   spec_draft_len=program.spec_k,
                   serve_seq=self._serve_seq)
        steps = 0
        idle_polls = 0
        loop_start = time.monotonic()
        self._ledger_mark = loop_start
        while True:
            # the interval since the last mark, under the slot states the
            # previous iteration left
            self._charge_slots(time.monotonic())
            if self._resize_requested or self._retune_request is not None:
                self._drain_window()
                if self._resize_requested:
                    self._apply_resize()
                    self._report_config()
                if self._retune_request is not None:
                    self._apply_retune()
                # the drain and the change froze every slot
                self._charge_slots(time.monotonic(),
                                   override="resize_frozen")
            self._poll_plan()
            self._admit()
            # the admission + prefill interval, under the states that
            # held during it (a final chunk flips its slot to decoding)
            pre_classes = (self._classify() if self._ledger_enabled
                           else None)
            self._prefill_tick()
            self._charge_slots(time.monotonic(), classes=pre_classes)
            self._touch()
            if not any(self._active_host):
                self._drain_window()
                if any(r is not None for r in self._slots):
                    continue  # admitted slots still prefilling
                if self._local_queue:
                    continue
                leased = self._lease(1)
                if leased:
                    self._local_queue.extend(leased)
                    continue
                idle_polls += 1
                if until_idle or (max_steps and steps >= max_steps) \
                        or idle_polls > 2:
                    break
                time.sleep(0.01)
                continue
            idle_polls = 0
            t0 = time.monotonic()
            program = self._engine.program  # a boundary may swap it
            if program.verify is not None:
                # spec mode is serial: the proposer needs the current
                # host history, so the window (firsts only) drains first
                self._drain_window()
                if not any(self._active_host):
                    continue  # the drain retired the last active slot
                self._spec_step()
            else:
                owners = {i: r.request_id for i, r in enumerate(self._slots)
                          if r is not None and self._active_host[i]}
                with span(SpanName.SERVE_DECODE, step=self.decode_steps):
                    next_tokens, _logits, self._engine.cache = (
                        program.decode(self._engine.params,
                                       self._engine.cache, self._tokens,
                                       self._active))
                self._tokens = next_tokens
                self._window.append(
                    _InflightDecode(tokens=next_tokens, owners=owners))
                while len(self._window) > self._window_cap:
                    self._materialize_oldest()
            self._c_decode.inc()
            self.decode_steps += 1
            steps += 1
            self._h_step.observe(time.monotonic() - t0)
            if self._report_hook is not None:
                try:
                    self._report_hook.after_step(
                        self.decode_steps,
                        queue_len=len(self._local_queue),
                        slots=len(self._slots))
                except Exception:  # noqa: BLE001 — reporting must never
                    # take the decode loop down
                    logger.debug("serve runtime report hook failed",
                                 exc_info=True)
            if max_steps and steps >= max_steps:
                self._drain_window()
                break
        self._drain_window()
        now = time.monotonic()
        self._charge_slots(now)
        self._serve_wall += now - loop_start
        emit_event(EventKind.SERVE_END, decode_steps=self.decode_steps,
                   completed=len(self.completed), slots=len(self._slots),
                   serve_seq=self._serve_seq,
                   slot_ledger={k: round(v, 6)
                                for k, v in self._ledger.items()},
                   slot_seconds=round(self._slot_seconds, 6),
                   serve_wall_s=round(self._serve_wall, 6),
                   prefix=self._engine.prefix_stats() or None,
                   spec=({"drafted": self._spec_drafted_total,
                          "accepted": self._spec_accepted_total,
                          "wasted": (self._spec_drafted_total
                                     - self._spec_accepted_total)}
                         if self._spec_drafted_total else None))
        if self._report_hook is not None:
            try:
                self._report_hook.flush(queue_len=len(self._local_queue),
                                        slots=len(self._slots))
            except Exception:  # noqa: BLE001 — a best-effort last push
                logger.debug("serve runtime report flush failed",
                             exc_info=True)
        return list(self.completed)
