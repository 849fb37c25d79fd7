"""ElasticTrainer: owns the (strategy, train step, state) triple (port of
``dlrover_tpu/trainer/elastic.py``).

Ported: construction, ``prepare`` (a restore from ``ckpt_dir`` when it
holds a checkpoint, else a fresh init), ``step`` and ``step_multi`` (K
optimizer steps in one call) with their save cadence,
``restore_state``, ``snapshot``, ``save``, ``latest_checkpoint_step``
and ``finalize``, on one device or over the ranks of
``torch.distributed`` (the world ``trainer.bootstrap.init_worker``
joined). The MoE's ``dispatch_chunks`` and ``moe_precision`` and the
dense FSDP wire's ``fsdp_precision`` are pinned on the Context before
the step is built, as the reference pins them before it traces; a wire
precision the device's fp8 probe fails runs, and is reported, as
"bf16" (``_effective_precision``). ``grad_precision`` is fixed at
construction: its error-feedback residual is part of the state. The rng stream (the ``torch.Generator`` handed to the
loss each step) rides in each checkpoint's metadata, so a resumed run
draws what the uninterrupted one would have.

In-process recovery (ROADMAP A8b): built steps are kept under a key of
(device, process group, strategy, ``steps_per_call``,
``dispatch_chunks``, ``moe_precision``, ``fsdp_precision``,
``grad_precision``), at most four, so a return to a
knob set already built builds nothing. A build here is ``accelerate``
(the step's closures over the mesh) and the first launch of each kernel
module; ``ops.kernel_build`` keeps the modules per process, so no
rebuild of a step builds or loads a kernel again. A key holds the
process group, and a step built over a group that is gone is dropped.
``live_reshard`` absorbs a change of world in the process: snapshot,
rebuild, restore into a new ``TrainState``, resume. The port's
"devices" are the ranks of the group, one device each: a planned change
names the ranks that stay, the snapshot takes each survivor's slice of
the next world's sharded leaves over the old group
(``checkpoint.regroup``), and ``bootstrap.reform_world`` re-forms the
group. The sharded leaves are the step's ``AccelerateResult.layout``
(fsdp blocks and ``moe_ep``'s experts, by the rule tables), and a new
``(data x fsdp)`` factorization regroups them the same way. ``retune``
is the same on an unchanged world with new knobs,
``prewarm`` builds a step into the cache without switching to it, and
``on_world_change`` is ``live_reshard`` without its timeline events. An
unplanned loss (a rank dead) restores from storage (``prepare``); peer
restore needs the RPC layer and the master's plan (ROADMAP A12).

``attribution()`` (ROADMAP A11) is the active step's cost record
(``telemetry.attribution``: FLOPs and bytes counted on the meta device),
captured once per built step, kept under the same key as the step and
dropped with it.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.checkpoint import (
    CheckpointInterval,
    ElasticCheckpointManager,
    HostSnapshot,
)
from dlrover_tpu_torch.checkpoint.manager import state_tensors
from dlrover_tpu_torch.checkpoint.regroup import Regroup
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.parallel.accelerate import (
    AccelerateResult,
    OptimizerFn,
    TrainState,
    accelerate,
    resolve_grad_precision,
)
from dlrover_tpu_torch.ops.shard_compat import fp8_wire_supported
from dlrover_tpu_torch.parallel.mesh import (
    MeshPlan,
    mesh_axes_key,
    topology_key,
)
from dlrover_tpu_torch.parallel.sharding_rules import ShardLayout, step_sizes
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.telemetry import (
    EventKind,
    SpanName,
    emit_event,
    get_registry,
    names as tm,
    span,
)
from dlrover_tpu_torch.trainer import bootstrap
from dlrover_tpu_torch.trainer.data import stack_batches

logger = get_logger("trainer.elastic")


class ElasticTrainer:
    """Usage::

        trainer = ElasticTrainer(init_fn, loss_fn, optimizer, example_batch,
                                 strategy, ckpt_dir="/ckpt")
        state = trainer.prepare()          # restores if a checkpoint exists
        for batch in loader:
            state, metrics = trainer.step(state, batch)
    """

    def __init__(
        self,
        init_fn: Callable,
        loss_fn: Callable,
        optimizer: OptimizerFn,
        example_batch: Any,
        strategy: Optional[Strategy] = None,
        ckpt_dir: str = "",
        ckpt_interval: Optional[CheckpointInterval] = None,
        device: DeviceLike = None,
        steps_per_call: Optional[int] = None,
        grad_precision: Optional[str] = None,
        dispatch_chunks: Optional[int] = None,
        moe_precision: Optional[str] = None,
        fsdp_precision: Optional[str] = None,
    ):
        self._init_fn = init_fn
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._example_batch = example_batch
        self._base_strategy = strategy or Strategy()
        self._device = resolve_device(device)
        ctx = get_context()
        # optimizer steps per call (K > 1: step_multi); a knob of the
        # built step, like the two below, which retune swaps live
        if steps_per_call is None:
            steps_per_call = ctx.steps_per_call
        self.steps_per_call = max(1, int(steps_per_call))
        # the gradient wire: fixed here, its residual is part of the
        # state (a plan asking another is not a retune)
        self.grad_precision = resolve_grad_precision(grad_precision,
                                                     self._device)
        # the grouped_ep row exchange's chunks and wire precision: the
        # model reads them from the Context at each call
        # (ops.moe.resolve_dispatch_chunks / resolve_moe_precision), so
        # _build pins the Context to this trainer's values
        if dispatch_chunks is None:
            dispatch_chunks = ctx.dispatch_chunks
        self.dispatch_chunks = max(1, int(dispatch_chunks))
        if moe_precision is None:
            moe_precision = ctx.moe_precision or "bf16"
        self.moe_precision = self._effective_precision(moe_precision)
        # the dense FSDP wire: the same contract (models.llama reads it
        # from the Context at each call)
        if fsdp_precision is None:
            fsdp_precision = ctx.fsdp_precision or "bf16"
        self.fsdp_precision = self._effective_precision(fsdp_precision)
        # a mesh for the current world chosen by retune (None: the base
        # strategy's adjust_to_world)
        self._mesh_override: Optional[MeshPlan] = None
        self._result: Optional[AccelerateResult] = None
        # built steps by _program_key, least recently used first: key ->
        # (result, process-group token, the group, kept so its id is
        # not reused while the entry lives)
        self._programs: "collections.OrderedDict[str, Tuple]" = (
            collections.OrderedDict())
        self._program_cache_cap = 4
        # builds of a step (cache misses)
        self.compile_count = 0
        # attribution records by the same key as _programs (False: a
        # capture that failed, probed once); dropped with the program
        self._attr_records: Dict[str, Any] = {}
        # the world the base strategy's grad accumulation is for: a
        # smaller world accumulates more, keeping the global batch
        self._initial_world: Optional[int] = None
        # host buffers of the last snapshot taken with reuse_arena
        self._arena = None
        # the last live_reshard's timings (seconds) and worlds
        self.last_reshard: Dict[str, Any] = {}
        # handed to loss_fn each step (the reference splits a PRNG key
        # per step); the dense model draws nothing from it
        self._rng = torch.Generator(device="cpu").manual_seed(0)
        # host-side mirror of state.step
        self._host_step = 0
        self._ckpt: Optional[ElasticCheckpointManager] = None
        if ckpt_dir:
            self._ckpt = ElasticCheckpointManager(
                ckpt_dir, save_interval=ckpt_interval or CheckpointInterval()
            )

    def _effective_precision(self, precision: Optional[str]) -> str:
        """The wire precision the step will run: "bf16" where the
        device fails the fp8 probe (with a warning), so the program key,
        the Context and what the executor reports agree with the step."""
        p = str(precision or "bf16").strip() or "bf16"
        if p != "bf16" and not fp8_wire_supported(self._device):
            logger.warning("wire precision %r requested but %s fails the "
                           "fp8 probe; the trainer runs (and reports) the "
                           "bf16 wire", p, self._device.type)
            return "bf16"
        return p

    @property
    def world(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def is_chief(self) -> bool:
        return not dist.is_initialized() or dist.get_rank() == 0

    @property
    def accelerated(self) -> AccelerateResult:
        if self._result is None:
            raise RuntimeError("call prepare() first")
        return self._result

    @property
    def device(self) -> torch.device:
        return self._device

    # -- build / rebuild ----------------------------------------------------

    @staticmethod
    def _group():
        return dist.group.WORLD if dist.is_initialized() else None

    def _group_token(self) -> str:
        group = self._group()
        return "local" if group is None else f"pg{id(group):x}"

    def _resolved_strategy(self, world: int) -> Strategy:
        strategy = self._base_strategy.adjust_to_world(
            world, prev_num_devices=self._initial_world)
        if self._mesh_override is not None:
            strategy = dataclasses.replace(
                strategy, mesh=self._mesh_override.resolve(world))
        return strategy

    def _program_key(self, strategy: Strategy) -> str:
        """What a built step depends on: the device, the process group,
        the mesh's factorization (``mesh_axes_key``), the rest of the
        resolved strategy (rules, grad accumulation, remat) and the
        knobs of the step."""
        rest = dataclasses.asdict(strategy)
        del rest["mesh"]
        return (topology_key([self._device])
                + f"|world={self.world}|{self._group_token()}"
                + f"|mesh={mesh_axes_key(strategy.mesh)}"
                + f"|k={self.steps_per_call}|c={self.dispatch_chunks}"
                + f"|p={self.moe_precision}|fp={self.fsdp_precision}"
                + f"|gp={self.grad_precision}"
                + f"|strategy={json.dumps(rest, sort_keys=True)}")

    def _build(self) -> AccelerateResult:
        """The step for the current world and knobs, from the cache or
        built (``compile_count`` counts builds)."""
        ctx = get_context()
        ctx.dispatch_chunks = self.dispatch_chunks
        ctx.moe_precision = self.moe_precision
        ctx.fsdp_precision = self.fsdp_precision
        world = self.world
        if self._initial_world is None:
            self._initial_world = world
        token = self._group_token()
        # a step built over a process group that is gone never serves
        for key in [k for k, entry in self._programs.items()
                    if entry[1] != token]:
            del self._programs[key]
            self._attr_records.pop(key, None)
        strategy = self._resolved_strategy(world)
        key = self._program_key(strategy)
        reg = get_registry()
        cached = self._programs.get(key)
        if cached is not None:
            self._programs.move_to_end(key)
            reg.counter(tm.PROGRAM_CACHE_HITS,
                        help="step rebuilds served from the cache").inc()
            logger.info("program cache hit: %d ranks, K=%d (nothing built)",
                        world, self.steps_per_call)
            return cached[0]
        reg.counter(tm.PROGRAM_CACHE_MISSES,
                    help="step rebuilds that built a step").inc()
        result = accelerate(
            self._init_fn, self._loss_fn, self._optimizer,
            self._example_batch, strategy=strategy, device=self._device,
            steps_per_call=self.steps_per_call,
            grad_precision=self.grad_precision,
        )
        self.compile_count += 1
        self._programs[key] = (result, token, self._group())
        while len(self._programs) > self._program_cache_cap:
            evicted, _ = self._programs.popitem(last=False)
            self._attr_records.pop(evicted, None)
        if self.is_chief:
            logger.info("built the train step for %s x %d ranks (K=%d, "
                        "c=%d, p=%s, fp=%s, gp=%s, accum=%d)",
                        topology_key([self._device]), world,
                        self.steps_per_call, self.dispatch_chunks,
                        self.moe_precision, self.fsdp_precision,
                        self.grad_precision, strategy.grad_accum_steps)
        return result

    def _active_key(self) -> Optional[str]:
        for key, (result, _, _) in self._programs.items():
            if result is self._result:
                return key
        return None

    def attribution(self):
        """The attribution record of the ACTIVE step
        (``telemetry.attribution.AttributionRecord``), captured lazily
        on the meta device and cached by the program-cache key: a return
        to a knob set already built reuses its record as it reuses the
        step, and a record goes when its step leaves the cache. None
        when attribution or telemetry is off, nothing is built, or the
        capture failed (probed once)."""
        from dlrover_tpu_torch.telemetry import attribution as attr_mod

        if self._result is None or not attr_mod.attribution_enabled():
            return None
        key = self._active_key() or ""
        cached = self._attr_records.get(key)
        if cached is not None:
            return cached or None  # False: a probed, failed capture
        try:
            record = attr_mod.capture_attribution(
                self._result, steps_per_call=self.steps_per_call,
                example_batch=self._example_batch)
        except Exception:  # noqa: BLE001 — observation only: a step the
            # meta device cannot run must not stop the job
            logger.warning("attribution capture failed for this step",
                           exc_info=True)
            record = None
        self._attr_records[key] = record if record is not None else False
        return record

    def world_changed(self) -> bool:
        """Whether the process group differs from the one the active
        step was built over (True before anything was built)."""
        for result, token, _ in self._programs.values():
            if result is self._result:
                return token != self._group_token()
        return True

    def prepare(self, state: Optional[TrainState] = None) -> TrainState:
        """Build the step (or take it from the cache); return ``state``
        as given, else the newest checkpoint restored (staging mirror,
        then storage, then an older step), else a fresh init."""
        self._result = self._build()
        if state is not None:
            self._host_step = int(state.step)
            return state
        state = self._result.init_fn(0)
        self._host_step = 0
        if self._ckpt is not None:
            # the fresh init is the restore's target: it is filled in
            # place, so the optimizer holds the restored tensors
            restored = self._try_restore(state)
            if restored is not None:
                return restored
        return state

    def _layout(self) -> Optional[ShardLayout]:
        """Where the active step keeps each leaf, when some leaf is
        sharded over several ranks (None: every leaf whole)."""
        layout = self._result.layout if self._result else None
        if self.world == 1 or layout is None or not layout.leaves:
            return None
        return layout

    def _try_restore(self, state: TrainState) -> Optional[TrainState]:
        out = self._ckpt.restore(state, layout=self._layout())
        if out is None:
            return None
        rng = out["meta"].get("rng")
        if rng is not None:
            self._rng.set_state(torch.tensor(rng, dtype=torch.uint8))
        self._host_step = int(out["step"])
        logger.info("resumed from step %d", out["step"])
        return out["state"]

    def restore_state(self, state: Optional[TrainState] = None
                      ) -> Optional[TrainState]:
        """Restore the latest checkpoint onto the built step — the
        rollback path. With ``state`` (the live one) its tensors are
        filled in place, so no second copy of the model is made; else a
        fresh init is the target. None without a checkpoint."""
        if self._result is None or self._ckpt is None:
            return None
        if state is None:
            state = self._result.init_fn(0)
        return self._try_restore(state)

    @property
    def checkpoint_manager(self) -> Optional[ElasticCheckpointManager]:
        return self._ckpt

    # -- host snapshots -----------------------------------------------------

    def restore_snapshot(self, state: TrainState,
                         snapshot: HostSnapshot) -> TrainState:
        """Put ``snapshot`` (of this trainer, ``snapshot()``) back into
        the live ``state`` in place, with the rng stream and host step
        it was taken at."""
        snapshot.restore(state)
        self._rng.set_state(torch.tensor(snapshot.meta["rng"],
                                         dtype=torch.uint8))
        self._host_step = int(snapshot.meta["host_step"])
        return state

    def _target_layout(self, world: int) -> Optional[ShardLayout]:
        """The layout the step for ``world`` ranks and the current knobs
        will keep (the active step's global shapes, placed by the rules
        on its mesh)."""
        layout = self._result.layout if self._result else None
        if layout is None:
            return None
        strategy = self._resolved_strategy(world)
        return ShardLayout.build(strategy.rules(),
                                 step_sizes(strategy.mesh.axis_sizes()),
                                 layout.shapes)

    @staticmethod
    def _global_tensors(state: TrainState, layout: ShardLayout
                        ) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
        """Each ``state_tensors`` name -> its parameter path and global
        shape (a slot of its parameter's rank has the parameter's)."""
        tensors, _ = state_tensors(state)
        out = {}
        for name, t in tensors.items():
            kind, rest = name.split("/", 1)
            path = rest.rsplit("/", 1)[0] if kind == "opt" else rest
            full = layout.shapes[path]
            out[name] = (path, full if t.dim() == len(full)
                         else tuple(t.shape))
        return out

    def snapshot(self, state: TrainState,
                 world_to: Optional[Sequence[int]] = None,
                 reuse_arena: bool = False) -> HostSnapshot:
        """Host-DRAM copy of the live state (one device-to-host copy a
        leaf, then one sync); its meta holds the strategy, the rng
        stream and the host step, so it is a complete resume point.

        ``world_to``: for a planned change of world, the ranks of the
        current world that stay (every rank calls this: the sharded
        leaves move over the current group). The snapshot then holds
        this rank's blocks of the next world's sharded leaves, and a
        rank that leaves holds none. A mesh of the current world that
        the knobs changed (``retune``) regroups the same way. ``reuse_arena``: copy into the host
        buffers of the last snapshot taken with it, when the shapes
        match, instead of pinning new ones (that snapshot is
        overwritten)."""
        regroup, world = None, self.world
        survivors = list(range(world))
        if world_to is not None:
            survivors = sorted({int(r) for r in world_to})
            if not survivors or survivors[0] < 0 or survivors[-1] >= world:
                raise ValueError(f"ranks {list(world_to)} are not a subset "
                                 f"of the world of {world}")
        old = self._result.layout if self._result else None
        new = self._target_layout(len(survivors))
        if (world > 1 and old is not None
                and (old.leaves or new.leaves)
                and (len(survivors) != world or old != new)):
            regroup = Regroup(self._group(), dist.get_rank(), world,
                              survivors, old, new,
                              self._global_tensors(state, old))
        snap = HostSnapshot.take(
            state, arena=self._arena if reuse_arena else None,
            regroup=regroup,
            strategy=self._result.strategy.to_json() if self._result else "",
            rng=self._rng.get_state().tolist(),
            host_step=int(self._host_step), world=len(survivors),
            sharded=bool(new is not None and new.leaves),
            mesh=dict(new.sizes) if new is not None else {},
        )
        if reuse_arena:
            self._arena = snap._arena
        return snap

    def _state_from_snapshot(self, snapshot: HostSnapshot) -> TrainState:
        """A new TrainState on the device from ``snapshot``: its
        parameters and gradient-wire residual (of the snapshot's shapes),
        a new optimizer over them (the active step's) holding the
        snapshot's moments, its step, rng and host step."""
        trees: Dict[str, Dict] = {"params": {}, "wire_residual": {}}
        for name, t in snapshot.tree.items():
            kind, _, rest = name.partition("/")
            if kind not in trees:
                continue
            *outer, key = rest.split("/")
            node = trees[kind]
            for part in outer:
                node = node.setdefault(part, {})
            leaf = torch.empty(t.shape, dtype=t.dtype, device=self._device)
            node[key] = (leaf.requires_grad_(leaf.is_floating_point())
                         if kind == "params" else leaf)
        params = trees["params"]
        state = TrainState(step=0, params=params,
                           opt_state=self._result.make_optimizer(params),
                           wire_residual=trees["wire_residual"] or None)
        return self.restore_snapshot(state, snapshot)

    @staticmethod
    def _release(state: TrainState) -> None:
        """Drop the device tensors ``state`` holds (parameters, their
        gradients, the optimizer's slots, the gradient wire's residual);
        ``state`` is empty after."""
        for p in tree_leaves(state.params):
            p.grad = None
        if state.opt_state is not None:
            state.opt_state.state.clear()
            state.opt_state.param_groups.clear()
        state.params, state.opt_state = {}, None
        state.wire_residual = None

    # -- in-process recovery ------------------------------------------------

    def live_reshard(self, state: TrainState, devices=None,
                     snapshot: Optional[HostSnapshot] = None,
                     reason: str = "", emit_events: bool = True
                     ) -> Optional[TrainState]:
        """Absorb a change of world without leaving the process:
        snapshot, rebuild (through the cache), restore into a new
        TrainState, resume. Callers drain their in-flight steps first.

        ``devices``: the ranks of the current world that stay (a planned
        change: every rank calls this; the snapshot moves each
        survivor's new slices over the current group, then the group is
        re-formed from the store's next round). A rank that leaves gets
        None. Default: the world as it is now (re-formed by the caller,
        who took ``snapshot`` with ``world_to`` before, or unchanged).
        ``snapshot``: one taken before (default: taken now, into the
        trainer's reused host buffers).

        The global batch stays fixed: ``Strategy.adjust_to_world``
        shrinks the data axis and raises ``grad_accum_steps``. The old
        state's device memory is freed before the new one is filled."""
        old = self._result
        world_from = old.world if old is not None else self.world
        t0 = time.monotonic()
        if emit_events:
            emit_event(EventKind.LIVE_RESHARD_BEGIN, world_from=world_from,
                       reason=reason, step=int(self._host_step))
        with span(SpanName.LIVE_RESHARD, world_from=world_from):
            if devices is not None:
                survivors = sorted({int(r) for r in devices})
                if snapshot is None:
                    snapshot = self.snapshot(state, world_to=survivors,
                                             reuse_arena=True)
                t_snap = time.monotonic()
                if survivors != list(range(world_from)):
                    me = dist.get_rank() if dist.is_initialized() else 0
                    new_rank = (survivors.index(me) if me in survivors
                                else None)
                    bootstrap.reform_world(new_rank, len(survivors))
                    if new_rank is None:
                        self._release(state)
                        self._programs.clear()
                        self._attr_records.clear()
                        self._result = None
                        logger.info("left the world at step %d (%s)",
                                    self._host_step, reason or "reshard")
                        return None
            else:
                if snapshot is None:
                    snapshot = self.snapshot(state, reuse_arena=True)
                t_snap = time.monotonic()
            t_reform = time.monotonic()
            world_to = self.world
            if (snapshot.meta.get("sharded")
                    and snapshot.meta.get("world") != world_to):
                raise ValueError(
                    f"the snapshot holds sharded leaves laid out for "
                    f"{snapshot.meta.get('world')} ranks, the world has "
                    f"{world_to}: take it with world_to= before the group "
                    f"changes (or restore from storage)")
            compiles_before = self.compile_count
            result = self._build()
            if (snapshot.meta.get("sharded")
                    and snapshot.meta.get("mesh") != result.layout.sizes):
                raise ValueError(
                    f"the snapshot holds blocks laid out for the mesh "
                    f"{snapshot.meta.get('mesh')}, the step keeps "
                    f"{result.layout.sizes}: take it after setting the "
                    f"knobs")
            t_build = time.monotonic()
            self._release(state)
            # the new step's optimizer (its norm groups) holds the state
            self._result = result
            state = self._state_from_snapshot(snapshot)
        done = time.monotonic()
        seconds = done - t0
        recompiled = self.compile_count - compiles_before
        self.last_reshard = {
            "world_from": world_from, "world_to": world_to,
            "snapshot_s": t_snap - t0, "reform_s": t_reform - t_snap,
            "rebuild_s": t_build - t_reform, "restore_s": done - t_build,
            "seconds": seconds, "recompiled": recompiled,
            "snapshot_bytes": snapshot.nbytes(),
        }
        reg = get_registry()
        reg.counter(tm.LIVE_RESHARDS,
                    help="world or knob changes absorbed in the "
                         "process").inc()
        reg.histogram(tm.LIVE_RESHARD_TIME,
                      help="snapshot -> rebuild -> restore wall "
                           "seconds").observe(seconds)
        if self.is_chief:
            logger.info(
                "live reshard: %d -> %d ranks in %.2fs (snapshot %.2f, "
                "rebuild %.2f, restore %.2f; grad_accum %d -> %d, %s)",
                world_from, world_to, seconds, t_snap - t0,
                t_build - t_reform, done - t_build,
                old.strategy.grad_accum_steps if old else 1,
                result.strategy.grad_accum_steps,
                "built" if recompiled else "program cache hit")
        if emit_events:
            emit_event(EventKind.LIVE_RESHARD_DONE, world_from=world_from,
                       world_to=world_to, reshard_seconds=round(seconds, 3),
                       recompiled=recompiled, step=snapshot.step)
        return state

    def on_world_change(self, state: TrainState, devices=None
                        ) -> Optional[TrainState]:
        """The restart path's rebuild (the executor's
        ``request_restart``): ``live_reshard`` without its timeline
        events, so it does not count as a live reshard."""
        return self.live_reshard(state, devices=devices,
                                 reason="on_world_change", emit_events=False)

    def _knobs(self) -> Tuple:
        return (self.steps_per_call, self._mesh_override,
                self.dispatch_chunks, self.moe_precision,
                self.fsdp_precision)

    def _set_knobs(self, steps_per_call, mesh, dispatch_chunks,
                   moe_precision, fsdp_precision) -> None:
        if mesh is not None and max(mesh.pipe, mesh.tensor) > 1:
            raise NotImplementedError(
                f"mesh {mesh.axis_sizes()}: only (data x fsdp x seq) "
                f"factorizations are ported; the pipe and tensor axes are "
                f"not (ROADMAP A15)")
        if steps_per_call is not None:
            self.steps_per_call = max(1, int(steps_per_call))
        if mesh is not None:
            self._mesh_override = mesh
        if dispatch_chunks is not None:
            self.dispatch_chunks = max(1, int(dispatch_chunks))
        if moe_precision is not None:
            self.moe_precision = self._effective_precision(moe_precision)
        if fsdp_precision is not None:
            self.fsdp_precision = self._effective_precision(fsdp_precision)

    def _restore_knobs(self, saved: Tuple) -> None:
        (self.steps_per_call, self._mesh_override, self.dispatch_chunks,
         self.moe_precision, self.fsdp_precision) = saved
        ctx = get_context()
        ctx.dispatch_chunks = self.dispatch_chunks
        ctx.moe_precision = self.moe_precision
        ctx.fsdp_precision = self.fsdp_precision

    def prewarm(self, devices=None, execute: bool = True,
                steps_per_call: Optional[int] = None,
                mesh: Optional[MeshPlan] = None,
                dispatch_chunks: Optional[int] = None,
                moe_precision: Optional[str] = None,
                fsdp_precision: Optional[str] = None) -> bool:
        """Build the step for a knob set we may switch to into the cache,
        so the ``retune`` that follows builds nothing. Returns True when
        it built, False on a cache hit. The active step, the knobs and
        the Context stay as they were.

        ``execute``: run one throwaway step (the multi-step call when
        K > 1) on a throwaway state, so the first call's one-time costs
        (kernel modules, allocator growth) are paid here; it holds a
        second copy of the state while it runs. ``devices``: the ranks
        of the world to build for; only the current world has a process
        group to build a mesh over, so any other raises."""
        world = list(range(self.world))
        if devices is not None and sorted(int(d) for d in devices) != world:
            raise ValueError(
                f"prewarm for ranks {list(devices)}: the world of "
                f"{self.world} ranks is the only one with a process group "
                f"to build a mesh over; re-form the world first "
                f"(trainer.bootstrap.reform_world)")
        saved = self._knobs()
        try:
            self._set_knobs(steps_per_call, mesh, dispatch_chunks,
                            moe_precision, fsdp_precision)
            before = self.compile_count
            result = self._build()
            built = self.compile_count > before
            if execute and built:
                self._execute_dummy_step(result)
        finally:
            self._restore_knobs(saved)
        return built

    def _execute_dummy_step(self, result: AccelerateResult) -> None:
        """One throwaway step of ``result`` on a fresh state and the
        example batch, with a generator of its own (the trainer's rng
        stream does not move)."""
        dummy = result.init_fn(0)
        gen = torch.Generator(device="cpu").manual_seed(0)
        k = result.steps_per_call
        if k > 1:
            batches = stack_batches([self._example_batch] * k)
            dummy, _ = result.train_step_multi(
                dummy, result.shard_batch(batches, stacked=True), gen)
        else:
            dummy, _ = result.train_step(
                dummy, result.shard_batch(self._example_batch), gen)
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._release(dummy)
        logger.info("prewarmed the step (%d ranks, K=%d): one throwaway "
                    "step ran", result.world, k)

    def retune(self, state: TrainState, steps_per_call: Optional[int] = None,
               mesh: Optional[MeshPlan] = None,
               dispatch_chunks: Optional[int] = None,
               moe_precision: Optional[str] = None,
               fsdp_precision: Optional[str] = None,
               reason: str = "optimizer") -> TrainState:
        """New knobs of the step on the unchanged world, without a
        restart: ``live_reshard`` through the cache (a prewarmed knob
        set builds nothing). The knobs: ``steps_per_call``, a ``mesh``
        of the same ranks, the MoE's ``dispatch_chunks`` and
        ``moe_precision``, and the dense wire's ``fsdp_precision``; not
        ``grad_precision``, whose residual is part of the state. Callers
        drain their in-flight steps first.
        On failure the old knobs and the old step come back, ``state``
        holds the state again, and the error propagates."""
        saved = self._knobs()
        snapshot = None
        try:
            self._set_knobs(steps_per_call, mesh, dispatch_chunks,
                            moe_precision, fsdp_precision)
            snapshot = self.snapshot(state, reuse_arena=True)
            return self.live_reshard(state, snapshot=snapshot, reason=reason,
                                     emit_events=False)
        except Exception:
            self._restore_knobs(saved)
            self._result = self._build()
            if state.opt_state is None and snapshot is not None:
                back = self._state_from_snapshot(snapshot)
                state.params, state.opt_state, state.step = (
                    back.params, back.opt_state, back.step)
                state.wire_residual = back.wire_residual
            raise

    # -- hot loop -----------------------------------------------------------

    def step(self, state: TrainState, batch: Any) -> Tuple[TrainState, Dict]:
        state, metrics = self._result.train_step(
            state, self._result.shard_batch(batch), self._rng)
        self._host_step += 1
        step = self._host_step
        if self._ckpt is not None and self._ckpt.interval.should_save(step):
            # never checkpoint a NaN-poisoned state: it would corrupt the
            # rollback/restore target (the one device sync this costs
            # happens only on save steps)
            if "finite" not in metrics or bool(metrics["finite"]):
                self.save(state)
            else:
                logger.warning(
                    "skipping checkpoint at step %d: non-finite state", step
                )
        return state, metrics

    def step_multi(self, state: TrainState, batches: Any
                   ) -> Tuple[TrainState, Dict]:
        """``steps_per_call`` optimizer steps in one call. ``batches``:
        exactly that many host batches, or one batch already stacked on
        a leading K axis. The rng stream advances as K calls of ``step``
        advance it, so the group is bit for bit K steps. Metrics come
        back stacked [K, ...]."""
        k = self.steps_per_call
        multi = self._result.train_step_multi
        if multi is None or k <= 1:
            raise RuntimeError("step_multi needs steps_per_call > 1 (got "
                               f"steps_per_call={k})")
        if isinstance(batches, (list, tuple)):
            if len(batches) != k:
                raise ValueError(f"step_multi takes exactly steps_per_call="
                                 f"{k} batches, got {len(batches)}")
            batches = stack_batches(list(batches))
        state, metrics = multi(
            state, self._result.shard_batch(batches, stacked=True), self._rng)
        self._host_step += k
        step = self._host_step
        if self._ckpt is not None and self._ckpt.interval.should_save(step):
            # the stacked finite flags: one device sync, on save steps
            # only, covering every step of the group
            finite = metrics.get("finite")
            if finite is None or bool(finite.all()):
                self.save(state)
            else:
                logger.warning("skipping checkpoint at step %d: non-finite "
                               "state inside the %d-step group", step, k)
        return state, metrics

    # -- checkpoint ----------------------------------------------------------

    def latest_checkpoint_step(self) -> Optional[int]:
        """Newest restorable step, flushing any in-flight async save
        first; None when no checkpointing is configured or nothing has
        been committed yet (the executor's rollback precondition)."""
        if self._ckpt is None:
            return None
        try:
            self._ckpt.wait()
        except Exception:  # noqa: BLE001
            logger.exception("flushing async checkpoint failed")
        return self._ckpt.latest_step()

    def save(self, state: TrainState, force: bool = True):
        if self._ckpt is None:
            return
        self._ckpt.save(
            int(state.step),
            state,
            metadata={"strategy": self._result.strategy.to_json(),
                      "rng": self._rng.get_state().tolist(),
                      "host_step": int(self._host_step)},
            force=force,
            layout=self._layout(),
        )

    def finalize(self) -> bool:
        """Flush + close checkpointing. Returns True when a staging
        mirror timed out (``ElasticCheckpointManager.wait``), so exit
        paths (the preemption drain) can report that the host-DRAM
        mirror never committed."""
        timed_out = False
        if self._ckpt is not None:
            timed_out = bool(self._ckpt.wait())
            self._ckpt.close()
        return timed_out

