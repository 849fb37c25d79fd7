"""Elastic checkpointing over ``torch.distributed.checkpoint`` (port of
``dlrover_tpu/checkpoint/manager.py``, which runs on Orbax).

A checkpoint holds the training state keyed by parameter path, not by
the optimizer's integer parameter ids: ``params/<path>`` for each leaf of
``TrainState.params``, ``opt/<path>/<slot>`` for each tensor the
optimizer keeps for it (AdamW: ``step``, ``exp_avg``, ``exp_avg_sq``)
and, under the gradient wire, ``wire_residual/<path>`` for each leaf of
the error-feedback residual, laid out as its parameter.
So a checkpoint survives a change of parameter order, and the JAX
package's tree maps onto it path for path (``interop``).

Over several ranks a leaf the rules shard (``AccelerateResult.layout``)
is written as a DTensor on the ranks' 2-D ``(data, fsdp)`` mesh:
``[Replicate(), Shard(dim)]`` for an fsdp leaf, ``[Shard(dim),
Shard(dim)]`` for one split over both axes (the experts under
``moe_ep``), its optimizer slots of its rank alike; DCP writes each
block once, whatever its replicas, and every replicated leaf once. The
checkpoint therefore holds global tensors, and loads at any (data, fsdp)
whose rules split them, each rank reading its own block, as the
reference's GSPMD arrays reshard on load.

The step loop updates parameters and moments IN PLACE (``accelerate``),
where the reference's XLA step donates its buffers. So every save first
copies the state to host memory (one copy a leaf, then one sync: page-
locked buffers on a CUDA device, reused from save to save), and only
that copy is written, in the background when ``async_save`` is on. A
step becomes visible only when all of it is written: DCP writes into
``<dir>/.tmp_<step>``, and the coordinator renames it to ``<dir>/<step>``
after DCP's finish. A crash mid-save leaves the previous step newest.

Restores load into host buffers first and copy into the live tensors
only once the read succeeded, so the optimizer keeps stepping the same
tensors (``restore(state)`` fills the state it is given) and a failed
read leaves the live state as it was.

The master's data-shard checkpoint rides along as a string
(``shard_checkpoint``); the port has no master client yet, so the
trainer passes "".
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import shutil
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.parallel.accelerate import _named_leaves
from dlrover_tpu_torch.parallel.sharding_rules import ShardLayout
from dlrover_tpu_torch.telemetry import (
    EventKind,
    SpanName,
    emit_event,
    get_registry,
    names as tm,
    span,
)

logger = get_logger("checkpoint.manager")

META_FILE = "meta.json"
# DCP's file-writing threads for one rank's part of a step
WRITE_THREADS = 8
# a host buffer's start, within its arena
_ALIGN = 256
_PAGE = 4096

# layout: where each leaf of the state lives on the (data x fsdp) mesh of
# the checkpoint's ranks (``AccelerateResult.layout``); None = every leaf
# whole on every rank
Layout = Optional[ShardLayout]


@dataclass
class CheckpointInterval:
    """Cadence helper (reference: ``trainer/torch/elastic.py:170``).

    ``steps`` and ``secs`` compose with OR: save when either elapses.
    """

    steps: int = 0
    secs: float = 0.0
    _last_step: int = 0
    _last_time: float = 0.0

    def __post_init__(self):
        self._last_time = time.time()

    def should_save(self, step: int) -> bool:
        due = False
        if self.steps and step - self._last_step >= self.steps:
            due = True
        if self.secs and time.time() - self._last_time >= self.secs:
            due = True
        return due

    def mark_saved(self, step: int):
        self._last_step = step
        self._last_time = time.time()


class CheckpointError(RuntimeError):
    """A DCP save or load failed on some rank (DCP's own
    ``CheckpointException`` is a ``BaseException``, which the restore's
    fallbacks and the writer's future must see as an ordinary error)."""


def _dcp(fn, *args, **kwargs):
    from torch.distributed.checkpoint.api import CheckpointException

    try:
        return fn(*args, **kwargs)
    except CheckpointException as e:
        raise CheckpointError(str(e)) from e


# -- the state as named tensors -----------------------------------------------


def state_tensors(state) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """(name -> live tensor, name -> non-tensor optimizer value) of a
    ``TrainState``: ``params/<path>``, ``opt/<path>/<slot>`` and
    ``wire_residual/<path>``. A plain mapping of parts (a serving
    engine's ``{"params", "cache"[, "prefix"]}``) gives ``<part>/<path>``
    for each of its tensors."""
    tensors: Dict[str, torch.Tensor] = {}
    values: Dict[str, Any] = {}
    if isinstance(state, Mapping):
        for part, sub in state.items():
            for path, t in _named_leaves(sub):
                tensors[f"{part}/{path}"] = t
        return tensors, values
    slots = state.opt_state.state
    for path, p in _named_leaves(state.params):
        tensors[f"params/{path}"] = p
        for key, v in slots.get(p, {}).items():
            name = f"opt/{path}/{key}"
            if isinstance(v, torch.Tensor):
                tensors[name] = v
            else:
                values[name] = v
    residual = getattr(state, "wire_residual", None)
    if residual is not None:
        for path, r in _named_leaves(residual):
            tensors[f"wire_residual/{path}"] = r
    return tensors, values


def _param_path(name: str) -> str:
    """The parameter path of ``params/<path>``, ``opt/<path>/<slot>`` or
    ``wire_residual/<path>``."""
    kind, rest = name.split("/", 1)
    return rest.rsplit("/", 1)[0] if kind == "opt" else rest


def slot_device(opt: torch.optim.Optimizer, p: torch.Tensor,
                key: str) -> torch.device:
    """Where ``opt`` keeps slot ``key`` of ``p``: torch's own rule
    (``Optimizer.load_state_dict``): ``step`` on the CPU unless the
    group is fused or capturable, every other slot beside the
    parameter."""
    if key != "step":
        return p.device
    for group in opt.param_groups:
        if any(q is p for q in group["params"]):
            if group.get("fused") or group.get("capturable"):
                return p.device
    return torch.device("cpu")


def _fill_state(state, host: Mapping[str, torch.Tensor],
                values: Mapping[str, Any], step: int) -> None:
    """Copy host tensors into the live state: into the parameters and
    the optimizer's slot tensors in place where they exist with the
    same shape, dtype and device, else into new slot tensors, so the
    optimizer steps the tensors it already holds. A parameter's slots
    become exactly the saved ones (a snapshot of a fresh optimizer
    empties them again). Then one sync."""
    opt = state.opt_state
    slots: Dict[str, Dict[str, Any]] = {}
    for name, v in list(host.items()) + list(values.items()):
        if name.startswith("opt/"):
            path, key = name[len("opt/"):].rsplit("/", 1)
            slots.setdefault(path, {})[key] = v
    live_cuda = None
    with torch.no_grad():
        for path, p in _named_leaves(state.params):
            p.copy_(host[f"params/{path}"], non_blocking=True)
            if p.is_cuda:
                live_cuda = p.device
            old = opt.state.get(p, {})
            new = {}
            for key, v in slots.get(path, {}).items():
                if not isinstance(v, torch.Tensor):
                    new[key] = v
                    continue
                cur = old.get(key)
                if not (isinstance(cur, torch.Tensor)
                        and cur.shape == v.shape and cur.dtype == v.dtype):
                    cur = torch.empty(v.shape, dtype=v.dtype,
                                      device=slot_device(opt, p, key))
                cur.copy_(v, non_blocking=True)
                if cur.is_cuda:
                    live_cuda = cur.device
                new[key] = cur
            if new:
                opt.state[p] = new
            else:
                opt.state.pop(p, None)
        residual = getattr(state, "wire_residual", None)
        for path, r in (_named_leaves(residual) if residual is not None
                        else ()):
            r.copy_(host[f"wire_residual/{path}"], non_blocking=True)
            if r.is_cuda:
                live_cuda = r.device
    if live_cuda is not None:
        torch.cuda.synchronize(live_cuda)
    state.step = int(step)


# -- host buffers -------------------------------------------------------------


def _register(ptr: int, nbytes: int) -> None:
    err = torch.cuda.cudart().cudaHostRegister(ptr, nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                           f"{err}")


def _fault_in(buf: np.ndarray) -> None:
    """Write every page of ``buf`` from several threads: the kernel's
    page faults (zero-filling) are most of what pinning costs, and
    ``cudaHostRegister`` of pages already resident is quicker."""
    threads = max(1, min(16, 2 * (os.cpu_count() or 1)))
    step = -(-buf.size // threads // _PAGE) * _PAGE
    workers = [threading.Thread(target=buf[lo:lo + step].fill, args=(0,))
               for lo in range(0, buf.size, step)]
    for w in workers:
        w.start()
    for w in workers:
        w.join()


def _unregister(registered: List) -> None:
    for ptr, _memory in registered:
        torch.cuda.cudart().cudaHostUnregister(ptr)
    registered.clear()


class _HostArena:
    """Host tensors of given shapes and dtypes carved from one numpy
    allocation, page-locked (``cudaHostRegister``) when they take copies
    of CUDA tensors, so device-host copies run at the link's rate and
    need no staging. Each tensor owns a storage of exactly its own
    bytes (``torch.from_numpy`` of its slice): DCP writes it without a
    copy. The registration ends when the arena is collected; the memory
    lives on while a tensor cut from it does."""

    def __init__(self, specs: Mapping[str, Tuple[Tuple[int, ...],
                                                 torch.dtype]],
                 pin: bool):
        self.specs = dict(specs)
        offsets, total = {}, 0
        for name, (shape, dtype) in self.specs.items():
            nbytes = int(np.prod(shape, dtype=np.int64)) * torch.empty(
                (), dtype=dtype).element_size()
            offsets[name] = (total, nbytes)
            total += -(-max(nbytes, 1) // _ALIGN) * _ALIGN
        raw = np.empty(total + 2 * _PAGE, dtype=np.uint8)
        start = -raw.ctypes.data % _PAGE
        self.tensors: Dict[str, torch.Tensor] = {}
        for name, (shape, dtype) in self.specs.items():
            off, nbytes = offsets[name]
            chunk = raw[start + off:start + off + nbytes]
            self.tensors[name] = torch.from_numpy(chunk).view(dtype).view(
                shape)
        self._registered: List = []
        if pin and total:
            size = -(-total // _PAGE) * _PAGE
            ptr = raw.ctypes.data + start
            _fault_in(raw[start:start + size])
            _register(ptr, size)
            self._registered.append((ptr, raw))
            weakref.finalize(self, _unregister, self._registered)

    def matches(self, specs) -> bool:
        return dict(specs) == self.specs

    def release(self) -> None:
        _unregister(self._registered)


def _specs(tensors: Mapping[str, torch.Tensor]):
    return {name: (tuple(t.shape), t.dtype) for name, t in tensors.items()}


def _pin_for(tensors: Mapping[str, torch.Tensor]) -> bool:
    return any(t.is_cuda for t in tensors.values())


def _copy_to_host(tensors: Mapping[str, torch.Tensor],
                  arena: _HostArena) -> Dict[str, torch.Tensor]:
    """One copy a leaf into ``arena``, then one sync."""
    devices = set()
    with torch.no_grad():
        for name, t in tensors.items():
            arena.tensors[name].copy_(t.detach(), non_blocking=True)
            if t.is_cuda:
                devices.add(t.device)
    for device in devices:
        torch.cuda.synchronize(device)
    return dict(arena.tensors)


@dataclass
class HostSnapshot:
    """An in-process, host-DRAM copy of a TrainState: a rollback anchor
    that needs no storage, and a check that a step is deterministic.

    The leaves are host tensors that the step loop never updates in
    place (on the CPU device too: each leaf is copied, never aliased).
    ``restore`` copies them back into a live state, so its optimizer
    keeps stepping the tensors it holds."""

    step: int
    tree: Dict[str, Any]  # name -> host tensor (or optimizer value)
    meta: Dict[str, Any]
    _arena: Any = field(default=None, repr=False)

    @classmethod
    def take(cls, state, arena=None, regroup=None, **meta) -> "HostSnapshot":
        """One device-to-host copy of every leaf, then one sync. Callers
        drain in-flight steps first so this waits only on the last.
        ``state``: a ``TrainState`` or a plain mapping of parts (a
        serving engine's, ``meta`` then ``kind="serving"``).

        ``arena``: the host buffers of an earlier snapshot (its
        ``_arena``), copied into when the shapes match instead of
        pinning new ones; that snapshot's contents are overwritten.
        ``regroup``: a ``checkpoint.regroup.Regroup``, for a planned
        change of world: the sharded leaves are taken as this rank's
        slices of the next world (a collective over the old group)."""
        t0 = time.monotonic()
        with span(SpanName.STATE_SNAPSHOT):
            tensors, values = state_tensors(state)
            specs = (_specs(tensors) if regroup is None
                     else regroup.specs(tensors))
            if arena is None or not arena.matches(specs):
                arena = _HostArena(specs, _pin_for(tensors))
            host = (_copy_to_host(tensors, arena) if regroup is None
                    else regroup.copy(tensors, arena))
            tree = {**host, **values}
        snap_s = time.monotonic() - t0
        get_registry().histogram(
            tm.SNAPSHOT_TIME,
            help="host-DRAM TrainState snapshot seconds",
        ).observe(snap_s)
        step = int(getattr(state, "step", 0))
        emit_event(EventKind.STATE_SNAPSHOT, step=step,
                   snapshot_seconds=round(snap_s, 3))
        return cls(step=step, tree=tree, meta=dict(meta), _arena=arena)

    def restore(self, state):
        """Put the snapshot back into ``state`` (in place) and return
        it."""
        host = {k: v for k, v in self.tree.items()
                if isinstance(v, torch.Tensor)}
        values = {k: v for k, v in self.tree.items()
                  if not isinstance(v, torch.Tensor)}
        _fill_state(state, host, values, self.step)
        return state

    def restore_tree(self, device) -> Dict[str, Any]:
        """The snapshot of a plain mapping (see ``state_tensors``) as
        new tensors on ``device``, nested as it was taken: one copy a
        leaf, then one sync."""
        tree: Dict[str, Any] = {}
        with torch.no_grad():
            for name, v in self.tree.items():
                node = tree
                *parents, last = name.split("/")
                for key in parents:
                    node = node.setdefault(key, {})
                out = v.to(device, non_blocking=True)
                node[last] = out.clone() if out.data_ptr() == v.data_ptr() \
                    else out
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        return tree

    def nbytes(self) -> int:
        """Host bytes this snapshot holds."""
        return sum(v.numel() * v.element_size() for v in self.tree.values()
                   if isinstance(v, torch.Tensor))


# -- the manager --------------------------------------------------------------


def _agree(flag: bool, group) -> bool:
    """True on every rank iff ``flag`` is true on every rank."""
    if group is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return bool(t.item())


class ElasticCheckpointManager:
    """Save/restore a TrainState with its metadata, async by default.

    One numbered directory a step, holding DCP's files and ``meta.json``;
    checkpoints written at one rank count restore at another.
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: int = 3,
        async_save: Optional[bool] = None,
        save_interval: Optional[CheckpointInterval] = None,
        staging_dir: Optional[str] = None,
        run_identity: str = "",
    ):
        from dlrover_tpu_torch.common.config import get_context

        # staging provenance token: a caller-stable run identity
        # survives the loss of the primary root (the outage staging
        # exists for) while fencing out another run reusing the path.
        # RUN_ID (job name + launch epoch) is preferred over the bare
        # JOB_NAME: a fresh job reusing the name and the checkpoint path
        # must not adopt the previous run's staged weights
        self._run_identity = (
            run_identity
            or os.environ.get(NodeEnv.RUN_ID, "")
            or os.environ.get(NodeEnv.JOB_NAME, "")
        )
        ctx = get_context()
        if async_save is None:
            async_save = ctx.ckpt_async
        self.async_save = bool(async_save)
        self.max_to_keep = max_to_keep
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # over several ranks: a gloo group of its own, so the background
        # writer's collectives never interleave with the step's
        self._group = None
        self._device_mesh = None
        self.rank = 0
        if dist.is_initialized() and dist.get_world_size() > 1:
            self._group = dist.new_group(backend="gloo")
            self.rank = dist.get_rank()
        if self.rank == 0:
            # reclaim the parts of saves a crash left behind
            for name in os.listdir(self.directory):
                if name.startswith(".tmp_"):
                    shutil.rmtree(os.path.join(self.directory, name),
                                  ignore_errors=True)
        if self._group is not None:
            dist.barrier(group=self._group)
        self.interval = save_interval or CheckpointInterval()
        # host-DRAM staging (reference: Flash Checkpoint): after a save
        # commits, the coordinator mirrors the step dir into tmpfs so a
        # restart on the same host restores from DRAM
        self._staging_root: Optional[str] = None
        if staging_dir is None and ctx.ckpt_host_staging:
            shm = "/dev/shm"
            if (
                os.path.isdir(shm)
                and os.access(shm, os.W_OK)
                and not self.directory.startswith(shm)
            ):
                staging_dir = os.path.join(
                    shm, "dlrover_tpu_ckpt",
                    hashlib.md5(self.directory.encode()).hexdigest()[:12],
                )
        if staging_dir:
            self._staging_root = os.path.abspath(staging_dir)
            os.makedirs(self._staging_root, exist_ok=True)
        reg = get_registry()
        self._c_saves = reg.counter(
            tm.CKPT_SAVES, help="checkpoint saves queued")
        self._h_save = reg.histogram(
            tm.CKPT_SAVE_TIME,
            help="host time staging a save (the device->host copy before "
                 "the background write)")
        self._h_mirror = reg.histogram(
            tm.CKPT_MIRROR_TIME, help="host-DRAM staging mirror copy time")
        self._c_mirror_timeouts = reg.counter(
            tm.CKPT_MIRROR_TIMEOUTS,
            help="staging mirrors still uncommitted at a wait() deadline")
        self._h_restore = reg.histogram(
            tm.CKPT_RESTORE_TIME, help="restore wall time")
        self._c_restores = reg.counter(
            tm.CKPT_RESTORES, help="successful restores")
        # the background writer: one save in flight at a time
        self._writer = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Optional[concurrent.futures.Future] = None
        self._pending_step: Optional[int] = None
        # host buffers of the last save or restore, reused while the
        # state's shapes stay the same
        self._arena: Optional[_HostArena] = None
        # step -> seconds from save() to the step's commit
        self.commit_seconds: Dict[int, float] = {}
        self._mirror_lock = threading.Lock()
        self._mirror_threads: list = []
        # mirror THREAD OBJECTS that already consumed a full join
        # timeout (wait() only polls these afterwards)
        self._mirror_timed_out: set = set()

    # -- save ----------------------------------------------------------------

    def _host_buffers(self, specs, pin: bool) -> _HostArena:
        """The reused host buffers, made anew when the shapes change."""
        if self._arena is None or not self._arena.matches(specs):
            if self._arena is not None:
                self._arena.release()
            self._arena = None
            self._arena = _HostArena(specs, pin)
        return self._arena

    def _mesh(self, sizes: Mapping[str, int]):
        """The checkpoint's ranks as a CPU DeviceMesh over the layout's
        axes, (data, fsdp) or (data, fsdp, seq) (DCP reads a DTensor's
        place from it, a replica on every axis but its own; it runs no
        collective)."""
        from torch.distributed.device_mesh import DeviceMesh

        shape = tuple(sizes.values())
        if self._device_mesh is None or self._device_mesh[0] != shape:
            self._device_mesh = (shape, DeviceMesh(
                "cpu", torch.arange(dist.get_world_size()).reshape(shape),
                mesh_dim_names=tuple(sizes), _init_backend=False))
        return self._device_mesh[1]

    def _distributed(self, host: Mapping[str, torch.Tensor],
                     layout: Layout) -> Dict[str, Any]:
        """Host tensors as DCP takes them: a sharded leaf (and its
        optimizer slots of the same rank) as a DTensor on the mesh."""
        if self._group is None or layout is None or not layout.leaves:
            return dict(host)
        from torch.distributed.tensor import DTensor, Replicate, Shard

        mesh = self._mesh(layout.sizes)
        out = {}
        for name, t in host.items():
            path = _param_path(name)
            shard = layout.leaves.get(path)
            if shard is not None and t.dim() == len(layout.shapes[path]):
                t = DTensor.from_local(
                    t, mesh, [Shard(shard.dim) if axis in shard.axes
                              else Replicate() for axis in layout.sizes],
                    run_check=False)
            out[name] = t
        return out

    def save(
        self,
        step: int,
        state,
        metadata: Optional[Dict] = None,
        shard_checkpoint: str = "",
        force: bool = False,
        layout: Layout = None,
    ) -> bool:
        """Queue a checkpoint; returns True if a save was started.

        The state is copied to host memory before this returns; with
        async on, the files are written in the background. A step that
        is already saved (or being saved) is not written again, and
        without ``force`` neither is one at or below the newest.
        """
        step = int(step)
        if not force and not self.interval.should_save(step):
            return False
        latest = self.latest_step()
        if step in self.all_steps() or step == self._pending_step or (
                not force and latest is not None and latest >= step):
            logger.info("checkpoint %d exists; not saved again", step)
            return False
        t0 = time.monotonic()
        with span(SpanName.CKPT_SAVE_STAGE, step=step):
            # the host buffers are reused: the last write must be done
            self._wait_pending()
            tensors, values = state_tensors(state)
            host = _copy_to_host(tensors, self._host_buffers(
                _specs(tensors), _pin_for(tensors)))
        stage_s = time.monotonic() - t0
        meta = {
            "step": step,
            "meta": {**(metadata or {}), "save_wall_time": time.time()},
            "shard_checkpoint": shard_checkpoint,
            "opt_values": values,
        }
        self._c_saves.inc()
        self._h_save.observe(stage_s)
        emit_event(EventKind.CKPT_SAVE, step=step,
                   stage_seconds=round(stage_s, 3), forced=force)
        self.interval.mark_saved(step)
        job = (step, self._distributed(host, layout), meta, t0)
        if self.async_save:
            self._pending = self._writer.submit(self._write, *job)
            self._pending_step = step
            logger.info("checkpoint %d queued to %s", step, self.directory)
        else:
            self._write(*job)
        if self._staging_root is not None and self.rank == 0:
            # mirror once the write commits, off the hot path
            thread = threading.Thread(
                target=self._wait_and_mirror, args=(step,), daemon=True
            )
            self._mirror_threads = [
                t for t in self._mirror_threads if t.is_alive()
            ] + [thread]
            thread.start()
        return True

    def _write(self, step: int, sd: Dict[str, Any], meta: Dict,
               t0: float) -> None:
        import torch.distributed.checkpoint as dcp

        tmp = os.path.join(self.directory, f".tmp_{step}")
        os.makedirs(tmp, exist_ok=True)
        writer = dcp.FileSystemWriter(tmp, thread_count=WRITE_THREADS)
        if self._group is None:
            _dcp(dcp.save, sd, storage_writer=writer, no_dist=True)
        else:
            _dcp(dcp.save, sd, storage_writer=writer,
                 process_group=self._group)
        if self.rank == 0:
            # every rank's files are written once DCP's finish returns
            # on the coordinator: commit by one rename
            path = os.path.join(tmp, META_FILE)
            with open(path, "w") as f:
                json.dump(meta, f, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, self._step_dir(self.directory, step))
            fd = os.open(self.directory, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
            if self.max_to_keep:
                for old in self.all_steps()[:-self.max_to_keep]:
                    shutil.rmtree(self._step_dir(self.directory, old),
                                  ignore_errors=True)
        if self._group is not None:
            dist.barrier(group=self._group)
        self.commit_seconds[step] = time.monotonic() - t0
        logger.info("checkpoint %d committed to %s (%.1f s after save)",
                    step, self.directory, self.commit_seconds[step])

    def _wait_pending(self) -> None:
        """Block until the queued write (if any) commits; raise what it
        raised."""
        pending, self._pending = self._pending, None
        self._pending_step = None
        if pending is not None:
            pending.result()

    def wait(self, mirror_timeout: float = 120.0) -> bool:
        """Block until the queued save is on disk (and its staging
        mirror completes); raises when the save failed.

        Returns ``timed_out``: True when a staging-mirror thread was
        still alive after ``mirror_timeout`` — the host-DRAM mirror for
        some step never committed, so a storage-outage restore would
        fall back to an OLDER staged step. The primary copy is
        unaffected either way."""
        self._wait_pending()
        timed_out = False
        pending: list = []
        for thread in self._mirror_threads:
            if thread.is_alive():
                # a thread that already burned one full timeout is only
                # POLLED afterwards: back-to-back waits (the preemption
                # drain) must not stack stalls inside the grace window
                already_flagged = thread in self._mirror_timed_out
                thread.join(timeout=0.0 if already_flagged
                            else mirror_timeout)
            if thread.is_alive():
                timed_out = True
                pending.append(thread)
                if thread not in self._mirror_timed_out:
                    self._mirror_timed_out.add(thread)
                    self._c_mirror_timeouts.inc()
                    emit_event(EventKind.CKPT_MIRROR_TIMEOUT,
                               error_code="CKPT_MIRROR_TIMEOUT",
                               timeout_seconds=mirror_timeout)
                    logger.error(
                        "[CKPT_MIRROR_TIMEOUT] staging mirror thread %s "
                        "still running after %.0fs: the host-DRAM mirror "
                        "for its step never committed (primary "
                        "checkpoint unaffected)",
                        thread.name, mirror_timeout,
                    )
            else:
                self._mirror_timed_out.discard(thread)
        self._mirror_threads = pending
        self._mirror_timed_out &= set(pending)
        return timed_out

    # -- host-DRAM staging ----------------------------------------------------

    @staticmethod
    def _step_dir(root: str, step: int) -> str:
        return os.path.join(root, str(step))

    def _newer_step_committed(self, step: int) -> bool:
        """A committed step dir numbered above ``step``."""
        return any(s > step for s in self.all_steps())

    def _wait_and_mirror(self, step: int, deadline_s: float = 600.0):
        """Mirror once the step commits: the rename of the tmp dir to
        ``<root>/<step>`` is the commit marker this thread polls for."""
        step_dir = self._step_dir(self.directory, step)
        deadline = time.monotonic() + deadline_s
        try:
            while not os.path.isdir(step_dir):
                if time.monotonic() > deadline:
                    logger.warning(
                        "step %d never committed; skipping staging", step
                    )
                    return
                if self._newer_step_committed(step):
                    # commits are ordered, so a newer step with this one
                    # absent means max_to_keep already deleted it: the
                    # newer step's own mirror supersedes this one
                    logger.info(
                        "step %d superseded before mirroring; skipping",
                        step,
                    )
                    return
                time.sleep(0.1)
            self._mirror_to_staging(step)
        except Exception:  # noqa: BLE001 — staging is best-effort
            logger.exception("staging mirror for step %d failed", step)

    def _mirror_to_staging(self, step: int):
        src = self._step_dir(self.directory, step)
        if not os.path.isdir(src):
            return
        with self._mirror_lock:  # serialize: mirrors must not interleave
            # reclaim tmp dirs orphaned by a crash mid-copy
            try:
                for name in os.listdir(self._staging_root):
                    if name.startswith(".tmp_"):
                        shutil.rmtree(
                            os.path.join(self._staging_root, name),
                            ignore_errors=True,
                        )
            except OSError:
                pass
            newest = self.staged_step()
            if newest is not None and not self._staging_provenance_valid():
                # leftovers from a previous job at this checkpoint path
                logger.info("clearing stale staging mirror (provenance "
                            "mismatch)")
                self.clear_staging()
                newest = None
            if newest is not None and (
                newest > step
                or (newest == step and self._staged_digest_valid(step))
            ):
                return  # an equal-or-newer valid step is already staged
            # size gate: a checkpoint bigger than half the free tmpfs
            # would just burn read bandwidth and fail with ENOSPC
            try:
                ckpt_bytes = sum(
                    os.path.getsize(os.path.join(r, f))
                    for r, _d, files in os.walk(src) for f in files
                )
                free = shutil.disk_usage(self._staging_root).free
            except OSError:
                ckpt_bytes, free = 0, 0
            if ckpt_bytes and ckpt_bytes * 2 > free:
                logger.warning(
                    "skipping host-DRAM staging: checkpoint %.1f GB vs "
                    "%.1f GB free tmpfs", ckpt_bytes / 1e9, free / 1e9,
                )
                return
            tmp = os.path.join(self._staging_root, f".tmp_{step}")
            dst = self._step_dir(self._staging_root, step)
            shutil.rmtree(tmp, ignore_errors=True)
            t0 = time.monotonic()
            try:
                with span(SpanName.CKPT_MIRROR, step=step):
                    digest = self._dir_digest(src)
                    shutil.copytree(src, tmp)
                    shutil.rmtree(dst, ignore_errors=True)
                    os.rename(tmp, dst)
                with open(dst + ".digest", "w") as f:
                    f.write(digest)
                self._write_provenance()
                # keep only the newest staged step: DRAM is precious
                for name in os.listdir(self._staging_root):
                    base = name.split(".")[0]
                    if base.isdigit() and int(base) < step:
                        path = os.path.join(self._staging_root, name)
                        if os.path.isdir(path):
                            shutil.rmtree(path, ignore_errors=True)
                        else:
                            try:
                                os.remove(path)
                            except OSError:
                                pass
                mirror_s = time.monotonic() - t0
                self._h_mirror.observe(mirror_s)
                emit_event(EventKind.CKPT_MIRROR, step=step,
                           mirror_seconds=round(mirror_s, 3))
                logger.info("checkpoint %d staged to %s", step,
                            self._staging_root)
            except OSError as e:  # tmpfs full, races — never fail the job
                logger.warning("host-DRAM staging failed: %s", e)
                shutil.rmtree(tmp, ignore_errors=True)
                shutil.rmtree(dst, ignore_errors=True)

    def _primary_identity(self) -> str:
        """Identity token for staging provenance: the run identity when
        there is one (stable across loss of the primary root); else a
        uuid file created once per root, so an anonymous fresh job can
        never inherit a previous job's weights."""
        if self._run_identity:
            return f"job:{self._run_identity}"
        marker = os.path.join(self.directory, ".dlrover_ckpt_id")
        try:
            with open(marker) as f:
                return f.read().strip()
        except OSError:
            pass
        import uuid

        ident = uuid.uuid4().hex
        try:
            tmp = f"{marker}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(ident)
            os.rename(tmp, marker)
            with open(marker) as f:  # racing writers: reread the winner
                return f.read().strip()
        except OSError:
            return ""

    def _write_provenance(self):
        ident = self._primary_identity()
        if not ident:
            return
        try:
            with open(os.path.join(self._staging_root, "PROVENANCE"),
                      "w") as f:
                f.write(ident)
        except OSError:
            pass

    def _staging_provenance_valid(self) -> bool:
        try:
            with open(os.path.join(self._staging_root, "PROVENANCE")) as f:
                recorded = f.read().strip()
        except OSError:
            return False
        ident = self._primary_identity()
        return bool(ident) and ident == recorded

    def clear_staging(self):
        """Drop everything in the host-DRAM staging mirror."""
        try:
            for name in os.listdir(self._staging_root):
                path = os.path.join(self._staging_root, name)
                if os.path.isdir(path):
                    shutil.rmtree(path, ignore_errors=True)
                else:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        except OSError:
            pass

    @staticmethod
    def _dir_digest(path: str) -> str:
        """Cheap content-identity fingerprint of a step dir: every file's
        relpath, size, and mtime. Guards staged restores against a stale
        mirror left by a previous job at the same checkpoint path."""
        entries = []
        for root, _dirs, files in os.walk(path):
            for name in sorted(files):
                full = os.path.join(root, name)
                try:
                    st = os.stat(full)
                except OSError:
                    continue
                entries.append(
                    f"{os.path.relpath(full, path)}:{st.st_size}:"
                    f"{st.st_mtime_ns}"
                )
        return hashlib.sha256("\n".join(sorted(entries)).encode()).hexdigest()

    def _staged_digest_valid(self, step: int) -> bool:
        """The staged copy is trustworthy iff its recorded digest matches
        the primary step dir as it is now — or the primary step dir is
        gone (the storage-outage fast-restart case)."""
        dst = self._step_dir(self._staging_root, step)
        try:
            with open(dst + ".digest") as f:
                recorded = f.read().strip()
        except OSError:
            return False
        src = self._step_dir(self.directory, step)
        if not os.path.isdir(src):
            if not os.path.isdir(self.directory):
                # the primary root vanished after construction (the
                # constructor makes it): storage outage, the mirror is
                # the survivor
                logger.warning(
                    "adopting staged checkpoint step=%d: primary root "
                    "%s is GONE (storage outage path). If this is a "
                    "fresh run, these are a previous run's weights — "
                    "clear %s to start from scratch.",
                    step, self.directory, self._staging_root,
                )
                return True
            # root present but step missing: trust the mirror only for
            # the same run identity
            ok = self._staging_provenance_valid()
            if ok:
                logger.warning(
                    "adopting staged checkpoint step=%d under identity "
                    "'%s' with an EMPTY primary %s. A same-named fresh "
                    "run inherits the previous run's weights here — set "
                    "%s (or pass run_identity) to fence runs apart.",
                    step, self._primary_identity(), self.directory,
                    NodeEnv.RUN_ID,
                )
            return ok
        return self._dir_digest(src) == recorded

    def staged_step(self) -> Optional[int]:
        """Newest step available in the host-DRAM staging mirror."""
        if self._staging_root is None or not os.path.isdir(
            self._staging_root
        ):
            return None
        steps = [
            int(n) for n in os.listdir(self._staging_root) if n.isdigit()
        ]
        return max(steps) if steps else None

    # -- restore -------------------------------------------------------------

    def all_steps(self) -> List[int]:
        """Committed steps, oldest first."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_from_staging(self, state, layout: Layout = None
                             ) -> Optional[Dict[str, Any]]:
        """Warm-restart fast path: restore the newest staged step from
        the host-DRAM mirror without reading the primary directory.
        Returns None when nothing is staged or validation fails (on any
        rank) — callers fall back to ``restore()``."""
        if self._staging_root is None:
            step = None
        else:
            step = self.staged_step()
        ok = step is not None and self._staged_digest_valid(step)
        if not _agree(ok, self._group):
            return None
        self._wait_pending()  # the host buffers are shared with saves
        t0 = time.monotonic()
        try:
            with span(SpanName.CKPT_RESTORE, source="staging"):
                out = self._restore_from(self._staging_root, step, state,
                                         layout)
        except Exception:  # noqa: BLE001 — callers fall back to restore()
            logger.exception(
                "staging fast-path restore of step %d failed", step)
            return None
        restore_s = time.monotonic() - t0
        self._h_restore.observe(restore_s)
        self._c_restores.inc()
        emit_event(EventKind.CKPT_RESTORE, step=step,
                   restore_seconds=round(restore_s, 3), source="staging")
        logger.info("restored step %d from host-DRAM staging (no "
                    "primary round-trip)", step)
        return out

    def restore(self, state, step: Optional[int] = None,
                layout: Layout = None) -> Optional[Dict[str, Any]]:
        """Restore into ``state`` (a built TrainState, filled in place).

        Prefers the host-DRAM staged copy when it holds the requested
        step. Returns {"state", "meta", "shard_checkpoint", "step",
        "source"}, or None if no checkpoint exists.
        """
        self._wait_pending()
        t0 = time.monotonic()
        with span(SpanName.CKPT_RESTORE):
            out = self._restore_any(state, step, layout)
        if out is not None:
            restore_s = time.monotonic() - t0
            self._h_restore.observe(restore_s)
            self._c_restores.inc()
            emit_event(EventKind.CKPT_RESTORE, step=out["step"],
                       restore_seconds=round(restore_s, 3),
                       source=out["source"])
        return out

    def restore_params(self, step: Optional[int] = None
                       ) -> Optional[Tuple[int, Dict[str, torch.Tensor]]]:
        """The parameters alone of ``step`` (default: the newest) from
        the primary directory, whole, as host tensors by path: what a
        serving worker promotes (no optimizer moments are read). Returns
        ``(step, {path: tensor})``, or None when no checkpoint exists.
        Runs on one rank, whatever world wrote the step."""
        import torch.distributed.checkpoint as dcp

        self._wait_pending()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        reader = dcp.FileSystemReader(self._step_dir(self.directory, step))
        saved = reader.read_metadata().state_dict_metadata
        sd = {name: torch.empty(tuple(md.size), dtype=md.properties.dtype)
              for name, md in saved.items() if name.startswith("params/")}
        _dcp(dcp.load, sd, storage_reader=reader, no_dist=True)
        return step, {name[len("params/"):]: t for name, t in sd.items()}

    def _staged_ok(self, step: int) -> bool:
        return _agree(
            self._staging_root is not None
            and self.staged_step() == step
            and self._staged_digest_valid(step), self._group)

    def _restore_any(self, state, step: Optional[int],
                     layout: Layout) -> Optional[Dict[str, Any]]:
        staging_only = False
        explicit_step = step is not None
        if step is None:
            step = self.latest_step()
            if step is None and self._staging_root is not None:
                # primary storage lost entirely: the host-DRAM mirror is
                # the restore source of last resort (validated below);
                # failed validation means "no checkpoint", not a crash
                step = self.staged_step()
                staging_only = step is not None
        if self._group is not None:
            # every rank restores the same step (the coordinator's)
            box = [step, staging_only]
            dist.broadcast_object_list(box, src=0, group=self._group)
            step, staging_only = box
        if step is None:
            return None
        staged_already_failed = False
        if self._staged_ok(step):
            try:
                out = self._restore_from(self._staging_root, step, state,
                                         layout)
                logger.info(
                    "restored checkpoint step=%d from host-DRAM staging",
                    step,
                )
                return out
            except Exception:  # noqa: BLE001 — fall back to the real dir
                staged_already_failed = True
                logger.exception(
                    "staged restore failed; falling back to %s",
                    self.directory,
                )
        if staging_only:
            # the step exists only in staging and wasn't restorable: a
            # fresh job starts from scratch, not crash on a primary that
            # never held this step
            logger.warning(
                "staged step %d not restorable and absent from the "
                "primary; treating as no checkpoint", step,
            )
            return None
        try:
            out = self._restore_from(self.directory, step, state,
                                     layout)
        except Exception:  # noqa: BLE001 — torn/corrupt latest step
            if explicit_step:
                raise
            # the mirror may hold a readable copy of exactly this step
            # (the digest gate compares against the now-corrupt primary,
            # so it rejected the mirror for the wrong reason); provenance
            # must still match
            if not staged_already_failed and _agree(
                    self._staging_root is not None
                    and self.staged_step() == step
                    and self._staging_provenance_valid(), self._group):
                try:
                    out = self._restore_from(self._staging_root, step,
                                             state, layout)
                    logger.warning(
                        "primary step %d unreadable; restored the SAME "
                        "step from host-DRAM staging", step,
                    )
                    self._quarantine_step(step)
                    return out
                except Exception:  # noqa: BLE001 — mirror also bad
                    logger.exception(
                        "staged copy of step %d also unreadable", step)
            # the newest step is unreadable (a partial write, bit rot):
            # come back from the newest good step, not crash on the bad
            older = sorted((s for s in self.all_steps() if s < step),
                           reverse=True)
            logger.exception(
                "restore of latest step %d failed; trying older steps %s",
                step, older,
            )
            for s in older:
                try:
                    out = self._restore_from(self.directory, s, state,
                                             layout)
                    logger.warning(
                        "restored OLDER checkpoint step=%d (latest %d "
                        "unreadable)", s, step,
                    )
                    self._quarantine_step(step)
                    return out
                except Exception:  # noqa: BLE001 — keep walking back
                    logger.exception("restore of step %d also failed", s)
            raise
        logger.info("restored checkpoint step=%d from %s", step,
                    self.directory)
        return out

    def _quarantine_step(self, step: int) -> None:
        """Move an unreadable step dir aside after a successful
        fallback: left in place it keeps winning ``latest_step()`` and
        blocks re-saving that step number."""
        if self.rank != 0:
            return
        src = self._step_dir(self.directory, step)
        dst = os.path.join(self.directory,
                           f"corrupt-{step}-{int(time.time())}")
        try:
            os.replace(src, dst)
            logger.warning("quarantined unreadable step %d -> %s", step, dst)
        except OSError:
            logger.exception("could not quarantine step %d", step)

    def _restore_from(self, root: str, step: int, state,
                      layout: Layout) -> Dict[str, Any]:
        """Load ``root/step`` into host buffers, then into ``state``."""
        import torch.distributed.checkpoint as dcp

        path = self._step_dir(root, step)
        with open(os.path.join(path, META_FILE)) as f:
            meta = json.load(f)
        reader = dcp.FileSystemReader(path)
        saved = reader.read_metadata().state_dict_metadata
        live, _ = state_tensors(state)
        params = dict(_named_leaves(state.params))
        specs = {}
        for name, md in saved.items():
            if not name.startswith(("params/", "opt/", "wire_residual/")):
                continue
            path_key = _param_path(name)
            if path_key not in params:
                raise ValueError(f"checkpoint step {step} holds {name}, "
                                 "which the state has no parameter for")
            if name.startswith("wire_residual/") and name not in live:
                raise ValueError(
                    f"checkpoint step {step} holds the gradient wire's "
                    f"residual, which the state has none for (build it "
                    f"with the checkpoint's grad_precision)")
            shape = tuple(md.size)
            if self._group is not None and layout is not None:
                shape = layout.local_shape(path_key, shape)
            specs[name] = (shape, md.properties.dtype)
        for path_key, p in params.items():
            got = specs.get(f"params/{path_key}")
            if got is None or got[0] != tuple(p.shape):
                raise ValueError(
                    f"checkpoint step {step} does not match the state at "
                    f"{path_key}: {got and got[0]} vs {tuple(p.shape)}")
        missing = [name for name in live if name.startswith(
            "wire_residual/") and name not in specs]
        if missing:
            raise ValueError(f"checkpoint step {step} holds no gradient "
                             f"wire residual ({missing[0]}, ...), which "
                             f"the state carries")
        host = dict(self._host_buffers(specs, _pin_for(live)).tensors)
        sd = self._distributed(host, layout)
        if self._group is None:
            _dcp(dcp.load, sd, storage_reader=reader, no_dist=True)
        else:
            _dcp(dcp.load, sd, storage_reader=reader,
                 process_group=self._group)
        _fill_state(state, host, meta.get("opt_values", {}), step)
        return {
            "state": state,
            "meta": meta.get("meta") or {},
            "shard_checkpoint": meta.get("shard_checkpoint", ""),
            "step": step,
            "source": "staging" if root == self._staging_root else "primary",
        }

    def close(self):
        """Wait for the queued save, stop the writer, free the host
        buffers."""
        try:
            self._wait_pending()
        finally:
            self._writer.shutdown(wait=True)
            if self._arena is not None:
                self._arena.release()
                self._arena = None
