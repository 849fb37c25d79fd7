"""Training-process bootstrap: env contract -> ``torch.distributed``
(port of ``dlrover_tpu/trainer/bootstrap.py``).

The launcher hands every worker its coordinates in the ``NodeEnv``
variables; :func:`init_worker` wires them into
``torch.distributed.init_process_group``. The backend is the caller's
choice, never inferred from a failure: ``"nccl"`` by default for a
CUDA device (one GPU per rank), ``"gloo"`` for the CPU. Several ranks
that share one GPU cannot use NCCL, which refuses two ranks on one
device; such a caller passes ``backend="gloo"`` and the device
(``"cuda:0"``).

:func:`reform_world` re-forms the world inside the running processes
(the in-process recovery path): every rank tears its group down, the
survivors join a new one of the new size from new coordinates, and a
rank that is not in it leaves. The processes join through a
``TCPStore`` this module keeps, so the next world can rendezvous under
a new ``restart_round`` prefix of the same store; a fresh store address
serves as well. The port's "devices" are the ranks of the group, one
device each.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("trainer.bootstrap")

# the store this process joined its group through, and whether it hosts
# it: the next world rendezvous there under a new round's prefix
_STORE: Optional[dist.Store] = None
_HOSTS_STORE = False
# the world this process is in (None before init_worker, or after it
# left one)
_WORKER: Optional["WorkerContext"] = None


@dataclass
class WorkerContext:
    process_id: int
    num_processes: int
    node_rank: int
    node_num: int
    local_rank: int
    local_world_size: int
    restart_round: int
    coordinator_addr: str
    master_client: None  # the master's client comes with A12
    device: torch.device
    backend: str

    @property
    def is_chief(self) -> bool:
        return self.process_id == 0


def init_worker(backend: Optional[str] = None,
                device: DeviceLike = None) -> WorkerContext:
    """Read the env contract and, for more than one process, join the
    process group at ``tcp://<coordinator>``.

    ``device``: this rank's device; default ``cuda:<LOCAL_RANK>``.
    ``backend``: default ``"nccl"`` on a CUDA device, ``"gloo"`` on the
    CPU.
    """
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None:
        device = f"cuda:{local_rank}"
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    process_id = int(os.environ.get(NodeEnv.PROCESS_ID, "0"))
    num_processes = int(os.environ.get(NodeEnv.NUM_PROCESSES, "1"))
    coordinator = os.environ.get(NodeEnv.COORDINATOR_ADDR, "")
    ctx = WorkerContext(
        process_id=process_id,
        num_processes=num_processes,
        node_rank=int(os.environ.get(NodeEnv.NODE_RANK, "0")),
        node_num=int(os.environ.get(NodeEnv.NODE_NUM, "1")),
        local_rank=local_rank,
        local_world_size=int(os.environ.get("LOCAL_WORLD_SIZE", "1")),
        restart_round=int(os.environ.get(NodeEnv.RESTART_ROUND, "0")),
        coordinator_addr=coordinator,
        master_client=None,
        device=dev,
        backend=backend,
    )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    global _WORKER
    _WORKER = ctx
    if num_processes > 1:
        if not coordinator:
            raise RuntimeError(
                f"{NodeEnv.NUM_PROCESSES}={num_processes} but "
                f"{NodeEnv.COORDINATOR_ADDR} is not set")
        logger.info("init_process_group(%s, tcp://%s, rank=%d, "
                    "world_size=%d) on %s", backend, coordinator,
                    process_id, num_processes, dev)
        _join(ctx, coordinator)
    return ctx


def _join(ctx: WorkerContext, store_addr: str = "") -> None:
    """Join the group of ``ctx`` (its rank, size and round) through the
    store at ``store_addr`` (new; rank 0 hosts it), or through the kept
    store when it is empty."""
    global _STORE, _HOSTS_STORE
    if store_addr:
        host, port = store_addr.rsplit(":", 1)
        _STORE = None  # a store this process hosted frees its port
        _HOSTS_STORE = ctx.process_id == 0
        _STORE = dist.TCPStore(host, int(port), ctx.num_processes,
                               is_master=_HOSTS_STORE,
                               timeout=dist.default_pg_timeout)
    dist.init_process_group(
        ctx.backend, store=dist.PrefixStore(f"round{ctx.restart_round}",
                                            _STORE),
        rank=ctx.process_id, world_size=ctx.num_processes)


def current_worker() -> Optional[WorkerContext]:
    """The world this process joined last (``init_worker`` or
    ``reform_world``); None before it joined one or after it left."""
    return _WORKER


def reform_world(new_rank: Optional[int], new_world: int,
                 coordinator: str = "") -> Optional[WorkerContext]:
    """Tear down this process's group and join a new one of
    ``new_world`` ranks as ``new_rank``; None for a rank that leaves
    (it returns None with no group). Every rank of the old world calls
    it, after the last collective of the old group.

    The new world meets at ``coordinator`` ("host:port", a fresh store
    that the new rank 0 hosts) or, when empty, in the store this process
    joined through, under the next ``restart_round``: the process that
    hosts that store must stay. Returns the new ``WorkerContext``; the
    ``NodeEnv`` variables follow it, so a later reader of the
    environment sees the new world."""
    global _WORKER
    ctx = _WORKER
    if ctx is None:
        raise RuntimeError("reform_world: this process joined no world "
                           "through init_worker")
    if new_rank is None and _HOSTS_STORE and not coordinator:
        raise ValueError(
            "this rank hosts the store the survivors meet in: it cannot "
            "leave unless the new world is given fresh coordinates")
    if dist.is_initialized():
        dist.destroy_process_group()
    if new_rank is None:
        logger.info("left the world (round %d)", ctx.restart_round)
        _WORKER = None
        return None
    if not 0 <= new_rank < new_world:
        raise ValueError(f"rank {new_rank} is not in a world of "
                         f"{new_world}")
    new = dataclasses.replace(
        ctx, process_id=new_rank, num_processes=new_world,
        restart_round=ctx.restart_round + 1,
        coordinator_addr=coordinator or ctx.coordinator_addr)
    os.environ.update({
        NodeEnv.PROCESS_ID: str(new.process_id),
        NodeEnv.NUM_PROCESSES: str(new.num_processes),
        NodeEnv.RESTART_ROUND: str(new.restart_round),
        NodeEnv.COORDINATOR_ADDR: new.coordinator_addr,
    })
    _WORKER = new
    if new_world > 1:
        if _STORE is None and not coordinator:
            raise RuntimeError("no store to meet in: the first world had "
                               "one process; give coordinates")
        logger.info("re-forming the world: rank %d of %d (round %d)",
                    new_rank, new_world, new.restart_round)
        _join(new, coordinator)
    return new
