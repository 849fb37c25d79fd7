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
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("trainer.bootstrap")


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
    if num_processes > 1:
        if not coordinator:
            raise RuntimeError(
                f"{NodeEnv.NUM_PROCESSES}={num_processes} but "
                f"{NodeEnv.COORDINATOR_ADDR} is not set")
        logger.info("init_process_group(%s, tcp://%s, rank=%d, "
                    "world_size=%d) on %s", backend, coordinator,
                    process_id, num_processes, dev)
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", rank=process_id,
            world_size=num_processes)
    return ctx
