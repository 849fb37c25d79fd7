"""Elastic checkpoint/resume on ``torch.distributed.checkpoint`` (port of
``dlrover_tpu/checkpoint``). Peer replication comes with a later slice.
"""

from dlrover_tpu_torch.checkpoint.manager import (
    CheckpointInterval,
    ElasticCheckpointManager,
    HostSnapshot,
)

__all__ = [
    "CheckpointInterval",
    "ElasticCheckpointManager",
    "HostSnapshot",
]
