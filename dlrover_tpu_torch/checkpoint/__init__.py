"""Elastic checkpoint/resume on ``torch.distributed.checkpoint`` (port of
``dlrover_tpu/checkpoint``), and the snapshot regrouped for a planned
change of world (``regroup``). Peer replication needs the RPC layer and
the master's plan, and comes with them (ROADMAP A12).
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
