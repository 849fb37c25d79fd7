"""The worker environment contract (port of the ``NodeEnv`` part of
``dlrover_tpu/common/constants.py``).

The launcher hands every training process its coordinates in these
variables; ``trainer.bootstrap.init_worker`` reads them, and the
checkpoint manager's staging provenance reads the job's identity.
"""

from __future__ import annotations


class NodeEnv:
    """Env-var contract between the launcher and training processes."""

    JOB_NAME = "DLROVER_TPU_JOB_NAME"
    # unique per job launch (name + launch epoch): stable across worker
    # relaunches within one job instance, new when a fresh job reuses
    # the name; the checkpoint staging provenance prefers it over the
    # bare job name
    RUN_ID = "DLROVER_TPU_RUN_ID"

    NODE_RANK = "DLROVER_TPU_NODE_RANK"
    NODE_NUM = "DLROVER_TPU_NODE_NUM"
    # handed to each training process at (re-)rendezvous
    COORDINATOR_ADDR = "DLROVER_TPU_COORDINATOR_ADDR"
    PROCESS_ID = "DLROVER_TPU_PROCESS_ID"
    NUM_PROCESSES = "DLROVER_TPU_NUM_PROCESSES"
    RESTART_ROUND = "DLROVER_TPU_RESTART_ROUND"
