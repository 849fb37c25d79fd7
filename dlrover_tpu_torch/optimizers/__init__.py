"""Optimizers (port of ``dlrover_tpu/optimizers/``): WSAM two-gradient
updates, fp32 master weights, dynamic loss scaling and clipping by the
global norm, as ``torch.optim`` optimizers and plain functions with the
reference's names and semantics."""

from dlrover_tpu_torch.optimizers.bf16 import bf16_master_weights
from dlrover_tpu_torch.optimizers.clip import (
    clip_by_global_norm,
    clip_grads_,
    global_norm,
)
from dlrover_tpu_torch.optimizers.grad_scaler import (
    DynamicGradScaler,
    GradScalerState,
    all_finite,
)
from dlrover_tpu_torch.optimizers.wsam import WsamOptimizer, wsam

__all__ = [
    "bf16_master_weights",
    "clip_by_global_norm",
    "clip_grads_",
    "global_norm",
    "DynamicGradScaler",
    "GradScalerState",
    "all_finite",
    "WsamOptimizer",
    "wsam",
]
