"""Dynamic loss scaling (port of
``dlrover_tpu/optimizers/grad_scaler.py``).

The reference's contract as functions over an explicit state: scale the
loss up, check the gradients for inf/nan, back off on an overflow (the
step is skipped by the caller), grow after a streak of finite steps.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from dlrover_tpu_torch.models.common import tree_leaves, tree_map


class GradScalerState(NamedTuple):
    scale: torch.Tensor  # f32 scalar
    growth_tracker: torch.Tensor  # consecutive finite steps, int32


def all_finite(tree: Any) -> torch.Tensor:
    """Scalar bool: every leaf of the nested dict is finite."""
    leaves = tree_leaves(tree) if isinstance(tree, dict) else [tree]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(t).all() for t in leaves]).all()


class DynamicGradScaler:
    """``torch.amp.GradScaler``'s semantics, functionally::

        state = scaler.init()
        loss = scaler.scale(loss, state)       # before the backward
        grads, finite = scaler.unscale(grads, state)
        state = scaler.update(state, finite)   # step only where finite
    """

    def __init__(self, init_scale: float = 2.0 ** 16,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000, max_scale: float = 2.0 ** 24):
        self.init_scale = init_scale
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.max_scale = max_scale

    def init(self, device=None) -> GradScalerState:
        return GradScalerState(
            scale=torch.tensor(self.init_scale, dtype=torch.float32,
                               device=device),
            growth_tracker=torch.zeros((), dtype=torch.int32,
                                       device=device))

    def scale(self, loss: torch.Tensor, state: GradScalerState):
        return loss * state.scale.to(loss.dtype)

    def unscale(self, grads: Any, state: GradScalerState
                ) -> Tuple[Any, torch.Tensor]:
        inv = (1.0 / state.scale).float()
        unscaled = tree_map(lambda g: (g.float() * inv).to(g.dtype), grads)
        return unscaled, all_finite(unscaled)

    def update(self, state: GradScalerState,
               grads_finite: torch.Tensor) -> GradScalerState:
        grew = state.growth_tracker + 1 >= self.growth_interval
        grown = torch.where(grew, torch.clamp(
            state.scale * self.growth_factor, max=self.max_scale),
            state.scale)
        new_scale = torch.where(grads_finite, grown,
                                state.scale * self.backoff_factor)
        zero = torch.zeros_like(state.growth_tracker)
        new_tracker = torch.where(
            grads_finite, torch.where(grew, zero, state.growth_tracker + 1),
            zero)
        return GradScalerState(scale=new_scale,
                               growth_tracker=new_tracker.to(torch.int32))
