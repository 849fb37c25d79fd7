"""WSAM, weighted sharpness-aware minimization (port of
``dlrover_tpu/optimizers/wsam.py``).

A two-gradient optimizer: ``parallel.accelerate`` finds
``update_with_grad_fn`` and hands it ``grad_fn``, a whole forward and
backward at the parameters' current values on the step's batch. With
alpha = gamma / (1 - gamma):

  e_w    = rho * g / (||g|| + eps)            (adaptive: |p|^2-scaled)
  g_sam  = grad(loss)(w + e_w)
  coupled:   w <- base_step(w, (1 - alpha) g + alpha g_sam)
  decoupled: w <- base_step(w, g) - lr * alpha * (g_sam - g)

Under FSDP the norms sum each block over its group (``norm_groups``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from dlrover_tpu_torch.optimizers.clip import clip_grads_, global_norm
from dlrover_tpu_torch.optimizers.wrapper import OptimizerFn, Wrapped, build


class WsamOptimizer(Wrapped):
    """``base`` stepped on WSAM's gradient (see the module)."""

    def __init__(self, params, base: OptimizerFn, rho: float, gamma: float,
                 sam_eps: float, adaptive: bool, decouple: bool,
                 max_norm: Optional[float],
                 learning_rate: Union[float, Callable, None],
                 norm_groups: Optional[Sequence] = None):
        self._params = list(params)
        super().__init__(build(base, self._params, norm_groups))
        self.rho, self.sam_eps = rho, sam_eps
        self.alpha = gamma / (1.0 - gamma)
        self.adaptive, self.decouple = adaptive, decouple
        self.max_norm = max_norm
        self.learning_rate = learning_rate
        self.norm_groups = norm_groups
        # steps taken: the argument of a learning-rate schedule
        self.count = 0

    def step(self, closure=None):
        raise RuntimeError("WSAM takes two gradients a step: call "
                           "update_with_grad_fn(grad_fn) (parallel."
                           "accelerate does)")

    def _clip(self, grads):
        if self.max_norm is not None:
            clip_grads_(grads, self.max_norm, self.norm_groups)
        return grads

    @torch.no_grad()
    def update_with_grad_fn(self, grad_fn: Callable[[], list]) -> None:
        """One step: ``p.grad`` holds the gradient at the parameters;
        ``grad_fn()`` returns the gradients at their current values (a
        list in this optimizer's parameter order), which this sets to
        the perturbed point and back."""
        params = self._params
        grads = [p.grad for p in params]
        if self.adaptive:
            # ASAM: the radius in the weight-adaptive metric (|p| g), the
            # step along |p|^2 g
            norm = global_norm([p.abs() * g for p, g in zip(params, grads)],
                               self.norm_groups)
        else:
            norm = global_norm(grads, self.norm_groups)
        scale = self.rho / (norm + self.sam_eps)
        saved = [p.detach().clone() for p in params]
        for p, g in zip(params, grads):
            e = g * scale.to(g.dtype)
            p.add_(p.square() * e if self.adaptive else e)
        with torch.enable_grad():
            g_sam = list(grad_fn())
        for p, s in zip(params, saved):
            p.copy_(s)
        grads_c = self._clip([g.clone() for g in grads])
        g_sam_c = self._clip([g.clone() for g in g_sam])
        if not self.decouple:
            for p, g, gs in zip(params, grads_c, g_sam_c):
                p.grad = (1.0 - self.alpha) * g + self.alpha * gs
            self.base.step()
        else:
            # the base step on the plain gradient, the sharpness term as
            # a direct weight delta at the current learning rate
            for p, g in zip(params, grads_c):
                p.grad = g
            self.base.step()
            lr = (self.learning_rate(self.count)
                  if callable(self.learning_rate) else self.learning_rate)
            for p, g, gs in zip(params, grads_c, g_sam_c):
                p.sub_((lr * self.alpha) * (gs - g))
        self.count += 1


def wsam(base: OptimizerFn, rho: float = 0.05, gamma: float = 0.9,
         sam_eps: float = 1e-12, adaptive: bool = False,
         decouple: bool = True, max_norm: Optional[float] = None,
         learning_rate: Union[float, Callable, None] = None) -> OptimizerFn:
    """An optimizer factory wrapping ``base`` with WSAM.
    ``learning_rate`` (a value or a schedule of the step count) is
    needed in ``decouple`` mode: pass the base's."""
    if rho < 0.0:
        raise ValueError(f"Invalid rho, should be non-negative: {rho}")
    if decouple and learning_rate is None:
        raise ValueError(
            "decouple=True applies the sharpness term with the current "
            "learning rate; pass learning_rate= (value or schedule)")

    def make(params, norm_groups: Optional[Sequence] = None):
        return WsamOptimizer(params, base, rho, gamma, sam_eps, adaptive,
                             decouple, max_norm, learning_rate, norm_groups)

    return make
