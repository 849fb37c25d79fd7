"""The optimizer wrapper the port's optimizers share.

The reference's transforms wrap an optax transformation; here each wraps
a ``torch.optim`` factory (``parallel.accelerate``'s contract:
``factory(params) -> torch.optim.Optimizer``). A wrapper is itself an
optimizer whose ``param_groups`` and ``state`` are its base's, so a
checkpoint (``checkpoint.manager``), a snapshot and the trainer see one
optimizer and its base's slots, as with an unwrapped one.
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence

import torch

OptimizerFn = Callable[..., torch.optim.Optimizer]


def build(factory: OptimizerFn, params: list,
          norm_groups: Optional[Sequence] = None) -> torch.optim.Optimizer:
    """``factory(params)``, handed ``norm_groups`` where it takes them."""
    if norm_groups is not None and "norm_groups" in inspect.signature(
            factory).parameters:
        return factory(params, norm_groups=norm_groups)
    return factory(params)


class Wrapped(torch.optim.Optimizer):
    """An optimizer around ``base``, sharing its groups and state."""

    def __init__(self, base: torch.optim.Optimizer):
        super().__init__(base.param_groups, {})
        self.base = base
        self.param_groups = base.param_groups
        self.state = base.state
