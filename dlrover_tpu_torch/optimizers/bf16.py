"""bf16 training with fp32 master weights (port of
``dlrover_tpu/optimizers/bf16.py``).

The wrapper keeps an fp32 master of each half-precision parameter,
steps the base optimizer on the masters with the gradients cast to f32,
and copies each master back cast to its parameter's dtype, so updates
too small for bf16 still accumulate. Full-precision parameters are their
own masters. The state a checkpoint reads by parameter
(``opt.state[p]``) is the base's slots of its master plus the master
itself (``"master"``).
"""

from __future__ import annotations

from collections.abc import MutableMapping
from typing import Dict, Optional, Sequence

import torch

from dlrover_tpu_torch.optimizers.wrapper import OptimizerFn, Wrapped, build

_HALF = (torch.bfloat16, torch.float16)


class _MasterState(MutableMapping):
    """``opt.state`` by parameter: the base's slots of the parameter's
    master, and the master under "master" where it is a copy."""

    def __init__(self, base_state, masters: Dict[torch.Tensor, torch.Tensor]):
        self._base = base_state
        self._masters = masters

    def _key(self, p):
        return self._masters.get(p, p)

    def __getitem__(self, p):
        m = self._key(p)
        if m not in self._base and m is p:
            raise KeyError(p)
        out = dict(self._base.get(m, {}))
        if m is not p:
            out["master"] = m
        return out

    def __setitem__(self, p, slots):
        m = self._key(p)
        slots = dict(slots)
        master = slots.pop("master", None)
        if master is not None and m is not p:
            with torch.no_grad():
                m.copy_(master)
        self._base[m] = slots

    def __delitem__(self, p):
        del self._base[self._key(p)]

    def __iter__(self):
        back = {m: p for p, m in self._masters.items()}
        return (back.get(m, m) for m in list(self._base))

    def __len__(self):
        return len(self._base)

    def clear(self):
        self._base.clear()


class Bf16MasterWeights(Wrapped):
    def __init__(self, params, base: OptimizerFn,
                 norm_groups: Optional[Sequence] = None):
        self._params = list(params)
        self.masters = {p: p.detach().float().clone() for p in self._params
                        if p.dtype in _HALF}
        masters = [self.masters.get(p, p) for p in self._params]
        super().__init__(build(base, masters, norm_groups))
        self.state = _MasterState(self.base.state, self.masters)

    @property
    def master(self):
        """The fp32 master of each parameter (the parameter itself when
        it is full precision), in order."""
        return [self.masters.get(p, p) for p in self._params]

    @torch.no_grad()
    def step(self, closure=None):
        for p, m in self.masters.items():
            m.grad = None if p.grad is None else p.grad.float()
        out = self.base.step(closure)
        for p, m in self.masters.items():
            p.copy_(m.to(p.dtype))
        return out


def bf16_master_weights(base: OptimizerFn) -> OptimizerFn:
    """An optimizer factory: ``base`` stepping fp32 masters of the
    half-precision parameters (others pass through)."""

    def make(params, norm_groups: Optional[Sequence] = None):
        return Bf16MasterWeights(params, base, norm_groups)

    return make
