"""Clipping by the global norm (port of
``dlrover_tpu/optimizers/clip.py``).

The reference sums the squared norm with ``lax.psum`` over the mesh axes
where each shard sees only its slice (``shard_map``). Here a rank holds
its block of each sharded leaf (``parallel.accelerate``), and
``norm_groups`` names, for each tensor, the process group its block is
split over (None: the whole tensor on every rank): each group's squares
are all-reduced over it once, as ``accelerate`` sums the reported norm.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.optimizers.wrapper import OptimizerFn, Wrapped, build


def _leaves(tensors) -> List[torch.Tensor]:
    return tree_leaves(tensors) if isinstance(tensors, dict) \
        else list(tensors)


def global_norm(tensors, norm_groups: Optional[Sequence] = None
                ) -> torch.Tensor:
    """The L2 norm over every tensor (a nested dict or a sequence; None
    entries are skipped), squares summed in f32. ``norm_groups``: one
    per tensor, the group its block is split over; each group's sum of
    squares is all-reduced over it (in the order the groups first
    appear, the same on every rank)."""
    leaves = _leaves(tensors)
    groups = list(norm_groups) if norm_groups is not None \
        else [None] * len(leaves)
    if len(groups) != len(leaves):
        raise ValueError(f"{len(groups)} norm groups for {len(leaves)} "
                         f"tensors")
    present = [(t, g) for t, g in zip(leaves, groups) if t is not None]
    device = present[0][0].device if present else torch.device("cpu")
    total = torch.zeros((), device=device)
    split: Dict[int, list] = {}
    for t, group in present:
        sq = t.float().square().sum()
        if group is None:
            total = total + sq
        else:
            entry = split.setdefault(id(group), [group, torch.zeros(
                (), device=device)])
            entry[1] = entry[1] + sq
    for group, sq in split.values():
        total = total + ring.all_reduce_(sq, group)
    return torch.sqrt(total)


def clip_grads_(grads, max_norm: float,
                norm_groups: Optional[Sequence] = None) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-12))``
    (in f32, cast back to each tensor's dtype); returns the norm before
    the clip."""
    leaves = _leaves(grads)
    norm = global_norm(leaves, norm_groups)
    factor = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    with torch.no_grad():
        for g in leaves:
            if g is not None:
                g.copy_((g.float() * factor).to(g.dtype))
    return norm


class ClipByGlobalNorm(Wrapped):
    """``base`` stepping on the gradients clipped to ``max_norm`` by
    their global norm."""

    def __init__(self, params, base: OptimizerFn, max_norm: float,
                 norm_groups: Optional[Sequence] = None):
        params = list(params)
        super().__init__(build(base, params, norm_groups))
        self._params = params
        self.max_norm = float(max_norm)
        self.norm_groups = norm_groups

    @torch.no_grad()
    def step(self, closure=None):
        clip_grads_([p.grad for p in self._params], self.max_norm,
                    self.norm_groups)
        return self.base.step(closure)


def clip_by_global_norm(max_norm: float, base: OptimizerFn) -> OptimizerFn:
    """An optimizer factory: ``base``'s optimizer on gradients clipped
    to ``max_norm`` (``optax.chain(clip_by_global_norm(max_norm),
    base)``'s updates); under FSDP the norm sums each block over its
    group (``norm_groups``, handed in by ``parallel.accelerate``)."""

    def make(params, norm_groups: Optional[Sequence] = None):
        return ClipByGlobalNorm(params, base, max_norm, norm_groups)

    return make
