"""Rematerialization policies (port of ``dlrover_tpu/ops/remat.py``).

The reference wraps a block in ``jax.checkpoint`` with a policy naming
what stays in memory. Here each policy name maps onto
``torch.utils.checkpoint`` (non-reentrant) around the block:

  "" / "none" / "everything_saveable"   no checkpoint
  "full" / "nothing_saveable"           save nothing, recompute the block
  "dots_saveable" / "checkpoint_dots"   selective checkpoint: keep the
        outputs of matrix products (aten mm/bmm/addmm/baddbmm),
        recompute everything else
  "dots_with_no_batch_dims_saveable"    the same without batched bmm

``dots_saveable`` (the ``LlamaConfig`` default) has no exact torch
counterpart; selective checkpointing on the product ops is the closest.
As in the reference, where ``dots_saveable`` recognises only
``dot_general`` and re-runs the Pallas call, the flash forward kernel is
not a product op here either: under it the backward re-runs the forward
kernel once per layer, so a step launches it twice per layer.

"attn_saveable" and "dots_and_attn_saveable" (save the named attention
output) wait for a later slice.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

_aten = torch.ops.aten
_DOTS = frozenset({_aten.mm.default, _aten.addmm.default,
                   _aten.bmm.default, _aten.baddbmm.default})
_DOTS_NO_BATCH = frozenset({_aten.mm.default, _aten.addmm.default})

_NO_REMAT = ("", "none", "everything_saveable")
_FULL = ("full", "nothing_saveable")
_SELECTIVE = {
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS_NO_BATCH,
    "checkpoint_dots_with_no_batch_dims": _DOTS_NO_BATCH,
}


def remat_enabled(policy) -> bool:
    return bool(policy) and policy not in _NO_REMAT


def _save_ops(ops, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in ops
            else CheckpointPolicy.PREFER_RECOMPUTE)


def apply_remat(fn: Callable, policy: str = "dots_saveable") -> Callable:
    """Wrap ``fn`` so its activations follow ``policy`` (see above)."""
    if not remat_enabled(policy):
        return fn
    if policy in _FULL:
        context_fn = None
    elif policy in _SELECTIVE:
        context_fn = functools.partial(
            create_selective_checkpoint_contexts,
            functools.partial(_save_ops, _SELECTIVE[policy]),
        )
    elif policy in ("attn_saveable", "dots_and_attn_saveable"):
        raise NotImplementedError(
            f"remat policy {policy!r} (saving the named attention output) "
            "is not ported yet"
        )
    else:
        raise ValueError(
            f"unknown remat policy {policy!r}; have "
            f"{sorted(_NO_REMAT + _FULL + tuple(_SELECTIVE))}"
        )

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False, **kwargs)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn, **kwargs)

    return wrapped
