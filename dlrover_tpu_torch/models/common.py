"""Shared building blocks for the model families (port of
``dlrover_tpu/models/common.py``)."""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch

# (path, leaf) -> the leaf an init keeps: a model's init hands each leaf
# to it as soon as it is drawn (``parallel.accelerate`` keeps a rank's
# block of a sharded leaf, so the init holds one full leaf at a time)
KeepLeaf = Callable[[str, torch.Tensor], torch.Tensor]


def keep_all(path: str, leaf: torch.Tensor) -> torch.Tensor:
    """The default ``KeepLeaf``: every leaf whole."""
    return leaf


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, scale=None) -> torch.Tensor:
    """Fan-in-scaled normal initializer (scale defaults to
    1/sqrt(fan_in), fan_in = second-to-last dim), drawn on the
    generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    return torch.randn(tuple(shape), generator=generator, dtype=dtype,
                       device=generator.device) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float):
    """LayerNorm with f32 statistics; the normalised value is cast to
    x's dtype before the scale and bias (both cast to x's dtype too), as
    the reference orders it."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return normed.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """RMSNorm with f32 statistics; the normalised value is cast to x's
    dtype BEFORE the multiply by the scale (cast to x's dtype too), the
    reference's order, which bf16 parity depends on."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] segment ids -> each token's position within its segment
    (RoPE restarts per packed document); ``torch.cummax`` in place of
    the reference's ``lax.cummax``."""
    b, s = segment_ids.shape
    idx = torch.arange(s, device=segment_ids.device).expand(b, s)
    is_start = torch.ones((b, s), dtype=torch.bool,
                          device=segment_ids.device)
    is_start[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    starts = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - starts


def cast_floats(tree, dtype: torch.dtype):
    """Cast floating leaves of a nested dict to ``dtype`` (params stored
    f32, computed bf16); other leaves pass through."""
    if isinstance(tree, dict):
        return {k: cast_floats(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if tree.is_floating_point() else tree


def tree_map(fn, tree):
    """``fn`` applied to each leaf of a nested dict, same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def param_count(shapes: Dict) -> int:
    """Total parameter count of a nested dict of shapes."""
    if isinstance(shapes, dict):
        return sum(param_count(v) for v in shapes.values())
    return math.prod(shapes)
