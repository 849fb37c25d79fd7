"""Block-scaled fp8 quantization, the wire format of the low-precision
MoE dispatch (port of the fp8 half of ``dlrover_tpu/ops/quantize.py``).

Each row's channels split into blocks of ``QUANT_BLOCK``; every block
ships as e4m3 values plus one f32 scale, ~0.56x the bytes of bf16.
Everything here acts per row, so quantization commutes with the row
exchanges (a permutation of rows): quantize -> exchange -> dequantize
is bitwise equal to quantize -> dequantize -> exchange, which is what
the "fp8" vs "fp8_qdq" tests pin.

Zero blocks: the scale clamps to 1.0 and the values quantize to exact
zeros, so the dispatch's zero-sentinel pad rows survive untouched.
Denormals: a block whose max sits below e4m3's smallest normal
up-scales into range (scale = amax / FP8_MAX < 1); a deep-denormal
block's scale floors at the smallest normal f32, so the division
never mints inf.

The int8 half below is the serving tier's KV-page storage
(``serving.kv_cache``): the same block geometry, int8 values rounded
half to even (``torch.round``, as ``jnp.round``) and clamped to +-127.

The last part is the gradient wire (``parallel.accelerate``):
``error_feedback_qdq`` quantizes a gradient leaf with the last step's
decompression error added back, so the errors telescope instead of
accumulating.
"""

from __future__ import annotations

import torch

# channels per scale block (the MX convention's 32); resolve_quant_block
# shrinks it to the largest divisor of the channel dim
QUANT_BLOCK = 32

# e4m3fn: the widest-range fp8 (no inf, max 448)
WIRE_DTYPE = torch.float8_e4m3fn

FP8_MAX = float(torch.finfo(WIRE_DTYPE).max)  # 448.0

# "bf16" = no quantization (the exchange carries the compute dtype);
# "fp8" = e4m3 values + f32 scales on the wire; "fp8_qdq" = the
# reference: quantize -> dequantize at every wire crossing, with the
# exchange itself in full precision (bitwise the same numbers as "fp8")
PRECISIONS = ("bf16", "fp8", "fp8_qdq")

_TINY = torch.finfo(torch.float32).tiny


def resolve_quant_block(channels: int, want: int = QUANT_BLOCK) -> int:
    """The largest divisor of ``channels`` that is <= ``want``."""
    want = max(1, min(int(want), int(channels)))
    for cand in range(want, 0, -1):
        if channels % cand == 0:
            return cand
    return 1


def quantize_block_scaled(x: torch.Tensor, block: int = 0):
    """``x [..., D]`` -> ``(values [..., D] e4m3, scales [..., D/block]
    f32)``. Per block ``scale = max|x| / FP8_MAX`` (floored at the
    smallest normal f32), 1.0 for an all-zero block; the division runs
    in f32 whatever x's dtype, so the encode rounds once."""
    d = x.shape[-1]
    b = block or resolve_quant_block(d)
    if d % b:
        raise ValueError(
            f"quantize_block_scaled: block {b} does not divide the "
            f"channel dim {d} (use resolve_quant_block)"
        )
    xb = x.float().reshape(x.shape[:-1] + (d // b, b))
    amax = xb.abs().amax(dim=-1)
    scales = torch.where(amax > 0, torch.clamp(amax / FP8_MAX, min=_TINY),
                         torch.ones_like(amax))
    values = (xb / scales[..., None]).to(WIRE_DTYPE)
    return values.reshape(x.shape), scales


def dequantize_block_scaled(values: torch.Tensor, scales: torch.Tensor,
                            dtype: torch.dtype = torch.float32):
    """``values * scales`` per block: one f32 multiply (e4m3 -> f32 is
    exact), cast to ``dtype`` last. The dequant-in-kernel grouped matmul
    (B6) computes exactly this product."""
    d = values.shape[-1]
    nb = scales.shape[-1]
    vb = values.float().reshape(values.shape[:-1] + (nb, d // nb))
    return (vb * scales[..., None]).reshape(values.shape).to(dtype)


def qdq(x: torch.Tensor, block: int = 0) -> torch.Tensor:
    """quantize -> dequantize (f32 out): the "fp8_qdq" transform."""
    return dequantize_block_scaled(*quantize_block_scaled(x, block))


# -- int8 storage (the serving tier's KV-cache format) -----------------------

# KV-cache storage precisions (``serving.kv_cache`` resolves the knob):
# "f32"/"bf16" = pages stored in that dtype; "int8" = int8 values + f32
# per-block scales (~1/4 of an f32 page)
KV_PRECISIONS = ("f32", "bf16", "int8")

INT8_MAX = 127.0


def quantize_block_scaled_int8(x: torch.Tensor, block: int = 0):
    """``x [..., D]`` -> ``(values [..., D] int8, scales [..., D/block]
    f32)``: per block ``scale = max|x| / 127`` (floored at the smallest
    normal f32), 1.0 for an all-zero block; values rounded half to even
    and clamped to +-127, so an outlier at the block max lands on
    +-127."""
    d = x.shape[-1]
    b = block or resolve_quant_block(d)
    if d % b:
        raise ValueError(
            f"quantize_block_scaled_int8: block {b} does not divide the "
            f"channel dim {d} (use resolve_quant_block)"
        )
    xb = x.float().reshape(x.shape[:-1] + (d // b, b))
    amax = xb.abs().amax(dim=-1)
    scales = torch.where(amax > 0, torch.clamp(amax / INT8_MAX, min=_TINY),
                         torch.ones_like(amax))
    values = torch.clamp(torch.round(xb / scales[..., None]), -INT8_MAX,
                         INT8_MAX).to(torch.int8)
    return values.reshape(x.shape), scales


def dequantize_block_scaled_int8(values: torch.Tensor, scales: torch.Tensor,
                                 dtype: torch.dtype = torch.float32):
    """``values * scales`` per block in f32 (int8 -> f32 is exact), cast
    to ``dtype`` last."""
    d = values.shape[-1]
    nb = scales.shape[-1]
    vb = values.float().reshape(values.shape[:-1] + (nb, d // nb))
    return (vb * scales[..., None]).reshape(values.shape).to(dtype)


# -- the gradient wire ---------------------------------------------------------

# gradient-path precisions (``parallel.accelerate``): a quantized
# gradient is not dequant-exact training, so its error is carried
# forward ("fp8", error feedback) or dropped ("fp8_nofb", the control the
# telescoping tests compare against; never train with it)
GRAD_PRECISIONS = ("bf16", "fp8", "fp8_nofb")


def error_feedback_qdq(g: torch.Tensor, residual: torch.Tensor,
                       feedback: bool = True, block: int = 0):
    """One error-feedback step on one gradient leaf: ``(g_quantized,
    new_residual)``. The residual (the last step's decompression error,
    zeros at first) is added back into ``g`` before the quantize, and
    the new residual is this quantize's error, so over steps the sum of
    the applied gradients is the sum of the raw ones minus the last
    residual. ``feedback=False`` quantizes the raw ``g`` and drops the
    error. ``block``: the scale block (default: from ``g``'s last dim;
    a rank's block of a leaf passes its global leaf's)."""
    eff = g + residual.to(g.dtype) if feedback else g
    gq = dequantize_block_scaled(*quantize_block_scaled(eff, block),
                                 g.dtype)
    new_residual = eff - gq if feedback else torch.zeros_like(residual)
    return gq, new_residual.to(residual.dtype)
