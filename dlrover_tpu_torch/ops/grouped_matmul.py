"""Grouped matmul for Hopper: the dropless-MoE expert compute, two
hand-written CUDA kernels behind a ``torch.autograd.Function``.

Port of ``dlrover_tpu/ops/grouped_matmul.py``.
``y[i] = x[i] @ w[tile_expert[i // block_t]]``: rows are sorted by
expert and every expert's group is padded to whole row tiles, so each
tile of ``block_t`` rows belongs to one expert. The kernels, in
``dlrover_tpu_torch/csrc``:

  grouped_matmul_fwd  (B4) y = x @ w[e] per row tile, and, reading w
                      transposed in place, dx = dy @ w[e]^T
  grouped_matmul_dw   (B5) dw[e] = sum over e's row tiles of x^T dy, f32
  grouped_matmul_fwd_quant
                      (B6) y = dequant(values, scales) @ w[e], f32: the
                      fp8 rows of the expert-parallel wire, dequantized
                      in the kernel, bitwise equal to dequantizing
                      first and running B4's f32 path

Each has a wrapper here that launches it on a CUDA tensor (or raises:
there is no fallback), a plain PyTorch version that the wrapper uses for
tensors on the CPU, and a launch counter, ``<wrapper>.launches``.

The TPU tiling rule (``_pick_block``) does not apply: the kernels mask
ragged D and F edges. ``block_f`` is kept for API parity and does not
change the result; ``block_t`` is the grouping contract and must be a
multiple of the kernels' 128-row tile on the card.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from dlrover_tpu_torch.ops import kernel_build
from dlrover_tpu_torch.ops.quantize import (
    WIRE_DTYPE,
    dequantize_block_scaled,
)

# where each kernel lives and which TPU kernel it replaces
KERNELS: Dict[str, Dict[str, str]] = {
    "grouped_matmul_fwd": {
        "source": "dlrover_tpu_torch/csrc/grouped_matmul_fwd.cu",
        "replaces": "dlrover_tpu/ops/grouped_matmul.py:61",
    },
    "grouped_matmul_dw": {
        "source": "dlrover_tpu_torch/csrc/grouped_matmul_dw.cu",
        "replaces": "dlrover_tpu/ops/grouped_matmul.py:70",
    },
    "grouped_matmul_fwd_quant": {
        "source": "dlrover_tpu_torch/csrc/grouped_matmul_fwd_quant.cu",
        "replaces": "dlrover_tpu/ops/grouped_matmul.py:90",
    },
}

KERNEL_ROWS = 128  # the kernels' row tile: block_t must be a multiple
_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: x, w|dy, tile_expert, out, then the int shape arguments,
# then the stream
_ARGTYPES = {
    # rows, D (x's width), F (the output width), E, block_t, transpose_w
    "grouped_matmul_fwd": [_P] * 4 + [_I] * 6 + [_P],
    # rows, D, F, E, num_tiles, block_t
    "grouped_matmul_dw": [_P] * 4 + [_I] * 6 + [_P],
    # values, scales, w, tile_expert, y, then rows, D, F, E, the scale
    # blocks per row, block_t
    "grouped_matmul_fwd_quant": [_P] * 5 + [_I] * 6 + [_P],
}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _row_experts(tile_expert: torch.Tensor, block_t: int) -> torch.Tensor:
    return tile_expert.long().repeat_interleave(block_t)


# -- plain versions (the CPU path, and what the kernels are held to) --------


def grouped_matmul_fwd_plain(x, w, tile_expert, block_t: int,
                             transpose_w: bool = False):
    """B4's function, one expert's rows at a time: ``x @ w[e]`` (or
    ``x @ w[e]^T``), f32 accumulation, output in x's dtype."""
    rows = _row_experts(tile_expert, block_t)
    out_width = w.shape[1] if transpose_w else w.shape[2]
    y = torch.zeros((x.shape[0], out_width), dtype=torch.float32,
                    device=x.device)
    for e in range(w.shape[0]):
        sel = rows == e
        we = w[e].float()
        y[sel] = x[sel].float() @ (we.t() if transpose_w else we)
    return y.to(x.dtype)


def grouped_matmul_dw_plain(x, dy, tile_expert, num_experts: int,
                            block_t: int):
    """B5's function: ``dw[e] = x_e^T @ dy_e`` over expert e's rows, f32;
    zeros for an expert that owns no row."""
    rows = _row_experts(tile_expert, block_t)
    dw = torch.zeros((num_experts, x.shape[1], dy.shape[1]),
                     dtype=torch.float32, device=x.device)
    for e in range(num_experts):
        sel = rows == e
        dw[e] = x[sel].float().t() @ dy[sel].float()
    return dw


def grouped_matmul_fwd_quant_plain(values, scales, w, tile_expert,
                                   block_t: int):
    """B6's function: dequantize, then B4's plain product, f32 out."""
    return grouped_matmul_fwd_plain(dequantize_block_scaled(values, scales),
                                    w.float(), tile_expert, block_t)


# -- kernel wrappers ---------------------------------------------------------


def _check_shapes(name: str, x, other, tile_expert, block_t: int,
                  width: int) -> None:
    """Shapes the kernels index raw pointers by: checked on every path.
    ``width`` is the size x's second dim must have."""
    if x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"{name}: x {tuple(x.shape)} does not match "
                         f"{tuple(other.shape)}")
    if block_t <= 0 or x.shape[0] % block_t:
        raise ValueError(f"{name}: {x.shape[0]} rows are not whole tiles "
                         f"of block_t={block_t}")
    if tile_expert.shape != (x.shape[0] // block_t,):
        raise ValueError(f"{name}: tile_expert {tuple(tile_expert.shape)} "
                         f"is not one entry per tile "
                         f"({x.shape[0] // block_t})")


def _kernel_suffix(name: str, tile_expert, block_t: int, *inputs) -> str:
    """What the kernels themselves take; returns the dtype suffix of the
    C entry point."""
    dtype = inputs[0].dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        f"(bfloat16 or float32)")
    for t in inputs:
        if t.dtype != dtype:
            raise TypeError(f"{name}: mixed dtypes {dtype} and {t.dtype}")
        if t.shape[-1] % 8:
            raise ValueError(f"{name}: inner dims must be multiples of 8 "
                             f"(16-byte rows); got {tuple(t.shape)}")
    for t in (*inputs, tile_expert):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")
    if tile_expert.dtype != torch.int32:
        raise TypeError(f"{name}: tile_expert must be int32")
    if block_t % KERNEL_ROWS:
        raise ValueError(f"{name}: block_t={block_t} must be a multiple of "
                         f"the kernel's {KERNEL_ROWS}-row tile")
    return _SUFFIX[dtype]


def grouped_matmul_fwd(x, w, tile_expert, block_t: int = 128,
                       transpose_w: bool = False):
    """B4: ``[Tp, F]`` (``[Tp, D]`` with ``transpose_w``) in x's dtype.
    ``transpose_w`` reads w ``[E, D, F]`` as ``[E, F, D]`` in place, for
    dx; wᵀ is never materialised."""
    e, d, f = w.shape
    _check_shapes("grouped_matmul_fwd", x, w, tile_expert, block_t,
                  f if transpose_w else d)
    if kernel_build.on_cpu("grouped matmul", x, w, tile_expert):
        return grouped_matmul_fwd_plain(x, w, tile_expert, block_t,
                                        transpose_w)
    suffix = _kernel_suffix("grouped_matmul_fwd", tile_expert, block_t, x, w)
    y = torch.empty((x.shape[0], d if transpose_w else f), dtype=x.dtype,
                    device=x.device)
    kernel_build.launch(
        "grouped_matmul_fwd", suffix, _ARGTYPES["grouped_matmul_fwd"],
        x.device, x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(),
        y.data_ptr(), x.shape[0], d, f, e, block_t, int(transpose_w))
    grouped_matmul_fwd.launches += 1
    return y


def grouped_matmul_dw(x, dy, tile_expert, num_experts: int,
                      block_t: int = 128):
    """B5: ``[E, D, F]`` f32, zeros for an expert that owns no tile."""
    _check_shapes("grouped_matmul_dw", x, dy, tile_expert, block_t,
                  x.shape[-1])
    if dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"grouped_matmul_dw: dy {tuple(dy.shape)} does not "
                         f"have x's {x.shape[0]} rows")
    if kernel_build.on_cpu("grouped matmul", x, dy, tile_expert):
        return grouped_matmul_dw_plain(x, dy, tile_expert, num_experts,
                                       block_t)
    suffix = _kernel_suffix("grouped_matmul_dw", tile_expert, block_t, x, dy)
    d, f = x.shape[1], dy.shape[1]
    dw = torch.empty((num_experts, d, f), dtype=torch.float32,
                     device=x.device)
    kernel_build.launch(
        "grouped_matmul_dw", suffix, _ARGTYPES["grouped_matmul_dw"], x.device,
        x.data_ptr(), dy.data_ptr(), tile_expert.data_ptr(), dw.data_ptr(),
        x.shape[0], d, f, num_experts, tile_expert.shape[0], block_t)
    grouped_matmul_dw.launches += 1
    return dw


def grouped_matmul_fwd_quant(values, scales, w, tile_expert,
                             block_t: int = 128):
    """B6: ``[Tp, F]`` f32 from e4m3 ``values`` [Tp, D], f32 ``scales``
    [Tp, D / qb] and f32 ``w`` [E, D, F] (a bf16 w is the caller's to
    promote, as the reference's dot does)."""
    e, d, f = w.shape
    _check_shapes("grouped_matmul_fwd_quant", values, w, tile_expert,
                  block_t, d)
    nb = scales.shape[-1]
    if values.dtype != WIRE_DTYPE or scales.dtype != torch.float32:
        raise TypeError(f"grouped_matmul_fwd_quant: values must be "
                        f"{WIRE_DTYPE} and scales float32, got "
                        f"{values.dtype} and {scales.dtype}")
    if scales.shape != (values.shape[0], nb) or nb == 0 or d % nb:
        raise ValueError(f"grouped_matmul_fwd_quant: scales "
                         f"{tuple(scales.shape)} are not whole blocks of "
                         f"values {tuple(values.shape)}")
    if kernel_build.on_cpu("grouped matmul", values, scales, w,
                           tile_expert):
        return grouped_matmul_fwd_quant_plain(values, scales, w,
                                              tile_expert, block_t)
    _kernel_suffix("grouped_matmul_fwd_quant", tile_expert, block_t, w)
    for t in (values, scales):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("grouped_matmul_fwd_quant: operands must be "
                             "contiguous and 16-byte aligned")
    if d % 8:
        raise ValueError(f"grouped_matmul_fwd_quant: D={d} must be a "
                         f"multiple of 8 (8-byte fp8 loads)")
    if w.dtype != torch.float32:
        raise TypeError(f"grouped_matmul_fwd_quant: w must be float32, "
                        f"got {w.dtype}")
    y = torch.empty((values.shape[0], f), dtype=torch.float32,
                    device=values.device)
    kernel_build.launch(
        "grouped_matmul_fwd_quant", "f32",
        _ARGTYPES["grouped_matmul_fwd_quant"], values.device,
        values.data_ptr(), scales.data_ptr(), w.data_ptr(),
        tile_expert.data_ptr(), y.data_ptr(), values.shape[0], d, f, e, nb,
        block_t)
    grouped_matmul_fwd_quant.launches += 1
    return y


grouped_matmul_fwd.launches = 0
grouped_matmul_dw.launches = 0
grouped_matmul_fwd_quant.launches = 0
WRAPPERS = {"grouped_matmul_fwd": grouped_matmul_fwd,
            "grouped_matmul_dw": grouped_matmul_dw,
            "grouped_matmul_fwd_quant": grouped_matmul_fwd_quant}
PLAIN = {"grouped_matmul_fwd": grouped_matmul_fwd_plain,
         "grouped_matmul_dw": grouped_matmul_dw_plain,
         "grouped_matmul_fwd_quant": grouped_matmul_fwd_quant_plain}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def _check_tile_expert(tile_expert: torch.Tensor, num_experts: int) -> None:
    """The ``tile_expert`` contract, checked on CPU tensors only: reading
    a CUDA tensor would stall the host on every call, and the kernels do
    not depend on it (B5 finds each expert's tiles by binary search and
    writes zeros for an expert that owns none). Raises when the values
    decrease or an expert owns no tile, as the reference does."""
    if tile_expert.device.type != "cpu":
        return
    te = tile_expert.tolist()
    if any(b < a for a, b in zip(te, te[1:])):
        raise ValueError(
            "grouped_matmul: tile_expert must be NON-DECREASING (each "
            "expert's tiles contiguous): the dw kernel finds an expert's "
            f"tiles as one contiguous run; got {te}"
        )
    missing = sorted(set(range(num_experts)) - set(te))
    if missing:
        raise ValueError(
            "grouped_matmul: every expert 0..E-1 must own at least one "
            f"row-tile, but experts {missing} are absent from "
            "tile_expert. Give each empty expert one sentinel tile of "
            "zero rows (see ops.moe._moe_compute_grouped)"
        )


# -- autograd ----------------------------------------------------------------


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, tile_expert, block_t: int):
        ctx.save_for_backward(x, w, tile_expert)
        ctx.block_t = block_t
        return grouped_matmul_fwd(x, w, tile_expert, block_t)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the same kernel over w^T ([E, F, D]), read in place
            dx = grouped_matmul_fwd(dy, w, tile_expert, ctx.block_t,
                                    transpose_w=True)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dy, tile_expert, w.shape[0],
                                   ctx.block_t).to(w.dtype)
        return dx, dw, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   tile_expert: torch.Tensor, block_t: int = 128,
                   block_f: int = 512) -> torch.Tensor:
    """``y[i] = x[i] @ w[tile_expert[i // block_t]]``.

    Args:
      x: [Tp, D] rows sorted by expert, each expert's group padded to a
        multiple of ``block_t`` (pad rows' outputs are garbage and must
        be masked by the caller's un-sort).
      w: [E, D, F] per-expert weights.
      tile_expert: [Tp // block_t] int32, the expert owning each row
        tile; non-decreasing, every expert present (checked on CPU
        tensors; see ``_check_tile_expert``).
      block_f: accepted for parity with the reference and ignored.
    Returns [Tp, F] in x's dtype (f32 accumulation inside).
    Differentiable in x (dx through B4 over w^T) and w (dw through B5,
    cast to w's dtype); ``tile_expert`` gets no gradient.
    """
    del block_f
    _check_tile_expert(tile_expert, w.shape[0])
    return _GroupedMatmul.apply(x.contiguous(), w.contiguous(),
                                tile_expert.contiguous(), int(block_t))


class _GroupedMatmulQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, scales, w, tile_expert, block_t: int):
        ctx.save_for_backward(values, scales, tile_expert)
        ctx.block_t, ctx.num_experts = block_t, w.shape[0]
        return grouped_matmul_fwd_quant(values, scales, w, tile_expert,
                                        block_t)

    @staticmethod
    def backward(ctx, dy):
        values, scales, tile_expert = ctx.saved_tensors
        dw = None
        if ctx.needs_input_grad[2]:
            # B5 over the dequantized rows, as the reference's _gmq_bwd
            x_deq = dequantize_block_scaled(values, scales)
            dw = grouped_matmul_dw(x_deq, dy.float().contiguous(),
                                   tile_expert, ctx.num_experts,
                                   ctx.block_t)
        # values and scales get zero (None): the rows arrived over the
        # wire already quantized, and the caller's wire boundary carries
        # the activation gradient
        return None, None, dw, None, None


def grouped_matmul_quantized(values: torch.Tensor, scales: torch.Tensor,
                             w: torch.Tensor, tile_expert: torch.Tensor,
                             block_t: int = 128,
                             block_f: int = 512) -> torch.Tensor:
    """``grouped_matmul`` over a block-scaled fp8 LHS, dequantized in the
    kernel (B6): ``y[i] = dequant(values[i], scales[i]) @
    w[tile_expert[i // block_t]]``, f32 out. ``w`` must be f32.

    Bitwise equal to ``grouped_matmul(dequantize_block_scaled(values,
    scales), w, ...)``. Differentiable in ``w`` only: dw through B5 on
    the dequantized rows; ``values`` and ``scales`` get zeros.
    """
    del block_f
    _check_tile_expert(tile_expert, w.shape[0])
    return _GroupedMatmulQuantized.apply(
        values.contiguous(), scales.contiguous(), w.contiguous(),
        tile_expert.contiguous(), int(block_t))
