"""Grouped matmul for Hopper: the dropless-MoE expert compute, two
hand-written CUDA kernels behind a ``torch.autograd.Function``.

Port of ``dlrover_tpu/ops/grouped_matmul.py``.
``y[i] = x[i] @ w[tile_expert[i // block_t]]``: rows are sorted by
expert and every expert's group is padded to whole row tiles, so each
tile of ``block_t`` rows belongs to one expert. The kernels, in
``dlrover_tpu_torch/csrc``:

  grouped_matmul_fwd  (B4) y = x @ w[e] per row tile, and, reading w
                      transposed in place, dx = dy @ w[e]^T: bf16 on
                      wgmma; f32 (the expert-parallel rank's products)
                      on the CUDA cores, skipping the row tiles at or
                      past ``live_rows``
  grouped_matmul_dw   (B5) dw[e] = sum over e's row tiles of x^T dy, f32:
                      bf16 on wgmma; f32 on the CUDA cores, each
                      expert's sum ending at ``live_rows``
  grouped_matmul_fwd_quant
                      (B6) y = dequant(values, scales) @ w[e], f32: the
                      fp8 rows of the expert-parallel wire, dequantized
                      in the kernel, bitwise equal to dequantizing
                      first and running B4's f32 path (the same loop),
                      skipping the row tiles at or past ``live_rows``

Each has a wrapper here that launches it on a CUDA tensor (or raises:
there is no fallback), a plain PyTorch version that the wrapper uses for
tensors on the CPU, and a launch counter, ``<wrapper>.launches``.

``live_rows`` ([1] int32 on x's device, or None: every row live) is
where the rows that hold anything end: the expert-parallel regroup pads
to a static bound, and its rows from the end of the last local expert's
group on read the zero sentinel (``ops.moe.RegroupLayout.live_rows``).
Rows at or past it come out as zeros, on the CPU too; the f32 kernels
write them without reading x or w, and B5's sums over the rows below it
only. The bf16 kernels do not take it: their output there is the same,
zero rows in, zero rows out (and zero rows add nothing to dw), by the
layout's contract. It differs from computing those rows only where w,
or for dw the other operand, holds a non-finite value (0 * inf is NaN).

The TPU tiling rule (``_pick_block``) does not apply: the kernels mask
ragged D and F edges. ``block_f`` is kept for API parity and does not
change the result; ``block_t`` is the grouping contract and must be a
multiple of the kernels' 128-row tile on the card.

Under a ``utils.prof.CostCounter`` each wrapper reports its FLOPs and
bytes (over the rows given) and runs its plain version or its launch
uncounted; on the meta device it returns an empty output of the right
shape and runs nothing.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from dlrover_tpu_torch.ops import kernel_build
from dlrover_tpu_torch.utils import prof
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
    # the f32 entry point: live_rows after tile_expert
    "grouped_matmul_fwd_f32": [_P] * 5 + [_I] * 6 + [_P],
    # rows, D, F, E, num_tiles, block_t
    "grouped_matmul_dw": [_P] * 4 + [_I] * 6 + [_P],
    # the f32 entry point: live_rows after tile_expert
    "grouped_matmul_dw_f32": [_P] * 5 + [_I] * 6 + [_P],
    # values, scales, w, tile_expert, live_rows, y, then rows, D, F, E,
    # the scale blocks per row, block_t
    "grouped_matmul_fwd_quant": [_P] * 6 + [_I] * 6 + [_P],
}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _row_experts(tile_expert: torch.Tensor, block_t: int) -> torch.Tensor:
    return tile_expert.long().repeat_interleave(block_t)


def _zero_dead_rows(y: torch.Tensor, live_rows) -> torch.Tensor:
    """y with its rows at or past ``live_rows`` zero (no host sync)."""
    if live_rows is None:
        return y
    rows = torch.arange(y.shape[0], device=y.device)
    return torch.where((rows < live_rows.to(y.device).long())[:, None], y,
                       y.new_zeros(()))


# -- plain versions (the CPU path, and what the kernels are held to) --------


def grouped_matmul_fwd_plain(x, w, tile_expert, block_t: int,
                             transpose_w: bool = False, live_rows=None):
    """B4's function, one expert's rows at a time: ``x @ w[e]`` (or
    ``x @ w[e]^T``), f32 accumulation, output in x's dtype; rows at or
    past ``live_rows`` zero."""
    rows = _row_experts(tile_expert, block_t)
    out_width = w.shape[1] if transpose_w else w.shape[2]
    y = torch.zeros((x.shape[0], out_width), dtype=torch.float32,
                    device=x.device)
    for e in range(w.shape[0]):
        sel = rows == e
        we = w[e].float()
        y[sel] = x[sel].float() @ (we.t() if transpose_w else we)
    return _zero_dead_rows(y, live_rows).to(x.dtype)


def grouped_matmul_dw_plain(x, dy, tile_expert, num_experts: int,
                            block_t: int, live_rows=None):
    """B5's function: ``dw[e] = x_e^T @ dy_e`` over expert e's rows below
    ``live_rows``, f32; zeros for an expert that owns no such row."""
    rows = _row_experts(tile_expert, block_t)
    if live_rows is not None:  # a row past it belongs to no expert
        index = torch.arange(rows.shape[0], device=rows.device)
        rows = torch.where(index < live_rows.to(rows.device).long(), rows,
                           rows.new_full((), -1))
    dw = torch.zeros((num_experts, x.shape[1], dy.shape[1]),
                     dtype=torch.float32, device=x.device)
    for e in range(num_experts):
        sel = rows == e
        dw[e] = x[sel].float().t() @ dy[sel].float()
    return dw


def grouped_matmul_fwd_quant_plain(values, scales, w, tile_expert,
                                   block_t: int, live_rows=None):
    """B6's function: dequantize, then B4's plain product, f32 out."""
    return grouped_matmul_fwd_plain(dequantize_block_scaled(values, scales),
                                    w.float(), tile_expert, block_t,
                                    live_rows=live_rows)


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


def _check_live_rows(name: str, live_rows, x) -> None:
    """``live_rows`` is None or a [1] int32 tensor on x's device: the
    kernels read it as one int through a raw pointer."""
    if live_rows is None:
        return
    if not isinstance(live_rows, torch.Tensor):
        raise TypeError(f"{name}: live_rows must be a tensor or None, got "
                        f"{type(live_rows).__name__}")
    if live_rows.dtype != torch.int32:
        raise TypeError(f"{name}: live_rows must be int32, got "
                        f"{live_rows.dtype}")
    if live_rows.shape != (1,):
        raise ValueError(f"{name}: live_rows must have shape (1,), got "
                         f"{tuple(live_rows.shape)}")
    if live_rows.device != x.device:
        raise ValueError(f"{name}: live_rows on {live_rows.device}, x on "
                         f"{x.device}")


def _live_ptr(live_rows) -> int:
    """The pointer the f32 kernels take: 0 (null) reads every row live."""
    return 0 if live_rows is None else live_rows.data_ptr()


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


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


# Each wrapper reports its call to the active count (``utils.prof``):
# FLOPs over the rows given (the live rows depend on the data, which the
# meta device cannot see), bytes each operand read once and each output
# written once; then runs uncounted.


def grouped_matmul_fwd(x, w, tile_expert, block_t: int = 128,
                       transpose_w: bool = False, live_rows=None):
    """B4: ``[Tp, F]`` (``[Tp, D]`` with ``transpose_w``) in x's dtype.
    ``transpose_w`` reads w ``[E, D, F]`` as ``[E, F, D]`` in place, for
    dx; wᵀ is never materialised. Rows at or past ``live_rows`` are
    zeros (the f32 kernel skips them; the bf16 one computes them from
    the zero rows the layout puts there)."""
    e, d, f = w.shape
    _check_shapes("grouped_matmul_fwd", x, w, tile_expert, block_t,
                  f if transpose_w else d)
    _check_live_rows("grouped_matmul_fwd", live_rows, x)
    prof.report_kernel("grouped_matmul_fwd", 2.0 * x.shape[0] * d * f,
                       _nbytes(x, w, tile_expert, live_rows)
                       + x.shape[0] * (d if transpose_w else f)
                       * x.element_size())
    with prof.uncounted():
        return _run_fwd(x, w, tile_expert, block_t, transpose_w, live_rows)


def _run_fwd(x, w, tile_expert, block_t, transpose_w, live_rows):
    e, d, f = w.shape
    if kernel_build.on_meta(x, w, tile_expert):
        return x.new_empty((x.shape[0], d if transpose_w else f))
    if kernel_build.on_cpu("grouped matmul", x, w, tile_expert):
        return grouped_matmul_fwd_plain(x, w, tile_expert, block_t,
                                        transpose_w, live_rows)
    suffix = _kernel_suffix("grouped_matmul_fwd", tile_expert, block_t, x, w)
    y = torch.empty((x.shape[0], d if transpose_w else f), dtype=x.dtype,
                    device=x.device)
    live = [_live_ptr(live_rows)] if suffix == "f32" else []
    kernel_build.launch(
        "grouped_matmul_fwd", suffix,
        _ARGTYPES["grouped_matmul_fwd_f32" if live else "grouped_matmul_fwd"],
        x.device, x.data_ptr(), w.data_ptr(), tile_expert.data_ptr(), *live,
        y.data_ptr(), x.shape[0], d, f, e, block_t, int(transpose_w))
    grouped_matmul_fwd.launches += 1
    return y


def grouped_matmul_dw(x, dy, tile_expert, num_experts: int,
                      block_t: int = 128, live_rows=None):
    """B5: ``[E, D, F]`` f32, zeros for an expert that owns no tile; each
    expert's sum over its rows below ``live_rows`` (the f32 kernel reads
    none past it; the bf16 one sums them too, zero by the layout's
    contract)."""
    _check_shapes("grouped_matmul_dw", x, dy, tile_expert, block_t,
                  x.shape[-1])
    if dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"grouped_matmul_dw: dy {tuple(dy.shape)} does not "
                         f"have x's {x.shape[0]} rows")
    _check_live_rows("grouped_matmul_dw", live_rows, x)
    d, f = x.shape[1], dy.shape[1]
    prof.report_kernel("grouped_matmul_dw", 2.0 * x.shape[0] * d * f,
                       _nbytes(x, dy, tile_expert, live_rows)
                       + num_experts * d * f * 4)
    with prof.uncounted():
        return _run_dw(x, dy, tile_expert, num_experts, block_t, live_rows)


def _run_dw(x, dy, tile_expert, num_experts, block_t, live_rows):
    if kernel_build.on_meta(x, dy, tile_expert):
        return x.new_empty((num_experts, x.shape[1], dy.shape[1]),
                           dtype=torch.float32)
    if kernel_build.on_cpu("grouped matmul", x, dy, tile_expert):
        return grouped_matmul_dw_plain(x, dy, tile_expert, num_experts,
                                       block_t, live_rows)
    suffix = _kernel_suffix("grouped_matmul_dw", tile_expert, block_t, x, dy)
    d, f = x.shape[1], dy.shape[1]
    dw = torch.empty((num_experts, d, f), dtype=torch.float32,
                     device=x.device)
    live = [_live_ptr(live_rows)] if suffix == "f32" else []
    kernel_build.launch(
        "grouped_matmul_dw", suffix,
        _ARGTYPES["grouped_matmul_dw_f32" if live else "grouped_matmul_dw"],
        x.device, x.data_ptr(), dy.data_ptr(), tile_expert.data_ptr(), *live,
        dw.data_ptr(), x.shape[0], d, f, num_experts, tile_expert.shape[0],
        block_t)
    grouped_matmul_dw.launches += 1
    return dw


def grouped_matmul_fwd_quant(values, scales, w, tile_expert,
                             block_t: int = 128, live_rows=None):
    """B6: ``[Tp, F]`` f32 from e4m3 ``values`` [Tp, D], f32 ``scales``
    [Tp, D / qb] and f32 ``w`` [E, D, F] (a bf16 w is the caller's to
    promote, as the reference's dot does); rows at or past ``live_rows``
    zero, not computed."""
    e, d, f = w.shape
    _check_shapes("grouped_matmul_fwd_quant", values, w, tile_expert,
                  block_t, d)
    _check_live_rows("grouped_matmul_fwd_quant", live_rows, values)
    nb = scales.shape[-1]
    if values.dtype != WIRE_DTYPE or scales.dtype != torch.float32:
        raise TypeError(f"grouped_matmul_fwd_quant: values must be "
                        f"{WIRE_DTYPE} and scales float32, got "
                        f"{values.dtype} and {scales.dtype}")
    if scales.shape != (values.shape[0], nb) or nb == 0 or d % nb:
        raise ValueError(f"grouped_matmul_fwd_quant: scales "
                         f"{tuple(scales.shape)} are not whole blocks of "
                         f"values {tuple(values.shape)}")
    prof.report_kernel("grouped_matmul_fwd_quant",
                       2.0 * values.shape[0] * d * f,
                       _nbytes(values, scales, w, tile_expert, live_rows)
                       + values.shape[0] * f * 4)
    with prof.uncounted():
        return _run_fwd_quant(values, scales, w, tile_expert, block_t,
                              live_rows)


def _run_fwd_quant(values, scales, w, tile_expert, block_t, live_rows):
    e, d, f = w.shape
    nb = scales.shape[-1]
    if kernel_build.on_meta(values, scales, w, tile_expert):
        return values.new_empty((values.shape[0], f), dtype=torch.float32)
    if kernel_build.on_cpu("grouped matmul", values, scales, w,
                           tile_expert):
        return grouped_matmul_fwd_quant_plain(values, scales, w,
                                              tile_expert, block_t,
                                              live_rows)
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
        tile_expert.data_ptr(), _live_ptr(live_rows), y.data_ptr(),
        values.shape[0], d, f, e, nb, block_t)
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
    def forward(ctx, x, w, tile_expert, block_t: int, live_rows):
        ctx.save_for_backward(x, w, tile_expert, live_rows)
        ctx.block_t = block_t
        return grouped_matmul_fwd(x, w, tile_expert, block_t,
                                  live_rows=live_rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert, live_rows = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the same kernel over w^T ([E, F, D]), read in place; rows
            # past live_rows carry no gradient
            dx = grouped_matmul_fwd(dy, w, tile_expert, ctx.block_t,
                                    transpose_w=True, live_rows=live_rows)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dy, tile_expert, w.shape[0],
                                   ctx.block_t,
                                   live_rows=live_rows).to(w.dtype)
        return dx, dw, None, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   tile_expert: torch.Tensor, block_t: int = 128,
                   block_f: int = 512,
                   live_rows: torch.Tensor = None) -> torch.Tensor:
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
      live_rows: [1] int32 on x's device, or None (every row live):
        rows at or past it are zeros (see the module docstring); the
        backward's dx is zero there too, and its dw sums the rows below
        it only.
    Returns [Tp, F] in x's dtype (f32 accumulation inside).
    Differentiable in x (dx through B4 over w^T) and w (dw through B5,
    cast to w's dtype); ``tile_expert`` gets no gradient.
    """
    del block_f
    _check_tile_expert(tile_expert, w.shape[0])
    return _GroupedMatmul.apply(x.contiguous(), w.contiguous(),
                                tile_expert.contiguous(), int(block_t),
                                live_rows)


class _GroupedMatmulQuantized(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, scales, w, tile_expert, block_t: int,
                live_rows):
        ctx.save_for_backward(values, scales, tile_expert, live_rows)
        ctx.block_t, ctx.num_experts = block_t, w.shape[0]
        return grouped_matmul_fwd_quant(values, scales, w, tile_expert,
                                        block_t, live_rows)

    @staticmethod
    def backward(ctx, dy):
        values, scales, tile_expert, live_rows = ctx.saved_tensors
        dw = None
        if ctx.needs_input_grad[2]:
            # B5 over the dequantized rows, as the reference's _gmq_bwd
            x_deq = dequantize_block_scaled(values, scales)
            dw = grouped_matmul_dw(x_deq, dy.float().contiguous(),
                                   tile_expert, ctx.num_experts,
                                   ctx.block_t, live_rows=live_rows)
        # values and scales get zero (None): the rows arrived over the
        # wire already quantized, and the caller's wire boundary carries
        # the activation gradient
        return None, None, dw, None, None, None


def grouped_matmul_quantized(values: torch.Tensor, scales: torch.Tensor,
                             w: torch.Tensor, tile_expert: torch.Tensor,
                             block_t: int = 128, block_f: int = 512,
                             live_rows: torch.Tensor = None
                             ) -> torch.Tensor:
    """``grouped_matmul`` over a block-scaled fp8 LHS, dequantized in the
    kernel (B6): ``y[i] = dequant(values[i], scales[i]) @
    w[tile_expert[i // block_t]]``, f32 out. ``w`` must be f32.

    Bitwise equal to ``grouped_matmul(dequantize_block_scaled(values,
    scales), w, ...)`` (with the same ``live_rows``). Differentiable in
    ``w`` only: dw through B5 on the dequantized rows; ``values`` and
    ``scales`` get zeros.
    """
    del block_f
    _check_tile_expert(tile_expert, w.shape[0])
    return _GroupedMatmulQuantized.apply(
        values.contiguous(), scales.contiguous(), w.contiguous(),
        tile_expert.contiguous(), int(block_t), live_rows)
