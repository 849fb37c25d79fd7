"""Outputs of deliberately broken grouped-matmul kernels, which the row
rule of ``ops.flash_check`` must reject on the inputs that the real
kernels pass, and truncation controls, which its bias rule must reject.

The faults are the ones an expert boundary invites. B4 picks each row
tile's weights from ``tile_expert``; an off-by-one reads the neighbouring
expert's. The TPU's dw kernel initialises an expert's output block on
the expert's first row tile and accumulates while the block stays
resident; a port that gets the run of tiles wrong leaves the last one
out or counts the first one twice. B6 adds its scales: a loader that
indexes the scale blocks off by one, or skips the multiply, and it
shares B4's expert boundary.

A kernel that truncates to bf16 where it should round to nearest, or
keeps a partial sum in bf16, moves every output by a fraction of a bf16
step, always toward zero: the row rule lets that through, the bias rule
(``flash_check.bias_close``) must not.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from dlrover_tpu_torch.ops.flash_check import truncate_bf16
from dlrover_tpu_torch.ops.grouped_matmul import (
    grouped_matmul_dw_plain,
    grouped_matmul_fwd_plain,
    grouped_matmul_fwd_quant_plain,
)


def _boundary_tile(tile_expert: torch.Tensor) -> int:
    """The first tile whose expert differs from the tile before it."""
    te = tile_expert.tolist()
    return next(i for i in range(1, len(te)) if te[i] != te[i - 1])


def planted_faults(x, w, dy, tile_expert, block_t: int
                   ) -> List[Tuple[str, str, torch.Tensor]]:
    """(output name, fault, faulty output) for ``y``, ``dx`` and ``dw``:
    what a kernel with that fault would return. Each must fail
    ``flash_check.rows_close`` against the right answer."""
    i = _boundary_tile(tile_expert)
    e = int(tile_expert[i])
    wrong = tile_expert.clone()
    wrong[i] = tile_expert[i - 1]
    tiles = (tile_expert == e).nonzero().flatten().tolist()
    first, last = tiles[0], tiles[-1]

    def rows(tile):
        return slice(tile * block_t, (tile + 1) * block_t)

    x_dropped = x.clone()
    x_dropped[rows(last)] = 0
    twice = grouped_matmul_dw_plain(x, dy, tile_expert, w.shape[0], block_t)
    twice[e] += x[rows(first)].float().t() @ dy[rows(first)].float()
    where = f"tile {i} (expert {e}'s first)"
    return [
        ("y", f"{where} read with expert {int(wrong[i])}'s weights",
         grouped_matmul_fwd_plain(x, w, wrong, block_t)),
        ("dx", f"{where} read with expert {int(wrong[i])}'s weights",
         grouped_matmul_fwd_plain(dy, w, wrong, block_t, transpose_w=True)),
        ("dw", f"expert {e}'s last tile ({last}) left out",
         grouped_matmul_dw_plain(x_dropped, dy, tile_expert, w.shape[0],
                                 block_t)),
        ("dw", f"expert {e}'s first tile ({first}) counted twice", twice),
    ]


def truncation_controls(x, w, dy, tile_expert, block_t: int
                        ) -> List[Tuple[str, str, torch.Tensor]]:
    """(output name, fault, faulty output) for bf16 ``y`` and ``dw``: y
    rounded toward zero to bf16 instead of to nearest, and dw with each
    row tile's partial product x_tile^T dy_tile truncated to bf16 before
    it is added. Each must pass ``flash_check.rows_close`` and fail
    ``flash_check.bias_close`` against the right answer."""
    y = truncate_bf16(grouped_matmul_fwd_plain(x.float(), w.float(),
                                               tile_expert, block_t))
    dw = torch.zeros((w.shape[0], x.shape[1], dy.shape[1]),
                     dtype=torch.float32, device=x.device)
    for tile, e in enumerate(tile_expert.tolist()):
        rows = slice(tile * block_t, (tile + 1) * block_t)
        dw[e] += truncate_bf16(x[rows].float().t() @ dy[rows].float())
    return [("y", "y rounded toward zero to bf16", y.to(x.dtype)),
            ("dw", f"each {block_t}-row tile's partial product truncated "
                   f"to bf16", dw)]


def planted_quant_faults(values, scales, w, tile_expert, block_t: int
                         ) -> List[Tuple[str, str, torch.Tensor]]:
    """(output name, fault, faulty output) of B6's y: each must fail
    ``flash_check.rows_close`` against the right answer."""
    i = _boundary_tile(tile_expert)
    wrong = tile_expert.clone()
    wrong[i] = tile_expert[i - 1]
    return [
        ("y", "each channel block read with its neighbour's scale",
         grouped_matmul_fwd_quant_plain(values, scales.roll(1, dims=-1), w,
                                        tile_expert, block_t)),
        ("y", "the scales ignored (values read as they are)",
         grouped_matmul_fwd_quant_plain(values, torch.ones_like(scales), w,
                                        tile_expert, block_t)),
        ("y", f"tile {i} read with expert {int(wrong[i])}'s weights",
         grouped_matmul_fwd_quant_plain(values, scales, w, wrong, block_t)),
    ]
