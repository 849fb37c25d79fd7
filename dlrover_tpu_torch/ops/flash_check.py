"""How a flash kernel's bf16 result is held to its plain version, and
outputs of deliberately broken kernels that the rule must reject.

The kernels and their plain versions round the same f32 values to bf16
at different points (the forward rounds P against its running max, the
plain version against the row's final max), so they differ by about a
bf16 rounding of each output element. A bound on the largest error
relative to the largest value is too loose for attention: the first
causal rows set the largest values, and late rows are tens of times
smaller.
So each row (one ``D``-vector of one head and position) is held on its
own: its error norm within ``ROW_RTOL`` of its own norm, plus
``ROW_FLOOR`` of the tensor's RMS row norm for rows near zero.

The row rule lets a bias of a few tenths of a percent through, such as
P or dS truncated to bf16 instead of rounded to nearest (about -0.27 %
each). So the whole tensor's signed error is also held, projected on the
reference: ``<got - ref, ref> / <ref, ref>``, within ``BIAS_LIMIT``.
Rounding to nearest leaves that projection near zero whatever the
tensor's size; ``bias_controls`` are the truncated outputs it must
reject.

In segment-id mode ``segment_faults`` are what the row rule must
reject: a kernel whose segment mask is shifted by one key, and one that
ignores the ids. In prefix-LM mode ``prefix_faults`` are: a kernel that
ignores the prefix, one whose prompt is one key too wide, and one that
stops its schedule at the diagonal tile (the prompt's keys above it
left out). The rules are the same in every mode.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from dlrover_tpu_torch.ops import flash_attention as fa

ROW_RTOL = 1e-2
ROW_FLOOR = 1e-3
# between the sound kernels' readings and the truncation controls' (see
# PERF.md, section 6)
BIAS_LIMIT = 5e-4


def row_errors(got: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """``worst_row``: the largest ratio of a row's error norm to its
    limit (at most 1 passes); ``norm_ratio``: ||got - ref|| / ||ref||
    over the whole tensor; ``max_abs_err``."""
    g, r = got.float(), ref.float()
    err = torch.linalg.vector_norm(g - r, dim=-1)
    norm = torch.linalg.vector_norm(r, dim=-1)
    limit = ROW_RTOL * norm + ROW_FLOOR * norm.pow(2).mean().sqrt()
    return {
        "worst_row": (err / limit).max().item(),
        "norm_ratio": (torch.linalg.vector_norm(g - r)
                       / torch.linalg.vector_norm(r)).item(),
        "max_abs_err": (g - r).abs().max().item(),
    }


def rows_close(got: torch.Tensor, ref: torch.Tensor) -> bool:
    worst = row_errors(got, ref)["worst_row"]
    return worst == worst and worst <= 1.0  # NaN fails


def bias(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The signed error projected on the reference:
    ``<got - ref, ref> / <ref, ref>``, accumulated in float64."""
    g, r = got.double(), ref.double()
    return (torch.sum((g - r) * r) / torch.sum(r * r)).item()


def bias_close(got: torch.Tensor, ref: torch.Tensor) -> bool:
    return abs(bias(got, ref)) <= BIAS_LIMIT  # NaN fails


def truncate_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` cut to bf16 precision toward zero (its low 16 bits
    cleared), as a kernel that truncated instead of rounding would store
    it; f32 out."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -65536).view(torch.float32)


def bias_controls(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  prefix_len=None) -> List[Tuple[str, str, torch.Tensor]]:
    """(output name, fault, faulty output): the forward with P, the
    dK/dV kernel with P^T or dS^T, and the dQ kernel with dS, truncated
    to bf16 where the kernels round to nearest (in prefix-LM mode with
    ``prefix_len``). Each must fail ``bias_close`` against the right
    answer."""
    s = fa._scores(q, k, causal, scale, prefix_len=prefix_len)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    group = fa._group_size(q, k)
    v_rep = v.repeat_interleave(group, dim=1).float()
    out = (truncate_bf16(p) @ v_rep
           / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    p, ds = fa._probs_and_ds(q, k, v, dout, lse, delta, causal, scale,
                             prefix_len=prefix_len)
    b, kv_heads, s_k, d = k.shape

    def group_sum(t):
        return t.view(b, kv_heads, group, s_k, d).sum(dim=2).to(k.dtype)

    dv = torch.einsum("bhqk,bhqd->bhkd", truncate_bf16(p), dout.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", truncate_bf16(ds), q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", truncate_bf16(ds),
                      k.repeat_interleave(group, dim=1).float())
    return [("out", "P truncated to bf16", out),
            ("dv", "P^T truncated to bf16", group_sum(dv)),
            ("dk", "dS^T truncated to bf16", group_sum(dk)),
            ("dq", "dS truncated to bf16", dq.to(q.dtype))]


def _fwd_dropping(q, k, v, scale, drop):
    """The forward with the (q, k) pairs in ``drop`` left out."""
    s = fa._scores(q, k, False, scale).masked_fill(drop, fa.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    v_rep = v.repeat_interleave(fa._group_size(q, k), dim=1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                       v_rep.float())
    return (acc / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _fwd_no_rescale(q, k, v, causal, scale, tile):
    """The online-softmax forward over k tiles with the accumulator's
    rescale by exp(m_old - m_new) left out."""
    s = fa._scores(q, k, causal, scale)
    v_rep = v.repeat_interleave(fa._group_size(q, k), dim=1).float()
    m = torch.full(s.shape[:-1] + (1,), fa.NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, device=q.device)
    for j in range(0, s.shape[-1], tile):
        s_j = s[..., j:j + tile]
        m_new = torch.maximum(m, s_j.amax(dim=-1, keepdim=True))
        p = torch.exp(s_j - m_new)
        l = l * torch.exp(m - m_new) + p.sum(dim=-1, keepdim=True)
        acc = acc + p.to(v.dtype).float() @ v_rep[..., j:j + tile, :]
        m = m_new
    return (acc / l).to(q.dtype)


def _bwd_zeroing(q, k, v, dout, lse, delta, causal, scale, zero,
                 prefix_len=None):
    """(dk, dv, dq) with p and dS set to 0 where ``zero`` is true."""
    p, ds = fa._probs_and_ds(q, k, v, dout, lse, delta, causal, scale,
                             prefix_len=prefix_len)
    p, ds = p.masked_fill(zero, 0.0), ds.masked_fill(zero, 0.0)
    group = fa._group_size(q, k)
    b, kv_heads, s_k, d = k.shape
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(),
                      dout.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(),
                      k.repeat_interleave(group, dim=1).float())

    def group_sum(t):
        return t.view(b, kv_heads, group, s_k, d).sum(dim=2).to(k.dtype)

    return group_sum(dk), group_sum(dv), dq.to(q.dtype)


def planted_faults(q, k, v, dout, lse, delta, scale: float,
                   tile: int = 64) -> List[Tuple[str, str, torch.Tensor]]:
    """(output name, fault, faulty output) for causal inputs: what a
    kernel with that fault would return. Each must fail ``rows_close``
    against the right answer."""
    s_q, s_k = q.shape[2], k.shape[2]
    rows = torch.arange(s_q, device=q.device)[:, None]
    cols = torch.arange(s_k, device=q.device)[None, :]
    above = cols > rows
    # late rows are small beside the first ones: a fault there hides
    # under a bound relative to the largest value
    last_q_tile = rows >= s_q - tile
    first_k_late = last_q_tile & (cols < tile)
    faults = [
        ("out", "k tile 0 skipped by the last q tile",
         _fwd_dropping(q, k, v, scale, above | first_k_late)),
        ("out", "causal mask one key too wide",
         _fwd_dropping(q, k, v, scale, cols > rows + 1)),
        ("out", "running-max rescale of the accumulator skipped",
         _fwd_no_rescale(q, k, v, True, scale, tile)),
    ]
    bwd = (q, k, v, dout, lse, delta, True, scale)
    dk, dv, _ = _bwd_zeroing(*bwd, last_q_tile)
    faults += [("dk", "last q tile left out of dK", dk),
               ("dv", "last q tile left out of dV", dv)]
    group = fa._group_size(q, k)
    last_head = (torch.arange(q.shape[1], device=q.device) % group
                 == group - 1)[:, None, None]
    dk, dv, _ = _bwd_zeroing(*bwd, last_head)
    faults += [("dk", "one query head of each GQA group left out", dk),
               ("dv", "one query head of each GQA group left out", dv)]
    faults += [("dq", "k tile 0 skipped by the last q tile",
                _bwd_zeroing(*bwd, first_k_late)[2]),
               ("dq", "causal mask one key too wide",
                _bwd_zeroing(q, k, v, dout, lse, delta, False, scale,
                             cols > rows + 1)[2])]
    return faults


def segment_faults(q, k, v, dout, lse, delta, scale: float, seg_q, seg_k
                   ) -> List[Tuple[str, str, torch.Tensor]]:
    """(output name, fault, faulty output) for causal segmented inputs
    (``lse``, ``delta`` the right ones): every output of kernels whose
    segment mask is shifted by one key (each key read with the id of the
    key before it, so each document's first key goes to the document
    before) and of kernels that ignore the ids (plain causal). Each must
    fail ``rows_close`` against the right answer."""
    shifted = seg_k.clone()
    shifted[:, 1:] = seg_k[:, :-1]
    faults = []
    for fault, ids in (("segment mask shifted by one key",
                        (seg_q, shifted)),
                       ("segment ids ignored (plain causal)", (None, None))):
        out, _ = fa.flash_fwd_plain(q, k, v, True, scale, *ids)
        faults.append(("out", fault, out))
        del out
        bwd = (q, k, v, dout, lse, delta, True, scale, *ids)
        dk, dv = fa.flash_bwd_dkv_plain(*bwd)
        faults += [("dk", fault, dk), ("dv", fault, dv)]
        del dk, dv
        faults.append(("dq", fault, fa.flash_bwd_dq_plain(*bwd)))
    return faults


def listed_tiles(tiles: torch.Tensor, s_q: int, s_k: int, causal: bool
                 ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The tiles B1, B2 and B3 list in segment-id mode from the tile
    table ``tiles`` (``fa.segment_tiles``), by the kernels' rule, beside
    the tiles they would visit without a list (the causal cut only): for
    ``"flash_bwd_dq"`` (listed, visited) bool [B, 128-row q tiles,
    128-key K/V tiles], for ``"flash_fwd"`` the same (B1 has B3's tile
    geometry and list), for ``"flash_bwd_dkv"`` [B, 128-key tiles,
    64-row q steps]. A tile is listed when one of its 64 x 64 parts at or
    below the diagonal has ranges that meet."""
    t = fa.SEG_TILE
    b, nq, nk = tiles.shape[0], -(-s_q // t), -(-s_k // t)
    q, k = tiles[:, :nq, None], tiles[:, None, nq:]
    meets = (q[..., 0] <= k[..., 1]) & (k[..., 0] <= q[..., 1])
    if causal:
        meets &= torch.ones(nq, nk, dtype=torch.bool,
                            device=tiles.device).tril()
    # the 128-wide tiles' halves; a missing second half meets nothing
    nq2, nk2 = -(-nq // 2), -(-nk // 2)
    halves = torch.zeros(b, 2 * nq2, 2 * nk2, dtype=torch.bool,
                         device=tiles.device)
    halves[:, :nq, :nk] = meets
    dq = halves.view(b, nq2, 2, nk2, 2).any(dim=4).any(dim=2)
    dkv = halves[:, :nq].view(b, nq, nk2, 2).any(dim=3).transpose(1, 2)
    i, j = torch.arange(nq2)[:, None], torch.arange(nk2)[None, :]
    steps = torch.arange(nq)[None, :]
    visited_dq = (j <= i) if causal else torch.ones(nq2, nk2, dtype=bool)
    visited_dkv = ((steps >= 2 * j.T) if causal
                   else torch.ones(nk2, nq, dtype=bool))
    visited_dq = visited_dq.expand(b, -1, -1)
    return {"flash_fwd": (dq, visited_dq), "flash_bwd_dq": (dq, visited_dq),
            "flash_bwd_dkv": (dkv, visited_dkv.expand(b, -1, -1))}


def prefix_faults(q, k, v, dout, lse, delta, scale: float, prefix_len,
                  tile: int = 128) -> List[Tuple[str, str, torch.Tensor]]:
    """(output name, fault, faulty output) for prefix-LM inputs
    (``lse``, ``delta`` the right ones): every output of kernels that
    ignore the prefix (plain causal), of kernels whose prompt is one key
    too wide, and of kernels whose schedule stops at the diagonal tile
    (``tile`` rows and keys), leaving out the prompt's keys above it.
    Each must fail ``rows_close`` against the right answer."""
    faults = []
    for fault, p in (("prefix ignored (p passed as 0)",
                      torch.zeros_like(prefix_len)),
                     ("prefix one key too wide (p + 1)", prefix_len + 1)):
        out, _ = fa.flash_fwd_plain(q, k, v, True, scale, prefix_len=p)
        faults.append(("out", fault, out))
        del out
        bwd = (q, k, v, dout, lse, delta, True, scale)
        dk, dv = fa.flash_bwd_dkv_plain(*bwd, prefix_len=p)
        faults += [("dk", fault, dk), ("dv", fault, dv)]
        del dk, dv
        faults.append(("dq", fault, fa.flash_bwd_dq_plain(*bwd,
                                                          prefix_len=p)))
    fault = "prompt tiles above the diagonal dropped"
    rows = torch.arange(q.shape[2], device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    above = cols // tile > rows // tile
    visible = (cols <= rows) | (cols < prefix_len[:, None, None, None])
    faults.append(("out", fault,
                   _fwd_dropping(q, k, v, scale, above | ~visible)))
    dk, dv, dq = _bwd_zeroing(q, k, v, dout, lse, delta, True, scale, above,
                              prefix_len)
    faults += [("dk", fault, dk), ("dv", fault, dv), ("dq", fault, dq)]
    return faults
