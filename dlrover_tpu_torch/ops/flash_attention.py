"""Flash attention for Hopper: three hand-written CUDA kernels behind a
``torch.autograd.Function``.

Port of ``dlrover_tpu/ops/flash_attention.py``: the causal and
non-causal GQA modes, the segment-id mode of packed documents and the
prefix-LM mode of GLM. The kernels, in ``dlrover_tpu_torch/csrc``:

  flash_fwd      (B1) O and the per-row f32 logsumexp
  flash_bwd_dkv  (B2) dK, dV summed over the GQA group, k tiles outer
  flash_bwd_dq   (B3) dQ, q tiles outer

Each has a wrapper here that launches it on a CUDA tensor (or raises:
there is no fallback), a plain PyTorch version of the same function
that the wrapper uses for a tensor on the CPU, and a launch counter,
``<wrapper>.launches``, raised by one per kernel launch.

``flash_attention_lse`` is differentiable in both outputs: the lse
cotangent folds into the backward's ``delta = rowsum(dO * O) - dlse``,
computed here in plain torch as the reference computes it outside its
kernels.

Segment-id mode (``seg_q [B, Sq]``, ``seg_k [B, Sk]`` int32, given to
each wrapper as keywords): a score is kept only where the query's id
equals the key's, on top of the causal mask. Each kernel has a separate
instantiation for it (C entry points ``dlr_<name>_seg_<dtype>``, its own
launch counter ``<wrapper>.seg_launches``), so the unsegmented kernels
are unchanged. A row that sees no key at all (possible in the pair form,
``flash_attention_segmented_pair_lse``, whose kv-side ids may lack some
q-side ids) gets ``out = 0`` and ``lse = NEG_INF`` (``finfo(float32).min``,
not ``-inf``), as the reference's finalize writes it; the backward
clamps such an lse to 0 before ``exp(s - lse)``, so its masked entries
stay exactly 0. All three kernels visit only the tiles whose ids can
meet, by the ids' tile table (``segment_tiles``: the [min, max] id of
each 64-id tile), which the autograd forward builds on the device once,
launches B1 with and keeps for B2 and B3 in the backward; the public
wrappers build their own on every call.

Prefix-LM mode (``prefix_len [B]`` int32, a keyword of each wrapper;
always causal): key ``j`` is visible to query ``i`` iff ``j <= i`` or
``j < prefix_len[b]``, so a row's prompt is visible to it whole. Again a
separate instantiation of each kernel (``dlr_<name>_pfx_<dtype>``,
counted in ``<wrapper>.pfx_launches``): the kernels visit the tiles
below the diagonal and every tile of prompt keys, and mask by element
only the tiles that cross the diagonal and are not wholly prompt. Every
row sees key 0, so no row is left without a key. Segment ids and a
prefix together raise.

Layout follows the reference: q ``[B, H, S, D]``, k/v ``[B, H_kv, S, D]``,
query head ``h`` reading KV head ``h // (H // H_kv)``.

The TPU tiling rules (``_fit_block``, ``_check_mosaic_lane_block``) do
not apply: the kernels mask ragged tails, and their tiles are fixed. The
bf16 forward is a Hopper wgmma kernel over 128x128 tiles (a 64- or
128-wide head tile, columns past ``head_dim`` read as zeros); the bf16
dK/dV kernel is one too, over 128-key tiles that step through 64-row q
tiles with the scores transposed; so is the bf16 dQ kernel, over 128-row
q tiles that step through 128-key K/V tiles; every f32 kernel (the
parity path) runs scalar FMA over 32x32 tiles. The ``block_*``
arguments are kept for API parity and do not change the result.

Under a ``utils.prof.CostCounter`` each wrapper reports one call's
FLOPs over the visible (q, k) pairs of its mode and its bytes
(``flash_work``) and runs its plain version or its launch uncounted, so
a step counts the same on the CPU, the card and the meta device; on the
meta device it returns empty outputs of the right shapes and runs
nothing.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.ops import kernel_build
from dlrover_tpu_torch.ops.attention_ref import mha_reference
from dlrover_tpu_torch.utils import prof

NEG_INF = float(torch.finfo(torch.float32).min)

# where each kernel lives and which TPU kernel it replaces
KERNELS: Dict[str, Dict[str, str]] = {
    "flash_fwd": {
        "source": "dlrover_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:64",
    },
    "flash_bwd_dkv": {
        "source": "dlrover_tpu_torch/csrc/flash_bwd_dkv.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:561",
    },
    "flash_bwd_dq": {
        "source": "dlrover_tpu_torch/csrc/flash_bwd_dq.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:638",
    },
    # the segment-id mode: the same sources, separate instantiations
    "flash_fwd_seg": {
        "source": "dlrover_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:127",
    },
    "flash_bwd_dkv_seg": {
        "source": "dlrover_tpu_torch/csrc/flash_bwd_dkv.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:610",
    },
    "flash_bwd_dq_seg": {
        "source": "dlrover_tpu_torch/csrc/flash_bwd_dq.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:678",
    },
    # the prefix-LM mode: the same sources, separate instantiations
    "flash_fwd_pfx": {
        "source": "dlrover_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:122",
    },
    "flash_bwd_dkv_pfx": {
        "source": "dlrover_tpu_torch/csrc/flash_bwd_dkv.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:594",
    },
    "flash_bwd_dq_pfx": {
        "source": "dlrover_tpu_torch/csrc/flash_bwd_dq.cu",
        "replaces": "dlrover_tpu/ops/flash_attention.py:662",
    },
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: pointers..., B, H, H_kv, Sq, Sk, D, scale, causal, stream;
# the segmented entry points take seg_q, seg_k and the ids' tile table
# after the other pointers, the prefix-LM ones prefix_len
_POINTERS = {"flash_fwd": 5, "flash_bwd_dkv": 8, "flash_bwd_dq": 7}
_MODE_POINTERS = {"": 0, "_seg": 3, "_pfx": 1}
_ARGTYPES = {
    name + mode: [_P] * (n + extra) + [_I] * 6 + [_F, _I, _P]
    for name, n in _POINTERS.items()
    for mode, extra in _MODE_POINTERS.items()
}
SEG_TILE = 64  # ids a row of the tile table covers
# each mode's launch counter on the wrapper
_COUNTERS = {"": "launches", "_seg": "seg_launches", "_pfx": "pfx_launches"}
_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _group_size(q: torch.Tensor, k: torch.Tensor) -> int:
    heads, kv_heads = q.shape[1], k.shape[1]
    if heads % kv_heads:
        raise ValueError(
            f"num_heads {heads} not divisible by num_kv_heads {kv_heads}"
        )
    return heads // kv_heads


# -- plain versions (the CPU path, and what the kernels are held to) --------


def _scores(q, k, causal: bool, scale: float, seg_q=None,
            seg_k=None, prefix_len=None) -> torch.Tensor:
    """f32 scaled logits [B, H, Sq, Sk], masked with NEG_INF above the
    diagonal when causal (past the prompt too, given ``prefix_len``)
    and, given segment ids, where the query's id differs from the key's;
    GQA by repeating KV heads."""
    k = k.repeat_interleave(_group_size(q, k), dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=q.device).tril()
        if prefix_len is not None:  # the prompt is visible to every row
            cols = torch.arange(s.shape[-1], device=q.device)
            mask = mask | (cols < prefix_len[:, None, None, None])
        s = s.masked_fill(~mask, NEG_INF)
    if seg_q is not None:
        same = seg_q[:, None, :, None] == seg_k[:, None, None, :]
        s = s.masked_fill(~same, NEG_INF)
    return s


def _no_key_to_zero(t: torch.Tensor) -> torch.Tensor:
    """A row max or lse of a row that sees no key (NEG_INF) replaced by
    0, so that exp(NEG_INF - it) is exactly 0 (the reference's clamp)."""
    return torch.where(t <= NEG_INF * 0.5, torch.zeros_like(t), t)


def flash_fwd_plain(q, k, v, causal: bool, scale: float, seg_q=None,
                    seg_k=None, prefix_len=None):
    """The forward kernel's function as one tile: (out, lse). A row
    that sees no key gets out 0 and lse NEG_INF."""
    s = _scores(q, k, causal, scale, seg_q, seg_k, prefix_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - _no_key_to_zero(m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    v_rep = v.repeat_interleave(_group_size(q, k), dim=1)
    acc = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                       v_rep.float())
    out = (acc / l_safe).to(q.dtype)
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out, lse


def _probs_and_ds(q, k, v, dout, lse, delta, causal, scale, seg_q=None,
                  seg_k=None, prefix_len=None):
    """Recomputed probabilities p = exp(s - lse) and
    dS = p * (dO V^T - delta) * scale, both f32 [B, H, Sq, Sk]."""
    s = _scores(q, k, causal, scale, seg_q, seg_k, prefix_len)
    p = torch.exp(s - _no_key_to_zero(lse)[..., None])
    v_rep = v.repeat_interleave(_group_size(q, k), dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dout.float(), v_rep.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal: bool,
                        scale: float, seg_q=None, seg_k=None,
                        prefix_len=None):
    """The dKV kernel's function: (dk, dv), summed over each KV head's
    group of query heads."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale, seg_q,
                          seg_k, prefix_len)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dout.dtype).float(),
                      dout.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds.to(q.dtype).float(), q.float())
    b, kv_heads, s_k, d = k.shape

    def group_sum(t):
        return t.view(b, kv_heads, -1, s_k, d).sum(dim=2)

    return group_sum(dk).to(k.dtype), group_sum(dv).to(v.dtype)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal: bool,
                       scale: float, seg_q=None, seg_k=None,
                       prefix_len=None):
    """The dQ kernel's function: dq."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, causal, scale, seg_q,
                          seg_k, prefix_len)
    k_rep = k.repeat_interleave(_group_size(q, k), dim=1)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds.to(q.dtype).float(),
                      k_rep.float())
    return dq.to(q.dtype)


def segment_tiles(seg_q: torch.Tensor,
                  seg_k: torch.Tensor) -> torch.Tensor:
    """The ids' tile table of B1's, B2's and B3's segment-id mode: int32
    ``[B, ceil(Sq / 64) + ceil(Sk / 64), 2]``, the smallest and largest
    id of each run of ``SEG_TILE`` ids, ``seg_q``'s tiles first, then
    ``seg_k``'s (a ragged last tile over its own ids only). Plain torch
    ops on the ids' device: no host sync. The kernels schedule a tile
    pair only where the two ranges meet, which keeps every tile pair
    that holds a same-id pair."""
    b = seg_q.shape[0]
    pieces = []
    for ids in (seg_q, seg_k):
        pad = -ids.shape[1] % SEG_TILE  # the last id again: same range
        pieces += [ids, ids[:, -1:].expand(b, pad)]
    tiles = torch.cat(pieces, dim=1).view(b, -1, SEG_TILE)
    return torch.stack([tiles.amin(dim=-1), tiles.amax(dim=-1)],
                       dim=-1).to(torch.int32).contiguous()


# -- kernel wrappers ---------------------------------------------------------


def _check_shapes(name: str, q, k, v, causal: bool, dout=None,
                  rows=(), seg_q=None, seg_k=None, prefix_len=None) -> None:
    """Shapes the kernels index raw pointers by (and the plain versions
    broadcast over): checked on every path."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: expected q [B,H,Sq,D] and k, v "
                         f"[B,H_kv,Sk,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s_q, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch or head_dim")
    _group_size(q, k)
    if causal and k.shape[2] != s_q:
        raise ValueError(f"{name}: causal attention requires s_q == s_k "
                         f"(got {s_q} vs {k.shape[2]}); use causal=False "
                         f"for cross attention")
    if dout is not None and dout.shape != q.shape:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} is not q's "
                         f"shape {tuple(q.shape)}")
    for t in rows:
        if t.shape != (b, h, s_q) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be float32 "
                             f"[{b}, {h}, {s_q}]")
    if (seg_q is None) != (seg_k is None):
        raise ValueError(f"{name}: give both seg_q and seg_k, or neither")
    if seg_q is not None:
        for ids, length, side in ((seg_q, s_q, "seg_q"),
                                  (seg_k, k.shape[2], "seg_k")):
            if ids.shape != (b, length) or ids.dtype != torch.int32:
                raise ValueError(f"{name}: {side} must be int32 "
                                 f"[{b}, {length}]; got {ids.dtype} "
                                 f"{tuple(ids.shape)}")
    if prefix_len is not None:
        if seg_q is not None:
            raise ValueError(f"{name}: segment ids and prefix_len are "
                             f"mutually exclusive masking modes")
        if not causal:
            raise ValueError(f"{name}: the prefix-LM mode is causal")
        if prefix_len.shape != (b,) or prefix_len.dtype != torch.int32:
            raise ValueError(f"{name}: prefix_len must be int32 [{b}]; got "
                             f"{prefix_len.dtype} "
                             f"{tuple(prefix_len.shape)}")


def _mode(seg_q, seg_k, prefix_len):
    """(the mode's suffix of a kernel's name: "", "_seg" or "_pfx"; its
    int32 operands, in the C entry point's order)."""
    if prefix_len is not None:
        return "_pfx", (prefix_len,)
    if seg_q is not None:
        return "_seg", (seg_q, seg_k)
    return "", ()


def _table(seg_q, seg_k, seg_tiles) -> tuple:
    """The ids' tile table as the segment-id kernels take it (one more
    int32 operand, built from the ids on their device): ``seg_tiles``,
    or built here when None; nothing outside segment-id mode. The plain
    versions do not read it."""
    if seg_q is None:
        return ()
    return (segment_tiles(seg_q, seg_k) if seg_tiles is None
            else seg_tiles,)


def _kernel_suffix(name: str, q, k, v, dout=None, rows=(), mode="",
                   ids=()) -> str:
    """What the kernel itself takes; returns the suffix of its C entry
    point: the dtype's, after ``seg_`` or ``pfx_`` in those modes."""
    d = q.shape[-1]
    if q.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {q.dtype} not supported "
                        f"(bfloat16 or float32)")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"{name}: head_dim {d} must be a multiple of 16 "
                         f"in [16, 128]")
    inputs = [t for t in (q, k, v, dout) if t is not None]
    for t in inputs:
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: mixed dtypes {q.dtype} and {t.dtype}")
    for t in (*inputs, *rows, *ids):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and "
                             f"16-byte aligned")
    return mode[1:] + ("_" if mode else "") + _SUFFIX[q.dtype]


def _shape_args(q, k, causal, scale):
    b, h, s_q, d = q.shape
    return (b, h, k.shape[1], s_q, k.shape[2], d, ctypes.c_float(scale),
            int(causal))


def _count(fn, mode: str) -> None:
    counter = _COUNTERS[mode]
    setattr(fn, counter, getattr(fn, counter) + 1)


# -- what a call costs --------------------------------------------------------

# FLOPs per visible (q, k) pair, head and head_dim element: B1 runs two
# products (Q K^T, P V), B2 four (Q K^T and dO V^T again, P^T dO,
# dS^T Q), B3 three (Q K^T, dO V^T, dS K); two FLOPs a multiply-add
FLOPS_PER_PAIR = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}


def visible_pairs(q, k, causal: bool, seg_q=None, seg_k=None,
                  prefix_len=None) -> int:
    """The (q, k) pairs the mask lets through, summed over the batch's
    rows (per head): causal ``s (s + 1) / 2`` a row, non-causal
    ``s_q s_k``; prefix-LM ``p^2 + (s (s + 1) - p (p + 1)) / 2`` for a
    row's prompt ``p``; segment ids the pairs of equal id (and causal),
    read from the ids. On the meta device the ids hold no values: the
    active count's hint for the mode (``CostCounter.pair_hints``, from
    a host batch) stands in, else the causal (or full) count, an upper
    bound."""
    b, s_q, s_k = q.shape[0], q.shape[2], k.shape[2]
    dense = s_q * (s_q + 1) // 2 if causal else s_q * s_k
    mode, ids = _mode(seg_q, seg_k, prefix_len)
    if not mode:
        return b * dense
    if ids[0].device.type == "meta":
        counter = prof.active_counter()
        hint = (counter.pair_hints.get((mode, s_q, s_k))
                if counter is not None else None)
        return int(round(b * (dense if hint is None else hint)))
    if mode == "_pfx":
        p = prefix_len.long().clamp(0, s_q)
        return int((p * p + (s_q * (s_q + 1) - p * (p + 1)) // 2).sum())
    same = seg_q[:, :, None] == seg_k[:, None, :]
    if causal:
        same &= torch.ones((s_q, s_k), dtype=torch.bool,
                           device=same.device).tril()
    return int(same.sum())


def flash_work(name: str, q, k, causal: bool, seg_q=None, seg_k=None,
               prefix_len=None) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call of kernel ``name`` on these operands:
    FLOPs over the visible pairs (``visible_pairs``); bytes each input
    read once and each output written once (q, k, v; B2/B3 also dO, lse
    and delta; the ids and their tile table), the figures behind
    ``PERF.md``'s Bound column."""
    b, h, s_q, d = q.shape
    io = q.element_size()
    qb, kb = q.numel() * io, k.numel() * io
    rows = b * h * s_q * 4  # one f32 a row: lse, delta
    ids = sum(t.numel() * 4 for t in (seg_q, seg_k, prefix_len)
              if t is not None)
    if seg_q is not None:  # the ids' tile table
        ids += b * (-(-s_q // SEG_TILE) - (-k.shape[2] // SEG_TILE)) * 2 * 4
    nbytes = {
        "flash_fwd": 2 * qb + 2 * kb + rows,
        "flash_bwd_dkv": 2 * qb + 4 * kb + 2 * rows,
        "flash_bwd_dq": 3 * qb + 2 * kb + 2 * rows,
    }[name] + ids
    pairs = visible_pairs(q, k, causal, seg_q, seg_k, prefix_len)
    return float(FLOPS_PER_PAIR[name] * h * d * pairs), float(nbytes)


def _report(name: str, q, k, causal, seg_q, seg_k, prefix_len) -> None:
    """One call's cost to the active count, if any (``utils.prof``)."""
    if prof.active_counter() is None:
        return
    with prof.uncounted():
        flops, nbytes = flash_work(name, q, k, causal, seg_q, seg_k,
                                   prefix_len)
    prof.report_kernel(name + _mode(seg_q, seg_k, prefix_len)[0], flops,
                       nbytes)


def flash_fwd(q, k, v, causal: bool, scale: float, *, seg_q=None,
              seg_k=None, prefix_len=None):
    """B1: (out [B,H,Sq,D] in q's dtype, lse [B,H,Sq] f32); in segment-id
    mode with ``seg_q`` [B,Sq] and ``seg_k`` [B,Sk] int32, in prefix-LM
    mode with ``prefix_len`` [B] int32."""
    return _launch_fwd(q, k, v, causal, scale, seg_q, seg_k, prefix_len,
                       None)


def _launch_fwd(q, k, v, causal, scale, seg_q, seg_k, prefix_len,
                seg_tiles):
    """B1; in segment-id mode given ``segment_tiles(seg_q, seg_k)``, or
    None to build it here: the autograd forward builds the table once
    for B1 and keeps it for B2 and B3."""
    _check_shapes("flash_fwd", q, k, v, causal, seg_q=seg_q, seg_k=seg_k,
                  prefix_len=prefix_len)
    _report("flash_fwd", q, k, causal, seg_q, seg_k, prefix_len)
    with prof.uncounted():
        return _run_fwd(q, k, v, causal, scale, seg_q, seg_k, prefix_len,
                        seg_tiles)


def _run_fwd(q, k, v, causal, scale, seg_q, seg_k, prefix_len, seg_tiles):
    mode, ids = _mode(seg_q, seg_k, prefix_len)
    if kernel_build.on_meta(q, k, v, *ids):
        return torch.empty_like(q), torch.empty(
            q.shape[:3], dtype=torch.float32, device=q.device)
    if kernel_build.on_cpu("flash attention", q, k, v, *ids):
        return flash_fwd_plain(q, k, v, causal, scale, seg_q, seg_k,
                               prefix_len)
    ids += _table(seg_q, seg_k, seg_tiles)
    suffix = _kernel_suffix("flash_fwd", q, k, v, mode=mode, ids=ids)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    kernel_build.launch(
        "flash_fwd", suffix, _ARGTYPES["flash_fwd" + mode], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *(t.data_ptr() for t in ids),
        *_shape_args(q, k, causal, scale))
    _count(flash_fwd, mode)
    return out, lse


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  *, seg_q=None, seg_k=None, prefix_len=None):
    """B2: (dk, dv) in k's and v's shape and dtype."""
    return _launch_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, seg_q,
                           seg_k, prefix_len, None)


def _launch_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, seg_q, seg_k,
                    prefix_len, seg_tiles):
    """B2 given the ids' tile table, as ``_launch_fwd``."""
    _check_shapes("flash_bwd_dkv", q, k, v, causal, dout, (lse, delta),
                  seg_q, seg_k, prefix_len)
    _report("flash_bwd_dkv", q, k, causal, seg_q, seg_k, prefix_len)
    with prof.uncounted():
        return _run_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, seg_q,
                            seg_k, prefix_len, seg_tiles)


def _run_bwd_dkv(q, k, v, dout, lse, delta, causal, scale, seg_q, seg_k,
                 prefix_len, seg_tiles):
    mode, ids = _mode(seg_q, seg_k, prefix_len)
    if kernel_build.on_meta(q, k, v, dout, lse, delta, *ids):
        return torch.empty_like(k), torch.empty_like(v)
    if kernel_build.on_cpu("flash attention", q, k, v, dout, lse, delta,
                           *ids):
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal, scale,
                                   seg_q, seg_k, prefix_len)
    ids += _table(seg_q, seg_k, seg_tiles)
    suffix = _kernel_suffix("flash_bwd_dkv", q, k, v, dout, (lse, delta),
                            mode, ids)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    kernel_build.launch(
        "flash_bwd_dkv", suffix, _ARGTYPES["flash_bwd_dkv" + mode],
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(t.data_ptr() for t in ids), *_shape_args(q, k, causal, scale))
    _count(flash_bwd_dkv, mode)
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, scale: float,
                 *, seg_q=None, seg_k=None, prefix_len=None):
    """B3: dq in q's shape and dtype."""
    return _launch_bwd_dq(q, k, v, dout, lse, delta, causal, scale, seg_q,
                          seg_k, prefix_len, None)


def _launch_bwd_dq(q, k, v, dout, lse, delta, causal, scale, seg_q, seg_k,
                   prefix_len, seg_tiles):
    """B3 given the ids' tile table, as ``_launch_bwd_dkv``."""
    _check_shapes("flash_bwd_dq", q, k, v, causal, dout, (lse, delta),
                  seg_q, seg_k, prefix_len)
    _report("flash_bwd_dq", q, k, causal, seg_q, seg_k, prefix_len)
    with prof.uncounted():
        return _run_bwd_dq(q, k, v, dout, lse, delta, causal, scale, seg_q,
                           seg_k, prefix_len, seg_tiles)


def _run_bwd_dq(q, k, v, dout, lse, delta, causal, scale, seg_q, seg_k,
                prefix_len, seg_tiles):
    mode, ids = _mode(seg_q, seg_k, prefix_len)
    if kernel_build.on_meta(q, k, v, dout, lse, delta, *ids):
        return torch.empty_like(q)
    if kernel_build.on_cpu("flash attention", q, k, v, dout, lse, delta,
                           *ids):
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, scale,
                                  seg_q, seg_k, prefix_len)
    ids += _table(seg_q, seg_k, seg_tiles)
    suffix = _kernel_suffix("flash_bwd_dq", q, k, v, dout, (lse, delta),
                            mode, ids)
    dq = torch.empty_like(q)
    kernel_build.launch(
        "flash_bwd_dq", suffix, _ARGTYPES["flash_bwd_dq" + mode], q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *(t.data_ptr() for t in ids), *_shape_args(q, k, causal, scale))
    _count(flash_bwd_dq, mode)
    return dq


WRAPPERS = {"flash_fwd": flash_fwd, "flash_bwd_dkv": flash_bwd_dkv,
            "flash_bwd_dq": flash_bwd_dq}
PLAIN = {"flash_fwd": flash_fwd_plain, "flash_bwd_dkv": flash_bwd_dkv_plain,
         "flash_bwd_dq": flash_bwd_dq_plain}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset: the unsegmented
    ones under the wrapper's name, the segment-id ones under
    ``<name>_seg``, the prefix-LM ones under ``<name>_pfx``."""
    return {name + mode: getattr(fn, counter)
            for mode, counter in _COUNTERS.items()
            for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        for counter in _COUNTERS.values():
            setattr(fn, counter, 0)


reset_launch_counts()


# -- autograd ----------------------------------------------------------------


def _id_args(ids):
    """seg_q, seg_k, prefix_len and the ids' tile table from the
    autograd function's ``ids`` (None where absent), in the launch
    helpers' order."""
    return tuple(ids.get(name) for name in ("seg_q", "seg_k", "prefix_len",
                                            "seg_tiles"))


class _FlashAttention(torch.autograd.Function):
    """(out, lse) of the three kernels; with ``seg_q``/``seg_k`` (int32,
    no gradient) in their segment-id mode, with ``prefix_len`` in their
    prefix-LM mode."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, seg_q=None,
                seg_k=None, prefix_len=None):
        ids = {}
        if seg_q is not None:
            # one tile table for the three kernels
            ids = {"seg_q": seg_q, "seg_k": seg_k,
                   "seg_tiles": segment_tiles(seg_q, seg_k)}
        if prefix_len is not None:
            ids["prefix_len"] = prefix_len
        out, lse = _launch_fwd(q, k, v, causal, scale, *_id_args(ids))
        ctx.save_for_backward(q, k, v, out, lse, *ids.values())
        ctx.causal, ctx.scale, ctx.id_names = causal, scale, tuple(ids)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, *ids = ctx.saved_tensors
        ids = dict(zip(ctx.id_names, ids))
        dout = dout.contiguous()
        # the lse cotangent enters as ds = p * (dp - (delta - dlse))
        delta = ((dout.float() * out.float()).sum(dim=-1)
                 - dlse.float()).contiguous()
        args = (q, k, v, dout, lse, delta, ctx.causal, ctx.scale,
                *_id_args(ids))
        dk, dv = _launch_bwd_dkv(*args)
        dq = _launch_bwd_dq(*args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_lse(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H_kv, S, D] (H_kv divides H)
    v: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
    *,
    block_q: int = 512,
    block_k: int = 1024,
    block_q_bwd: int = 0,
    block_k_bwd: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention returning ``(out, lse)``, ``lse[b,h,s]`` the row
    logsumexp of the scaled, masked scores in f32. Differentiable in
    both outputs. ``block_*`` are accepted for parity with the
    reference and ignored (see the module docstring)."""
    del block_q, block_k, block_q_bwd, block_k_bwd
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), float(scale))


def flash_attention(q, k, v, causal: bool = True,
                    scale: Optional[float] = None, **blocks) -> torch.Tensor:
    """Memory-efficient attention; differentiable (the backward
    recomputes probabilities from the saved logsumexp)."""
    return flash_attention_lse(q, k, v, causal, scale, **blocks)[0]


def flash_attention_auto(q, k, v, causal: bool = True,
                         scale: Optional[float] = None,
                         **blocks) -> torch.Tensor:
    """The model's flash call site. The reference routes through a
    ``shard_map`` wrapper under a multi-device mesh; this slice runs on
    one device, so it is a local call."""
    return flash_attention(q, k, v, causal, scale, **blocks)


# -- packed documents (segment ids) -------------------------------------------


def _ids(segment_ids: torch.Tensor) -> torch.Tensor:
    """Segment ids as the kernels take them: int32, contiguous (cast
    once here, not per kernel)."""
    return segment_ids.to(torch.int32).contiguous()


def flash_attention_segmented_pair_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,  # [B, S_q]
    seg_k: torch.Tensor,  # [B, S_k]: independent kv-side ids
    causal: bool = False,
    scale: Optional[float] = None,
    **blocks,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segmented attention whose q-side and kv-side ids are independent
    arrays (the ring-attention step's shape: local queries against a
    visiting KV shard). Returns ``(out, lse)``, differentiable in both;
    a row whose id no key carries reads ``out = 0``, ``lse = NEG_INF``."""
    del blocks  # parity with the reference; the kernels' tiles are fixed
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal), float(scale),
                                 _ids(seg_q), _ids(seg_k))


def flash_attention_segmented(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H_kv, S, D]
    v: torch.Tensor,
    segment_ids: torch.Tensor,  # [B, S]: tokens attend within a segment
    causal: bool = True,
    scale: Optional[float] = None,
    **blocks,
) -> torch.Tensor:
    """Flash attention over packed documents: several documents share a
    row, separated by ``segment_ids``, and a token attends only to keys
    of its own segment (and, when causal, not after it). The ids get no
    gradient."""
    ids = _ids(segment_ids)
    return flash_attention_segmented_pair_lse(q, k, v, ids, ids, causal,
                                              scale, **blocks)[0]


def flash_attention_segmented_auto(q, k, v, segment_ids, causal: bool = True,
                                   scale: Optional[float] = None,
                                   **blocks) -> torch.Tensor:
    """The model's segmented flash call site: a local call on one
    device, as ``flash_attention_auto`` is."""
    return flash_attention_segmented(q, k, v, segment_ids, causal, scale,
                                     **blocks)


def segmented_attention(q, k, v, segment_ids, use_flash: bool,
                        block_q: int = 512, block_k: int = 1024,
                        block_q_bwd: int = 0,
                        block_k_bwd: int = 0) -> torch.Tensor:
    """The one segmented-attention dispatch of the model families: the
    flash kernels in their segment-id mode, or the reference attention
    with an additive NEG_INF bias between segments."""
    if use_flash:
        return flash_attention_segmented_auto(
            q, k, v, segment_ids, causal=True, block_q=block_q,
            block_k=block_k, block_q_bwd=block_q_bwd,
            block_k_bwd=block_k_bwd)
    same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
    bias = torch.where(same, 0.0, NEG_INF)
    return mha_reference(q, k, v, causal=True, bias=bias)


# -- prefix-LM (GLM) ---------------------------------------------------------


def flash_attention_prefix_lse(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, H_kv, S, D]
    v: torch.Tensor,
    prefix_len: torch.Tensor,  # [B]: bidirectional over [0, prefix)
    scale: Optional[float] = None,
    **blocks,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_prefix`` returning ``(out, lse)``,
    differentiable in both, the lse cotangent folded into ``delta`` as
    in ``flash_attention_lse``. ``prefix_len`` gets no gradient."""
    del blocks  # parity with the reference; the kernels' tiles are fixed
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), True, float(scale), None,
                                 None, _ids(prefix_len))


def flash_attention_prefix(q, k, v, prefix_len,
                           scale: Optional[float] = None,
                           **blocks) -> torch.Tensor:
    """Prefix-LM flash attention (GLM's mask): token ``i`` attends key
    ``j`` iff ``j <= i`` (causal) or ``j < prefix_len[b]`` (the prompt
    is visible in both directions), inside the kernels' tiles: no S x S
    bias is formed."""
    return flash_attention_prefix_lse(q, k, v, prefix_len, scale,
                                      **blocks)[0]


def flash_attention_prefix_auto(q, k, v, prefix_len,
                                scale: Optional[float] = None,
                                **blocks) -> torch.Tensor:
    """The model's prefix-LM flash call site: a local call on one
    device, as ``flash_attention_auto`` is."""
    return flash_attention_prefix(q, k, v, prefix_len, scale, **blocks)
