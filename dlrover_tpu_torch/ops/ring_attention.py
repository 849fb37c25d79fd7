"""Ring attention: sequence-parallel flash attention over the "seq" mesh
axis (port of ``dlrover_tpu/ops/ring_attention.py``).

Each seq rank holds a contiguous block of every row's tokens (rank i:
global positions ``[i S_local, (i+1) S_local)``). Q stays resident; the
K/V shards rotate one rank forward per step (``ops.ring.shift_async``,
rank i sends to i+1), and each step's partial output merges online by
its logsumexp:

  lse' = logaddexp(lse, lse_i)
  o'   = o exp(lse - lse') + o_i exp(lse_i - lse')

Causality is resolved per shard: the diagonal shard attends causally,
a wholly past one (owner < my) without a mask, a wholly future one is
skipped. Packed documents (``segment_ids``) may span shards: the ids
rotate with K/V and every step masks cross-document pairs through the
pair-segmented kernels (independent q and k ids). GLM's prefix-LM mask
(``prefix_len``, the global prompt lengths) decomposes over the ring:
the diagonal runs the prefix kernels with the shard-local prompt
``clip(p - my S_local, 0, S_local)``, a past shard is fully visible, a
future shard contributes only its prompt columns (the pair-segmented
kernels with q ids 0 and k ids ``col >= p_vis``, non-causal), and a
future shard with no prompt column in any row is skipped. GQA rotates
the H_kv heads only.

The reference's SPMD program runs every ``ppermute`` (and its
transpose) on every device. Here the skips differ by rank, so a plain
autograd graph through per-step shifts would call a shift's backward on
some ranks and not on others, and hang. The ring is one
``torch.autograd.Function`` instead: its forward saves q, k, v, the
merged output O and the merged lse L (not the visiting shards); its
backward rotates K/V again on the same schedule, with f32 dK/dV
accumulators that travel with their shard and come home by one last
shift, and runs B2 and B3 on each attended step with the global L and
``delta = rowsum(dO O)`` in f32. Every rank issues the same exchanges in
the same order whatever it skips, and every skip is decided on the host
(the owner's index; for the prefix ring a host copy of ``prefix_len``),
with no device read inside a step. Bytes a rank sends: the forward
``n - 1`` K/V hops (plus the ids when packed), the backward ``n - 1``
K/V hops and ``n`` dK/dV hops (f32), and a recompute of the forward
(the model's remat) the forward's again.

Both passes run outside the current dispatch modes: selective
checkpointing replays a block's ops in the recompute and holds them to
the forward's, and a checkpointed block's recompute must re-issue the
ring's exchanges in the same order on every rank, so the ring is
recomputed whole (the kernels' launches and the exchanges twice, as the
flash forward already is under ``dots_saveable``). Under a
``utils.prof.CostCounter`` the kernels report their FLOPs and the
shifts their bytes; the merge's elementwise ops are not counted.

Overlap: the next shard's exchange is issued before the current one is
attended (in the backward, each dK/dV accumulator's hop before the next
step's products), bit for bit the synchronous schedule (``overlap``
False, which the tests hold it against). Over gloo on one card it buys nothing measurable; on NCCL the
exchange runs on the process group's stream beside the kernels, the
reference's design, where XLA overlaps the ``ppermute`` with the block.

``impl``: "flash" runs B1-B3 (``ops.flash_attention``: the kernels on a
CUDA tensor, their plain versions on the CPU); "blockwise" is the
reference's ``_xla_attend_lse``, a plain PyTorch loop over K/V chunks
carrying (acc, m, l) with the same masks and ``NEG_INF`` handling, and
its backward the same loop over the recomputed probabilities.

The layout is the reference's contiguous one (no zig-zag reordering)
and there is no all-to-all variant. A tensor axis > 1 raises (ROADMAP
A15).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.ops.shard_compat import ambient_mesh_with_axes

NEG_INF = float(torch.finfo(torch.float32).min)

# the batch key of the prompt lengths' host copy (``parallel.accelerate``'s
# ``shard_batch`` adds it under seq ranks): the prefix ring's skips
PREFIX_HOST = "prefix_len_host"


def ambient_ring_mesh(axis_name: str = "seq"):
    """The ambient process mesh (what ``parallel.accelerate`` sets
    around each step) when it carries an ``axis_name`` axis of size
    > 1; else None. A config that names only ``seq_axis`` stays valid
    across a change of world: each accelerate sets its own mesh."""
    return ambient_mesh_with_axes((axis_name,))


def seq_shard(axis_name: str = "seq"):
    """(this rank's index on ``axis_name``, the axis's size) of the
    ambient ring mesh; (0, 1) without one."""
    mesh = ambient_ring_mesh(axis_name)
    if mesh is None:
        return 0, 1
    from dlrover_tpu_torch.parallel.sharding_rules import rank_coords

    sizes = mesh.sizes
    return (rank_coords(mesh.rank, sizes, mesh.axis_names)[axis_name],
            sizes[axis_name])


def impl_from_flags(use_flash: bool) -> str:
    """The one mapping of a model config's flash knob onto the ring's
    ``impl``: the flash kernels, or the blockwise plain attend."""
    return "flash" if use_flash else "blockwise"


def seq_group(seq_axis: Optional[str]):
    """The process group of the ambient ring mesh's seq axis (None
    without one): where a loss counts the whole rows' tokens."""
    mesh = ambient_ring_mesh(seq_axis) if seq_axis else None
    return None if mesh is None else mesh.group((seq_axis,))


def check_seq_split(seq_axis: Optional[str]) -> None:
    """A mesh that splits the sequence needs a model that runs the
    ring: the plain attention would attend within each rank's block."""
    if not seq_axis and ambient_ring_mesh("seq") is not None:
        raise ValueError("the mesh splits each row's tokens over its seq "
                         "ranks; the model's config must name "
                         "seq_axis='seq' to run ring attention")


def seq_positions(b: int, s: int, seq_axis: Optional[str], device,
                  segment_ids=None, positions=None) -> torch.Tensor:
    """[B, S] RoPE positions of this rank's tokens: ``positions`` when
    given (the batch's, global), else the ids' per-document positions
    or ``arange``, offset by the block's start under the ring. Packed
    rows split over seq ranks need the batch's positions: a document
    may begin on an earlier rank."""
    if positions is not None:
        return positions.to(device)
    my, n = seq_shard(seq_axis) if seq_axis else (0, 1)
    if segment_ids is not None:
        if n > 1:
            raise ValueError("packed rows split over seq ranks need the "
                             "batch's global 'positions' (shard_batch adds "
                             "them)")
        from dlrover_tpu_torch.models.common import segment_positions

        return segment_positions(segment_ids)
    return (torch.arange(s, device=device) + my * s).expand(b, s)


# -- the blockwise plain attend (use_flash=False) -----------------------------


def _chunk_mask(causal, prefix, seg_q, seg_kc, col0, bk, s_q, s_k, device):
    """Where scores of one K/V chunk (columns ``[col0, col0 + bk)``) are
    kept, broadcastable to [B, H_kv, G, S_q, bk]; None: all kept."""
    cols = torch.arange(col0, col0 + bk, device=device)
    allowed = None
    if causal or prefix is not None:
        rows = torch.arange(s_q, device=device)[:, None]
        allowed = ((rows >= cols[None, :]) if causal else torch.zeros(
            (s_q, bk), dtype=torch.bool, device=device))[None]
        if prefix is not None:
            allowed = allowed | (cols[None, None, :]
                                 < prefix.long()[:, None, None])
        allowed = allowed[:, None, None]
    if col0 + bk > s_k:  # the padded keys
        pad = (cols < s_k)[None, None, None, None, :]
        allowed = pad if allowed is None else allowed & pad
    if seg_q is not None:
        same = (seg_q[:, None, None, :, None]
                == seg_kc[:, None, None, None, :])
        allowed = same if allowed is None else allowed & same
    return allowed


def _chunks(k, v, seg_k, block_k):
    """K/V (and their ids) padded to whole chunks of ``bk`` keys, with
    the ids' pad a sentinel no query carries: (bk, number of chunks, k,
    v, seg_k)."""
    s_k = k.shape[2]
    bk = min(block_k, s_k)
    pad = (-s_k) % bk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if seg_k is not None:
            seg_k = torch.nn.functional.pad(seg_k, (0, pad), value=-2)
    return bk, (s_k + pad) // bk, k, v, seg_k


def blockwise_attend_lse(q, k, v, *, causal: bool, scale: float,
                         block_k: int = 512, seg_q=None, seg_k=None,
                         prefix=None):
    """(out f32 [B, H, S_q, D], lse f32 [B, H, S_q]) by a loop over K/V
    chunks carrying (acc, m, l), the reference's ``_xla_attend_lse``:
    peak memory O(S_q block_k) a head. GQA-aware. ``prefix`` [B]: keys
    with column < prefix are visible to every query (OR-ed with the
    causal mask when ``causal``; alone, the column bound of a future
    shard). A row that sees no key gets out 0 and lse NEG_INF."""
    if seg_q is not None and seg_k is None:
        seg_k = seg_q
    b, h, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    g = h // hkv
    bk, nk, k, v, seg_k = _chunks(k, v, seg_k, block_k)
    qf = q.reshape(b, hkv, g, s_q, d).float()
    acc = torch.zeros_like(qf)
    m = torch.full(qf.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros(qf.shape[:-1], device=q.device)
    for j in range(nk):
        kj = k[:, :, j * bk:(j + 1) * bk].float()
        vj = v[:, :, j * bk:(j + 1) * bk].float()
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kj) * scale
        allowed = _chunk_mask(causal, prefix, seg_q,
                              None if seg_k is None else
                              seg_k[:, j * bk:(j + 1) * bk],
                              j * bk, bk, s_q, s_k, q.device)
        if allowed is not None:
            s = torch.where(allowed, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.clamp(m_new, min=NEG_INF / 2)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(s <= NEG_INF / 2, 0.0, p)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, torch.exp(m - m_safe))
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqc,bkcd->bkgqd", p,
                                                    vj)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).reshape(b, h, s_q, d)
    lse = torch.where(l == 0.0, NEG_INF,
                      torch.clamp(m, min=NEG_INF / 2) + torch.log(l_safe))
    return out, lse.reshape(b, h, s_q)


def blockwise_attend_bwd(q, k, v, dout, lse, delta, *, causal: bool,
                         scale: float, block_k: int = 512, seg_q=None,
                         seg_k=None, prefix=None):
    """(dq, dk, dv) in f32 of one shard pair given the row lse and
    ``delta`` (the global ones in the ring): the same chunk loop over
    ``p = exp(s - lse)``, ``dS = p (dO V^T - delta) scale``."""
    if seg_q is not None and seg_k is None:
        seg_k = seg_q
    b, h, s_q, d = q.shape
    hkv, s_k = k.shape[1], k.shape[2]
    g = h // hkv
    bk, nk, k, v, seg_k = _chunks(k, v, seg_k, block_k)
    qf = q.reshape(b, hkv, g, s_q, d).float()
    do = dout.reshape(b, hkv, g, s_q, d).float()
    rows = lse.reshape(b, hkv, g, s_q)
    rows = torch.where(rows <= NEG_INF / 2, 0.0, rows)
    dl = delta.reshape(b, hkv, g, s_q)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for j in range(nk):
        kj = k[:, :, j * bk:(j + 1) * bk].float()
        vj = v[:, :, j * bk:(j + 1) * bk].float()
        s = torch.einsum("bkgqd,bkcd->bkgqc", qf, kj) * scale
        allowed = _chunk_mask(causal, prefix, seg_q,
                              None if seg_k is None else
                              seg_k[:, j * bk:(j + 1) * bk],
                              j * bk, bk, s_q, s_k, q.device)
        if allowed is not None:
            s = torch.where(allowed, s, NEG_INF)
        p = torch.exp(s - rows[..., None])
        dp = torch.einsum("bkgqd,bkcd->bkgqc", do, vj)
        ds = p * (dp - dl[..., None]) * scale
        dq = dq + torch.einsum("bkgqc,bkcd->bkgqd", ds, kj)
        dks.append(torch.einsum("bkgqc,bkgqd->bkcd", ds, qf))
        dvs.append(torch.einsum("bkgqc,bkgqd->bkcd", p, do))
    dk = torch.cat(dks, dim=2)[:, :, :s_k]
    dv = torch.cat(dvs, dim=2)[:, :, :s_k]
    return dq.reshape(b, h, s_q, d), dk, dv


# -- one shard pair -------------------------------------------------------------


@dataclass(frozen=True)
class Step:
    """The mask of one (local q x visiting K/V) shard pair: ``causal``;
    the q-side and k-side segment ids (the pair form); ``prefix`` [B]
    int32 (causal: the prefix-LM rule with the shard-local prompt; not
    causal: the column bound of a future shard). ``mode`` names it for
    the launch counts: "causal", "full", "seg", "seg_full", "pfx",
    "bound"."""

    mode: str
    causal: bool
    seg_q: Optional[torch.Tensor] = None
    seg_k: Optional[torch.Tensor] = None
    prefix: Optional[torch.Tensor] = None


def _flash_ids(step: Step):
    """(seg_q, seg_k, prefix_len, the ids' tile table) as the flash
    launch helpers take them. The column bound runs the pair-segmented
    kernels with q ids 0 and k ids ``col >= bound``: no new kernel."""
    if step.prefix is not None and not step.causal:
        raise AssertionError("the column bound travels as pair ids")
    if step.seg_q is not None:
        return (step.seg_q, step.seg_k, None,
                fa.segment_tiles(step.seg_q, step.seg_k))
    return None, None, step.prefix, None


def _attend(q, k, v, step: Step, impl: str, scale: float, block_k: int):
    """(out f32, lse f32) of one shard pair."""
    if impl == "blockwise":
        return blockwise_attend_lse(q, k, v, causal=step.causal,
                                    scale=scale, block_k=block_k,
                                    seg_q=step.seg_q, seg_k=step.seg_k,
                                    prefix=step.prefix)
    out, lse = fa._launch_fwd(q, k, v, step.causal, scale,
                              *_flash_ids(step))
    return out.float(), lse


def _attend_bwd(q, k, v, dout, lse, delta, step: Step, impl: str,
                scale: float, block_k: int):
    """(dq, dk, dv) of one shard pair given the global lse and delta."""
    if impl == "blockwise":
        return blockwise_attend_bwd(q, k, v, dout, lse, delta,
                                    causal=step.causal, scale=scale,
                                    block_k=block_k, seg_q=step.seg_q,
                                    seg_k=step.seg_k, prefix=step.prefix)
    ids = _flash_ids(step)
    dk, dv = fa._launch_bwd_dkv(q, k, v, dout, lse, delta, step.causal,
                                scale, *ids)
    dq = fa._launch_bwd_dq(q, k, v, dout, lse, delta, step.causal, scale,
                           *ids)
    return dq, dk, dv


def _merge_lse(o, lse, o_i, lse_i):
    """The online-softmax merge, shared by every ring body. A fully
    masked contribution (lse_i NEG_INF) merges as a no-op."""
    lse_new = torch.logaddexp(lse, lse_i)
    o_new = (o * torch.exp(lse - lse_new)[..., None]
             + o_i * torch.exp(lse_i - lse_new)[..., None])
    return o_new, lse_new


# -- the ring -------------------------------------------------------------------


@dataclass
class RingPlan:
    """What the ring's two passes share: the group (``n`` ranks, this
    one ``my``), the mask family (``causal``, the local segment ids,
    the global ``prefix_len`` on the device and on the host), the impl
    and the scale. ``step(owner)`` is the host's decision for the shard
    of rank ``owner``."""

    group: object
    n: int
    my: int
    causal: bool
    impl: str
    scale: float
    block_k: int = 512
    seg: Optional[torch.Tensor] = None
    prefix: Optional[torch.Tensor] = None
    prefix_host: Optional[List[int]] = None
    s_local: int = 0
    overlap: bool = True

    def step(self, owner: int, seg_k=None) -> Optional[Step]:
        """The mask of the visiting shard of rank ``owner`` (``seg_k``:
        its ids when packed), or None when it contributes nothing."""
        diag, past = owner == self.my, owner < self.my
        if self.prefix is not None:
            s = self.s_local
            if diag:
                p_loc = (self.prefix - self.my * s).clamp(0, s)
                return Step("pfx", True, prefix=p_loc.to(torch.int32))
            if past:
                return Step("full", False)
            # a future shard: its prompt columns only; none in any row
            # (the host copy says so) and it is skipped
            if self.prefix_host is not None and not any(
                    p - owner * s > 0 for p in self.prefix_host):
                return None
            p_vis = (self.prefix - owner * s).clamp(0, s)
            if self.impl == "blockwise":
                return Step("bound", False, prefix=p_vis.to(torch.int32))
            cols = torch.arange(s, device=self.prefix.device)
            seg_kp = (cols[None, :] >= p_vis[:, None]).to(torch.int32)
            return Step("bound", False, seg_q=torch.zeros_like(seg_kp),
                        seg_k=seg_kp)
        if self.causal and not diag and not past:
            return None
        causal = self.causal and diag
        if self.seg is not None:
            return Step("seg" if causal else "seg_full", causal,
                        seg_q=self.seg, seg_k=seg_k)
        return Step("causal" if causal else "full", causal)


def _shift(plan: RingPlan, xs):
    """``xs`` one rank forward, issued now (a ``Pending``)."""
    return ring.shift_async(xs, plan.group)


def _kv(plan: RingPlan, k, v):
    return (k, v) if plan.seg is None else (k, v, plan.seg)


def _ring_forward(q, k, v, plan: RingPlan):
    """(out in q's dtype, lse f32) over the ring."""
    n, my = plan.n, plan.my
    cur = _kv(plan, k, v)
    pending = _shift(plan, cur) if plan.overlap else None
    step = plan.step(my, plan.seg)
    o, lse = _attend(q, k, v, step, plan.impl, plan.scale, plan.block_k)
    for t in range(1, n):
        cur = pending.wait() if plan.overlap else _shift(plan, cur).wait()
        if plan.overlap and t < n - 1:
            pending = _shift(plan, cur)
        owner = (my - t) % n
        step = plan.step(owner, cur[2] if plan.seg is not None else None)
        if step is None:
            continue
        o_i, lse_i = _attend(q, cur[0], cur[1], step, plan.impl, plan.scale,
                             plan.block_k)
        o, lse = _merge_lse(o, lse, o_i, lse_i)
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, out, lse, dout, plan: RingPlan):
    """(dq, dk, dv) over the ring: K/V rotate again, each with its f32
    dK/dV accumulator, which one last shift brings home."""
    n, my = plan.n, plan.my
    dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1).contiguous()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    acc = (torch.zeros(k.shape, dtype=torch.float32, device=k.device),
           torch.zeros(v.shape, dtype=torch.float32, device=v.device))
    cur = _kv(plan, k, v)
    pend_acc = pend_kv = None
    for t in range(n):
        if plan.overlap and t < n - 1:
            pend_kv = _shift(plan, cur)
        step = plan.step((my - t) % n,
                         cur[2] if plan.seg is not None else None)
        grads = None
        if step is not None:
            grads = _attend_bwd(q, cur[0], cur[1], dout, lse, delta, step,
                                plan.impl, plan.scale, plan.block_k)
        if plan.overlap and t > 0:
            acc = pend_acc.wait()
        if grads is not None:
            dq = dq + grads[0].float()
            acc = (acc[0] + grads[1].float(), acc[1] + grads[2].float())
        pend_acc = _shift(plan, acc)
        if not plan.overlap:
            acc = pend_acc.wait()
        if t < n - 1:
            cur = pend_kv.wait() if plan.overlap else _shift(plan,
                                                             cur).wait()
    if plan.overlap:
        acc = pend_acc.wait()
    return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype)


class _Ring(torch.autograd.Function):
    """The ring's forward and backward as one node of the graph (see
    the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, plan: RingPlan):
        with _disable_current_modes():
            out, lse = _ring_forward(q, k, v, plan)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan = plan
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with _disable_current_modes():
            dq, dk, dv = _ring_backward(q, k, v, out, lse, dout, ctx.plan)
        return dq, dk, dv, None


def _host_prefix(prefix_len, prefix_host) -> Optional[List[int]]:
    """The prompt lengths on the host for the skip decisions: the host
    copy given, else ``prefix_len`` itself when it lies on the CPU;
    None on the meta device (every future shard is then attended, an
    upper bound on the count). Lengths on a card raise: reading them
    would wait for the device inside the step."""
    host = (prefix_len if prefix_host is None
            else torch.as_tensor(prefix_host))
    if host.device.type == "meta":
        return None
    if host.device.type != "cpu":
        raise ValueError(f"the prefix ring needs the prompt lengths on the "
                         f"host (prefix_host=, which parallel.accelerate's "
                         f"shard_batch keeps as {PREFIX_HOST!r})")
    return [int(p) for p in host.tolist()]


def _diagonal(q, k, v, causal, scale, impl, block_k, segment_ids,
              prefix_len):
    """The ring of one rank: the diagonal call alone (the model's own
    flash call when ``impl`` is "flash")."""
    if impl == "flash":
        if prefix_len is not None:
            return fa.flash_attention_prefix(q, k, v, prefix_len, scale)
        if segment_ids is not None:
            return fa.flash_attention_segmented(q, k, v, segment_ids,
                                                causal, scale)
        return fa.flash_attention(q, k, v, causal, scale)
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    out, _ = blockwise_attend_lse(q, k, v, causal=causal, scale=scale,
                                  block_k=block_k, seg_q=seg, seg_k=seg,
                                  prefix=prefix_len)
    return out.to(q.dtype)


def ring_attention_local(
    q: torch.Tensor,  # local shard [B, H, S_local, D]
    k: torch.Tensor,  # [B, H_kv, S_local, D]
    v: torch.Tensor,
    group=None,
    causal: bool = True,
    scale: Optional[float] = None,
    impl: str = "flash",
    block_k: int = 512,
    segment_ids: Optional[torch.Tensor] = None,  # local [B, S_local]
    prefix_len: Optional[torch.Tensor] = None,  # [B] GLOBAL prompt lengths
    prefix_host: Optional[Sequence[int]] = None,  # prefix_len on the host
    overlap: bool = True,
) -> torch.Tensor:
    """The per-rank body over ``group`` (the seq ranks, in ring order;
    None: the world). Rank i holds global positions ``[i S_local, (i+1)
    S_local)`` of every row. ``prefix_len`` (GLM's prefix-LM rule, ``j
    <= i or j < prefix``) needs ``causal`` and no ``segment_ids``."""
    if impl not in ("flash", "blockwise"):
        raise ValueError(f"unknown ring impl {impl!r}: 'flash' or "
                         f"'blockwise'")
    if prefix_len is not None and (not causal or segment_ids is not None):
        raise ValueError("prefix_len needs causal=True and no segment_ids "
                         "(prefix-LM is a causal-family mask; packed prefix "
                         "rows use the dense segmented path)")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return _diagonal(q, k, v, causal, scale, impl, block_k, segment_ids,
                         prefix_len)
    plan = ring_plan(q, group, causal, scale, impl, block_k, segment_ids,
                     prefix_len, prefix_host, overlap)
    return _Ring.apply(q.contiguous(), k.contiguous(), v.contiguous(), plan)


def ring_plan(q, group, causal: bool, scale: float, impl: str = "flash",
              block_k: int = 512, segment_ids=None, prefix_len=None,
              prefix_host=None, overlap: bool = True) -> RingPlan:
    """The ``RingPlan`` of ``ring_attention_local``'s arguments over
    ``group`` (of more than one rank)."""
    return RingPlan(
        group=group, n=dist.get_world_size(group), my=dist.get_rank(group),
        causal=bool(causal), impl=impl, scale=float(scale), block_k=block_k,
        seg=None if segment_ids is None else fa._ids(segment_ids),
        prefix=None if prefix_len is None else fa._ids(prefix_len),
        prefix_host=(None if prefix_len is None
                     else _host_prefix(prefix_len, prefix_host)),
        s_local=q.shape[2], overlap=bool(overlap))


def ring_attention(
    q: torch.Tensor,  # this rank's [B, H, S_local, D]
    k: torch.Tensor,  # [B, H_kv, S_local, D]
    v: torch.Tensor,
    mesh,
    axis_name: str = "seq",
    causal: bool = True,
    scale: Optional[float] = None,
    impl: str = "flash",
    block_k: int = 512,
    segment_ids: Optional[torch.Tensor] = None,
    prefix_len: Optional[torch.Tensor] = None,
    prefix_host: Optional[Sequence[int]] = None,
    overlap: bool = True,
) -> torch.Tensor:
    """The ring over ``mesh``'s ``axis_name`` group (a
    ``parallel.mesh.ProcessMesh``; None or an axis of size 1: the
    diagonal call alone). Rows stay split over the batch axes, as the
    reference's ``shard_map`` keeps them. A tensor axis > 1 raises
    (ROADMAP A15)."""
    sizes = mesh.sizes if mesh is not None else {}
    if sizes.get("tensor", 1) > 1:
        raise NotImplementedError("ring attention over a tensor-parallel "
                                  "mesh is not ported yet (ROADMAP A15)")
    if sizes.get(axis_name, 1) <= 1:
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        return _diagonal(q, k, v, causal, scale, impl, block_k, segment_ids,
                         prefix_len)
    return ring_attention_local(
        q, k, v, mesh.group((axis_name,)), causal=causal, scale=scale,
        impl=impl, block_k=block_k, segment_ids=segment_ids,
        prefix_len=prefix_len, prefix_host=prefix_host, overlap=overlap)
