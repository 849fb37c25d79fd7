"""Mixture-of-Experts: router, capacity dispatches, the dropless grouped
dispatch and its expert-parallel form (port of ``dlrover_tpu/ops/moe.py``).

Four dispatches share one routing core (``_routing``):

- ``"gather"`` (the ``LlamaConfig`` default): a slot->token index map
  built from small int scatters turns dispatch into a gather of the
  token matrix and combine into a gather of the expert outputs.
- ``"einsum"`` (the oracle): one-hot [T, E, C] dispatch/combine
  einsums, quadratic in tokens; what the fast paths are tested against.
- ``"grouped"`` (DROPLESS): rows sorted by expert, each group padded to
  whole row tiles, and the expert FFN as two grouped products through
  the Hopper kernels of ``ops.grouped_matmul``. No capacity, no dropped
  tokens, and no host sync: every shape is a static bound, so the
  routing never decides a shape.
- ``"grouped_ep"`` (DROPLESS, experts sharded over the ranks of an
  expert group): each rank routes its own tokens, exchanges per-expert
  counts and then the token rows with its peers (``ops.ring``), runs
  the grouped products on its E/P local experts and sends the results
  back. ``dispatch_chunks`` C > 1 splits the row exchange into C chunks
  moved by the ring; ``precision`` "fp8" carries block-scaled e4m3 rows
  on the wire in both directions, consumed by the dequant-in-kernel
  grouped matmul (B6). With no expert group of size > 1 it runs
  ``"grouped"``, the same math on one rank.

Randomness: ``router_jitter`` draws from an explicit
``torch.Generator`` (``rng``); a test that compares with the reference
hands both the same noise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.ops.grouped_matmul import (
    grouped_matmul,
    grouped_matmul_quantized,
)
from dlrover_tpu_torch.ops.quantize import (
    PRECISIONS,
    dequantize_block_scaled,
    quantize_block_scaled,
)
from dlrover_tpu_torch.ops.shard_compat import (
    ambient_mesh_with_axes,
    fp8_wire_supported,
)

logger = get_logger("ops.moe")

# metric keys surfaced to callers of ``moe_ffn``; _routing carries two
# more (the aux loss's per-expert fractions)
PUBLIC_METRICS = ("dropped_frac", "expert_load")
DISPATCHES = ("gather", "einsum", "grouped", "grouped_ep")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


@dataclass
class MoEConfig:
    num_experts: int
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    top_k: int = 1  # 1 = switch routing, 2 = gshard-style
    aux_loss_weight: float = 0.01
    router_jitter: float = 0.0  # multiplicative logit noise during training
    # "gather" | "einsum" | "grouped" | "grouped_ep"
    dispatch: str = "gather"
    # the reference's Pallas interpret switch; the kernels here run on
    # CUDA tensors and the plain versions on CPU ones, so it is ignored
    kernel_interpret: Optional[bool] = None
    # "grouped_ep" only: the expert group's mesh axes, the mesh (a
    # parallel.mesh.ProcessMesh; None = the ambient one), the row
    # exchange's chunk count (0 = the Context's) and the wire precision
    # ("" = the Context's)
    ep_axes: Tuple[str, ...] = ("data", "fsdp")
    mesh: Any = None
    dispatch_chunks: int = 0
    precision: str = ""


def _capacity(num_tokens: int, num_experts: int, factor: float,
              top_k: int = 1) -> int:
    """Per-expert queue length, gshard convention: capacity scales with
    top_k."""
    return max(1, int(math.ceil(num_tokens * top_k * factor / num_experts)))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot rows; an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does. A comparison, so nothing reads the indices
    on the host."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).float()


Round = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _routing(
    logits: torch.Tensor,  # [T, E]
    capacity: int,
    top_k: int,
    rng: Optional[torch.Generator],
    jitter: float,
) -> Tuple[List[Round], torch.Tensor, Dict[str, torch.Tensor]]:
    """Shared routing core: per-round (expert, position, keep, gate).

    Round-by-round filling (all k=0 choices claim queue positions before
    any k=1 choice) with arrival-order priority inside a round. Returns
    (rounds, aux_loss, metrics); each round is (expert_idx [T] int64,
    pos [T] int32, keep [T] f32, gate [T] f32).
    """
    t, e = logits.shape
    if rng is not None and jitter > 0.0:
        noise = torch.empty(logits.shape, dtype=torch.float32,
                            device=rng.device).uniform_(
                                1.0 - jitter, 1.0 + jitter, generator=rng)
        logits = logits * noise.to(logits.device)
    probs = torch.softmax(logits.float(), dim=-1)  # [T, E]

    remaining = probs
    expert_fill = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    total_onehot = torch.zeros((t, e), device=probs.device)
    kept_per_expert = torch.zeros((e,), device=probs.device)
    rounds = []
    for _ in range(top_k):
        idx = remaining.argmax(dim=-1)  # [T]; ties go to the first
        onehot = _one_hot(idx, e)
        # position of each token within its expert's queue (arrival order)
        pos_in_expert = (onehot.cumsum(dim=0) - onehot) * onehot
        pos_in_expert = pos_in_expert + expert_fill[None, :] * onehot
        within = (pos_in_expert < capacity).float() * onehot
        pos = pos_in_expert.sum(dim=-1).int()
        keep = within.sum(dim=-1)  # 1.0 = assigned a queue slot
        gate = (probs * onehot).sum(dim=-1)
        rounds.append((idx, pos, keep, gate))
        expert_fill = expert_fill + within.sum(dim=0).int()
        kept_per_expert = kept_per_expert + within.sum(dim=0)
        total_onehot = total_onehot + onehot
        remaining = remaining * (1.0 - onehot)

    # load-balance auxiliary loss (switch transformer eq. 4)
    frac_tokens = total_onehot.mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux_loss = e * torch.sum(frac_tokens * frac_probs) / max(1, top_k)
    metrics = {
        # fraction of (token, round) assignments that overflowed capacity
        "dropped_frac": 1.0 - kept_per_expert.sum() / float(t * top_k),
        # pre-drop routing demand per expert, as a fraction; uniform 1/E
        "expert_load": total_onehot.sum(dim=0) / float(t * top_k),
        "frac_tokens": frac_tokens,
        "frac_probs": frac_probs,
    }
    return rounds, aux_loss, metrics


def router_dispatch(logits: torch.Tensor, capacity: int, top_k: int = 1,
                    rng: Optional[torch.Generator] = None,
                    jitter: float = 0.0):
    """(dispatch_mask [T,E,C], combine_weights [T,E,C], aux_loss): the
    materialised form of ``_routing``; overflowing tokens are dropped
    (zero combine weight, the residual path carries them)."""
    t, e = logits.shape
    rounds, aux_loss, _ = _routing(logits, capacity, top_k, rng, jitter)
    dispatch, combine = _materialize(rounds, t, e, capacity)
    return dispatch, combine, aux_loss


def _materialize(rounds, t: int, e: int, capacity: int):
    """[T,E,C] one-hot dispatch/combine from routing rounds."""
    device = rounds[0][0].device
    dispatch = torch.zeros((t, e, capacity), device=device)
    combine = torch.zeros((t, e, capacity), device=device)
    for idx, pos, keep, gate in rounds:
        within = _one_hot(idx, e) * keep[:, None]
        slot = within[:, :, None] * _one_hot(pos, capacity)[:, None, :]
        dispatch = dispatch + slot
        combine = combine + gate[:, None, None] * slot
    return dispatch, combine


def _moe_compute_einsum(params, xt, rounds, capacity, e, activation):
    """[T,E,C] one-hot dispatch/combine (the reference check)."""
    t = xt.shape[0]
    dispatch, combine = _materialize(rounds, t, e, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch.to(xt.dtype), xt)
    h = activation(torch.einsum("ecd,edf->ecf", expert_in,
                                params["experts"]["up"]["kernel"]))
    expert_out = torch.einsum("ecf,efd->ecd", h,
                              params["experts"]["down"]["kernel"])
    return torch.einsum("tec,ecd->td", combine.to(xt.dtype), expert_out)


def _moe_compute_gather(params, xt, rounds, capacity, e, activation):
    """Slot-indexed dispatch/combine (the capacity fast path): a
    [E*C+1] slot->token map (dropped tokens write the sentinel slot,
    empty slots read the zero sentinel token), then gathers."""
    t, d = xt.shape
    n_slots = e * capacity
    token_ids = torch.arange(t, device=xt.device)
    slot_token = torch.full((n_slots + 1,), t, dtype=torch.long,
                            device=xt.device)
    for idx, pos, keep, _gate in rounds:
        flat = torch.where(keep > 0, idx * capacity + pos, n_slots)
        slot_token = slot_token.index_put((flat,), token_ids)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    expert_in = x_pad[slot_token[:n_slots]].view(e, capacity, d)
    h = activation(torch.einsum("ecd,edf->ecf", expert_in,
                                params["experts"]["up"]["kernel"]))
    expert_out = torch.einsum(
        "ecf,efd->ecd", h, params["experts"]["down"]["kernel"]
    ).reshape(n_slots, d)
    out = xt.new_zeros((t, d))
    for idx, pos, keep, gate in rounds:
        flat = (idx * capacity + pos).clamp(0, n_slots - 1)
        weight = (gate * keep).to(xt.dtype)[:, None]
        out = out + expert_out[flat] * weight
    return out


@dataclass
class GroupedLayout:
    """Where the grouped dispatch puts each (token, round) assignment:
    ``row`` [n] its row among the ``rows`` sorted, tile-padded rows;
    ``token`` [n] and ``gate`` [n] f32 its token and gate;
    ``row_token`` [rows] the token each row reads (``t``, the zero
    sentinel, for pad rows); ``tile_expert`` [rows / block_t] int32."""

    row: torch.Tensor
    token: torch.Tensor
    gate: torch.Tensor
    row_token: torch.Tensor
    tile_expert: torch.Tensor
    rows: int


def grouped_layout(rounds, t: int, e: int, block_t: int) -> GroupedLayout:
    """Sort the assignments by expert, each group padded to whole row
    tiles, without a host sync: the row count is the static bound
    ceil(T*k / bt)*bt + E*bt, and every index is computed on the
    device."""
    k = len(rounds)
    n = t * k
    device = rounds[0][0].device
    # assignments in round-major arrival order (_routing's queue
    # discipline: every k=0 choice precedes any k=1 choice)
    expert_a = torch.cat([r[0] for r in rounds])  # [n]
    gate_a = torch.cat([r[3] for r in rounds])  # [n] f32
    token_a = torch.arange(t, device=device).repeat(k)
    # with capacity == T nothing overflows, so _routing's queue
    # positions ARE each assignment's within-expert arrival rank
    rank = torch.cat([r[1] for r in rounds]).long()
    counts = torch.zeros((e,), dtype=torch.long, device=device).index_add_(
        0, expert_a, torch.ones_like(expert_a))
    # every expert gets at least one tile, even with no routed token, as
    # the reference's dw kernel needs (B5 here would write zeros anyway)
    padded = ((counts + block_t - 1) // block_t).clamp_min(1) * block_t
    ends = padded.cumsum(0)
    row = ends[expert_a] - padded[expert_a] + rank  # unique per assignment
    rows = ((n + block_t - 1) // block_t) * block_t + e * block_t
    row_token = torch.full((rows,), t, dtype=torch.long, device=device)
    row_token = row_token.index_put((row,), token_a)
    # tile i belongs to the expert whose [offset, end) span covers it;
    # tiles past the last group clip to the final expert (their rows are
    # zero sentinels whose outputs the un-sort never reads)
    tile_start = torch.arange(rows // block_t, device=device) * block_t
    tile_expert = torch.searchsorted(ends, tile_start, right=True).clamp(
        0, e - 1).int()
    return GroupedLayout(row, token_a, gate_a, row_token, tile_expert, rows)


def _moe_compute_grouped(params, xt, rounds, e, activation,
                         block_t: int = 128):
    """DROPLESS dispatch through the grouped-matmul kernels: every
    (token, round) assignment is served; static shapes, no host sync."""
    t, d = xt.shape
    lay = grouped_layout(rounds, t, e, block_t)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))], dim=0)
    x_sorted = x_pad[lay.row_token]
    h = activation(grouped_matmul(
        x_sorted, params["experts"]["up"]["kernel"], lay.tile_expert,
        block_t, 512))
    y_sorted = grouped_matmul(h, params["experts"]["down"]["kernel"],
                              lay.tile_expert, block_t, 512)
    # combine: un-sort, weight by the gate, sum each token's k rounds.
    # index_add_ is atomic on CUDA; with k <= 2 each token adds at most
    # two rows onto zero, and a + b rounds the same in either order, so
    # the result does not depend on the order (it would for k > 2)
    y_a = y_sorted[lay.row] * lay.gate[:, None].to(y_sorted.dtype)
    return xt.new_zeros((t, d)).index_add(0, lay.token, y_a.to(xt.dtype))


def check_dispatch(config: MoEConfig) -> None:
    """Raises for an unknown dispatch or wire precision."""
    if config.dispatch not in DISPATCHES:
        raise ValueError(
            f"unknown MoE dispatch {config.dispatch!r}; choose "
            f"'gather' (fast, capacity), 'einsum' (reference oracle), "
            f"'grouped' (dropless kernels, per-device experts) or "
            f"'grouped_ep' (dropless + expert-parallel all-to-all)"
        )
    p = (config.precision or "").strip()
    if p and p not in PRECISIONS:
        raise ValueError(
            f"unknown MoE precision {p!r}; choose one of {PRECISIONS}")


def _resolve_ep_mesh(config: MoEConfig):
    """(mesh, axes, ep_degree) for ``dispatch="grouped_ep"``; ``(None,
    axes, 1)`` when no expert group of size > 1 exists (the caller then
    runs "grouped": the same math on one rank, e.g. after the world
    shrank to one)."""
    axes = tuple(config.ep_axes)
    mesh = config.mesh
    if mesh is None:
        mesh = ambient_mesh_with_axes(axes)
        if mesh is None:
            return None, axes, 1
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    missing = [a for a in axes if a not in sizes]
    if missing:
        raise ValueError(
            f"grouped_ep: mesh {tuple(mesh.axis_names)} lacks expert "
            f"submesh axes {missing}"
        )
    ep = math.prod(sizes[a] for a in axes)
    return (mesh, axes, ep) if ep > 1 else (None, axes, 1)


def resolve_dispatch_chunks(config: MoEConfig) -> int:
    """An explicit positive ``dispatch_chunks`` wins; 0 reads the
    Context knob (``DLROVER_TPU_DISPATCH_CHUNKS``)."""
    c = int(config.dispatch_chunks or 0)
    if c > 0:
        return c
    return max(1, int(get_context().dispatch_chunks))


def resolve_moe_precision(config: MoEConfig,
                          device: Optional[torch.device] = None) -> str:
    """An explicit ``precision`` wins; "" reads the Context knob
    (``DLROVER_TPU_MOE_PRECISION``). A quantized choice runs the bf16
    wire, with a warning, when ``device`` fails the fp8 probe."""
    p = (config.precision or "").strip()
    if not p:
        p = str(get_context().moe_precision or "bf16").strip()
    if p not in PRECISIONS:
        raise ValueError(
            f"unknown MoE precision {p!r}; choose one of {PRECISIONS}")
    if p != "bf16" and not fp8_wire_supported(device):
        logger.warning("moe precision %r requested but %s fails the fp8 "
                       "probe; running the bf16 wire", p, device)
        return "bf16"
    return p


@dataclass
class RegroupLayout:
    """Where ``_regroup_window`` puts the received rows of one chunk:
    ``row_src`` [rows] the received row (``ep * nc``, a zero sentinel,
    for pad rows) each sorted row reads; ``tile_expert`` [rows /
    block_t] int32; ``dest_row`` [P, nc] each received row's sorted row
    (``rows`` for an empty slot) and ``valid`` [P, nc] whether the slot
    holds a row; ``live_rows`` [1] int32, the padded end of the last
    local expert's group: every row from it on reads the sentinel (the
    reference computes them, "garbage compute, masked by unsort"; the
    grouped kernels skip them)."""

    row_src: torch.Tensor
    tile_expert: torch.Tensor
    dest_row: torch.Tensor
    valid: torch.Tensor
    rows: int
    live_rows: torch.Tensor


def regroup_layout(recv, lo: int, nc: int, ep: int, el: int,
                   block_t: int) -> RegroupLayout:
    """The layout of received block rows [lo, lo+nc) from every source,
    sorted by local expert, each expert's group padded to whole tiles
    (one sentinel tile at least), from the exchanged counts alone
    (``recv`` [P, el]): static shapes, no host sync."""
    device = recv.device
    recv = recv.long()
    csum = recv.cumsum(dim=1)  # [P, el]
    tot = csum[:, -1]  # [P] real rows per source block
    group_start = csum - recv  # [P, el] within-block group starts
    r_idx = lo + torch.arange(nc, device=device)
    le_r = torch.searchsorted(csum, r_idx.expand(ep, nc).contiguous(),
                              right=True)  # [P, nc]
    valid = r_idx[None, :] < tot[:, None]  # [P, nc]
    le_r = le_r.clamp(0, el - 1)
    src_rows = torch.arange(ep, device=device)[:, None]
    # rows of each (source, local expert) group inside this chunk's
    # window, and the group's start within it
    cnt = (csum.clamp(max=lo + nc) - group_start.clamp(min=lo)).clamp(0, nc)
    start = group_start[src_rows, le_r].clamp(min=lo)
    pre = cnt.cumsum(dim=0) - cnt  # earlier sources
    rank_r = pre[src_rows, le_r] + (r_idx[None, :] - start)
    m_le = cnt.sum(dim=0)  # [el] chunk rows per local expert
    padded = ((m_le + block_t - 1) // block_t).clamp_min(1) * block_t
    ends = padded.cumsum(0)
    offs = ends - padded
    # static bound: every group full plus its tile padding, and a
    # sentinel tile for every local expert
    tp = ((ep * nc + block_t - 1) // block_t) * block_t + el * block_t
    dest_row = torch.where(valid, offs[le_r] + rank_r,
                           torch.full_like(rank_r, tp))
    row_src = torch.full((tp + 1,), ep * nc, dtype=torch.long,
                         device=device).index_put(
        (dest_row.reshape(-1),), torch.arange(ep * nc, device=device))[:tp]
    tile_start = torch.arange(tp // block_t, device=device) * block_t
    tile_expert = torch.searchsorted(ends, tile_start, right=True).clamp(
        0, el - 1).int()
    return RegroupLayout(row_src, tile_expert, dest_row, valid, tp,
                         ends[-1:].int())


def _regroup_window(recv, lo, nc, up_l, down_l, *, x_chunk=None,
                    v_chunk=None, s_chunk=None, ep: int, el: int,
                    block_t: int, activation, out_dtype):
    """Received block rows [lo, lo+nc) from every source -> expert
    outputs in the same layout (invalid slots zero).

    All index math comes from the exchanged counts (``recv`` [P, el]),
    so every shape is static; at lo=0, nc=n this is the unchunked
    regroup. The rows arrive at full precision (``x_chunk`` [P, nc, D])
    or at wire precision (``v_chunk`` [P, nc, D] e4m3 and ``s_chunk``
    [P, nc, D/B] f32); the quantized form feeds the up-projection
    through B6, bitwise equal to dequantizing first. The products run in
    the rows' dtype (f32 for the quantized form), the weights cast to
    it, as the reference's kernels promote them.
    """
    quantized = v_chunk is not None
    rows = v_chunk if quantized else x_chunk
    d = rows.shape[-1]
    lay = regroup_layout(recv, lo, nc, ep, el, block_t)
    row_src, tile_expert, tp = lay.row_src, lay.tile_expert, lay.rows
    live = lay.live_rows  # the products skip the sentinel rows past it
    if quantized:
        # values and scales gathered by the same row map; pad rows read
        # zero sentinel rows on both sides (zero values decode to zero
        # under any scale)
        nb = s_chunk.shape[-1]
        v_pad = torch.cat([v_chunk.reshape(ep * nc, d),
                           v_chunk.new_zeros((1, d))])
        s_pad = torch.cat([s_chunk.reshape(ep * nc, nb),
                           s_chunk.new_zeros((1, nb))])
        h = activation(grouped_matmul_quantized(
            v_pad[row_src], s_pad[row_src], up_l.float(), tile_expert,
            block_t, live_rows=live))
    else:
        x_pad = torch.cat([x_chunk.reshape(ep * nc, d),
                           x_chunk.new_zeros((1, d))])
        h = activation(grouped_matmul(x_pad[row_src], up_l.to(rows.dtype),
                                      tile_expert, block_t, live_rows=live))
    y_sorted = grouped_matmul(h, down_l.to(h.dtype), tile_expert, block_t,
                              live_rows=live)
    # back to the chunk's receive layout (invalid slots zero)
    y_flat = y_sorted[lay.dest_row.clamp(0, tp - 1).reshape(-1)]
    y_flat = torch.where(lay.valid.reshape(-1)[:, None], y_flat,
                         y_flat.new_zeros(()))
    return y_flat.to(out_dtype).reshape(ep, nc, d)


def _exchange_fn(chunks: int):
    return ring.exchange_all_to_all if chunks <= 1 else ring.exchange_ring


def _quantized_dispatch_fwd(x_send3, up_l, down_l, recv, group, ep, el,
                            chunks, block_t, precision, activation):
    """Forward of the quantized row dispatch: quantize -> exchange ->
    grouped products -> quantize -> reverse exchange -> dequantize.

    Returns (y [P, n, D] f32, residual): the received wire rows, the
    cheapest exact record of what the products consumed. "fp8" moves
    (values, scales); "fp8_qdq" applies the same quantize -> dequantize
    at the source of every exchange and moves f32 rows, bitwise the
    same result (quantization is per row, the exchange a permutation of
    rows). C = 1 is one chunk over the one-shot exchange; C > 1 runs the
    chunks over the ring, chunk c+1's rows issued before chunk c's
    products as in the reference's schedule."""
    n = x_send3.shape[1]
    wire_fp8 = precision == "fp8"
    v, s = quantize_block_scaled(x_send3)

    def gemms(vc, sc, xc, lo, nc):
        return _regroup_window(
            recv, lo, nc, up_l, down_l, x_chunk=xc, v_chunk=vc, s_chunk=sc,
            ep=ep, el=el, block_t=block_t, activation=activation,
            out_dtype=torch.float32)

    def exch(a):
        return _exchange_fn(chunks)(a, group)

    nc = n // chunks

    def wire_in(c):
        """Issue chunk c's exchange."""
        lo, hi = c * nc, (c + 1) * nc
        if wire_fp8:
            return exch(v[:, lo:hi]), exch(s[:, lo:hi])
        return (exch(dequantize_block_scaled(v[:, lo:hi], s[:, lo:hi])),)

    cur = wire_in(0)
    parts, res_a, res_b = [], [], []
    for c in range(chunks):
        nxt = wire_in(c + 1) if c + 1 < chunks else None
        if wire_fp8:
            vr_c, sr_c = cur
            y_c = gemms(vr_c, sr_c, None, c * nc, nc)
            res_a.append(vr_c)
            res_b.append(sr_c)
        else:
            (xr_c,) = cur
            y_c = gemms(None, None, xr_c, c * nc, nc)
            res_a.append(xr_c)
        wv, ws = quantize_block_scaled(y_c)
        if wire_fp8:
            parts.append((exch(wv), exch(ws)))
        else:
            parts.append(dequantize_block_scaled(wv, ws))
        cur = nxt
    if wire_fp8:
        y = torch.cat([dequantize_block_scaled(pv, ps) for pv, ps in parts],
                      dim=1)
        return y, (torch.cat(res_a, dim=1), torch.cat(res_b, dim=1))
    return (torch.cat([exch(p) for p in parts], dim=1),
            (torch.cat(res_a, dim=1), None))


class _QuantizedDispatch(torch.autograd.Function):
    """The quantized row dispatch, differentiable end to end: the wire
    carries block-scaled fp8 in both directions (rows forward,
    cotangents backward).

    Autograd cannot run through an fp8 primal, so this is one Function:
    the backward replays the dequant-space compute on the saved wire
    rows under ``torch.enable_grad`` and takes its gradients with
    ``torch.autograd.grad`` (the reference's ``jax.vjp``), and wires
    each cotangent exchange through the same quantize -> exchange ->
    dequantize as the forward (straight-through at the quantize step).
    "fp8_qdq" shares this code with the wire at full precision, which is
    why fp8 and fp8_qdq agree bitwise."""

    @staticmethod
    def forward(ctx, x_send3, up_l, down_l, recv, group, ep, el, chunks,
                block_t, precision, activation):
        y, (res_a, res_b) = _quantized_dispatch_fwd(
            x_send3, up_l, down_l, recv, group, ep, el, chunks, block_t,
            precision, activation)
        ctx.save_for_backward(res_a, res_b, up_l, down_l, recv)
        ctx.meta = (group, ep, el, chunks, block_t, precision, activation,
                    x_send3.dtype)
        return y

    @staticmethod
    def backward(ctx, g):
        (group, ep, el, chunks, block_t, precision, activation,
         x_dtype) = ctx.meta
        res_a, res_b, up_l, down_l, recv = ctx.saved_tensors
        n = g.shape[1]
        wire_fp8 = precision == "fp8"
        # the same wire as the forward; chunk windows act per row, so one
        # whole-array ring is bitwise the per-chunk concatenation
        exch = _exchange_fn(chunks)

        def wire(a):
            gv, gs = quantize_block_scaled(a)
            if wire_fp8:
                return dequantize_block_scaled(exch(gv, group),
                                               exch(gs, group))
            return exch(dequantize_block_scaled(gv, gs), group)

        # the return exchange's backward: send layout -> receive layout
        g_y = wire(g.float())
        # the dequant-space input the forward consumed: the decoded fp8
        # residual, or the reference's received rows as they are (bitwise
        # the same array)
        x_deq = (dequantize_block_scaled(res_a, res_b) if wire_fp8
                 else res_a)
        with torch.enable_grad():
            xd = x_deq.detach().requires_grad_()
            up = up_l.detach().requires_grad_()
            down = down_l.detach().requires_grad_()
            nc = n // max(1, chunks)
            y = torch.cat([
                _regroup_window(
                    recv, c * nc, nc, up, down,
                    x_chunk=xd[:, c * nc:(c + 1) * nc], ep=ep, el=el,
                    block_t=block_t, activation=activation,
                    out_dtype=torch.float32)
                for c in range(max(1, chunks))], dim=1)
            gx_deq, dup, ddown = torch.autograd.grad(y, (xd, up, down), g_y)
        # the row exchange's backward: receive layout -> send layout
        gx = wire(gx_deq).to(x_dtype)
        return (gx, dup, ddown) + (None,) * 8


@dataclass
class SendLayout:
    """Where ``grouped_ep`` puts each local (token, round) assignment in
    the [P, n] send buffer: ``counts`` [P, el] rows for each (destination
    rank, local expert); ``send_pos`` [n] each assignment's slot, its
    ``token`` [n] and ``gate`` [n] f32; ``send_token`` [P n] the token
    each slot reads (``t``, the zero sentinel, for an empty one)."""

    counts: torch.Tensor
    send_pos: torch.Tensor
    token: torch.Tensor
    gate: torch.Tensor
    send_token: torch.Tensor


def send_layout(rounds, t: int, ep: int, el: int) -> SendLayout:
    """Block s of the send buffer holds the rows for rank s, grouped by
    its local experts in local arrival order (expert g lives on rank
    g // el as local expert g % el). ``rounds`` must come from
    ``_routing`` at capacity ``t``, so a round's queue positions are the
    per-expert arrival ranks."""
    n = t * len(rounds)
    device = rounds[0][0].device
    expert_a = torch.cat([r[0] for r in rounds])  # [n]
    gate_a = torch.cat([r[3] for r in rounds])  # [n] f32
    rank_a = torch.cat([r[1] for r in rounds]).long()
    token_a = torch.arange(t, device=device).repeat(len(rounds))
    dest, le_a = expert_a // el, expert_a % el
    counts = torch.zeros((ep, el), dtype=torch.long, device=device
                         ).index_put((dest, le_a), torch.ones_like(dest),
                                     accumulate=True)
    block_off = counts.cumsum(dim=1) - counts
    send_pos = dest * n + block_off[dest, le_a] + rank_a  # unique
    send_token = torch.full((ep * n,), t, dtype=torch.long,
                            device=device).index_put((send_pos,), token_a)
    return SendLayout(counts, send_pos, token_a, gate_a, send_token)


def _moe_compute_grouped_ep(params, xt, config: MoEConfig, activation,
                            mesh, axes: Tuple[str, ...], ep: int, rng,
                            jitter: float, block_t: int = 128,
                            chunks: int = 1, precision: str = "bf16"):
    """DROPLESS dispatch with experts sharded over the ranks of the
    expert group (``mesh.group(axes)``, P = ep ranks, el = E/P local
    experts). ``xt`` [Tl, D] is this rank's tokens and the expert leaves
    of ``params`` are this rank's [el, ...] blocks: rank r owns experts
    [r el, (r+1) el), as the reference shards the leading dim.

      1. route the local tokens over all E experts (router replicated);
         the aux loss's fractions are averaged over the group, so it
         equals the one-rank loss;
      2. exchange per-(destination rank, local expert) counts, so the
         receiver computes every row's tile-aligned place itself and
         all buffers keep static shapes;
      3. exchange the rows, [P, n, D] (n = Tl * top_k: block s holds the
         rows for rank s, grouped by its local experts in arrival
         order; n is the worst case, all rows to one rank);
      4. regroup by local expert and run the two grouped products;
      5. exchange back and combine (un-sort, gate, sum each token's
         rounds).

    ``chunks`` > 1 moves the rows of steps 3 and 5 in C chunks over the
    ring; per-row math is unchanged, so C changes no result. An
    indivisible C runs C = 1. Differentiable end to end: the exchanges'
    backward is the same exchange. Returns (out [Tl, D], aux_loss,
    metrics), ``dropped_frac`` identically 0.
    """
    group = mesh.group(axes)
    t, d = xt.shape
    e, top_k = config.num_experts, config.top_k
    if e % ep:
        raise ValueError(
            f"grouped_ep: num_experts={e} not divisible by the expert "
            f"group of {ep} ranks ({axes})")
    el = e // ep
    up_l = params["experts"]["up"]["kernel"]
    down_l = params["experts"]["down"]["kernel"]
    if up_l.shape[0] != el or down_l.shape[0] != el:
        raise ValueError(
            f"grouped_ep: each of {ep} ranks holds {el} of {e} experts, "
            f"but the expert weights are {tuple(up_l.shape)} and "
            f"{tuple(down_l.shape)}")
    chunks = max(1, int(chunks))
    n = t * top_k
    if chunks > 1 and (n % chunks or chunks > n):
        logger.warning("grouped_ep: dispatch_chunks=%d does not divide the "
                       "%d local assignment rows; running unchunked (C=1)",
                       chunks, n)
        chunks = 1
    device = xt.device
    logits = xt @ params["router"]["kernel"]  # [Tl, E]
    # capacity = Tl: nothing overflows, and the round positions are the
    # per-expert local arrival ranks
    rounds, _, metrics_l = _routing(logits, t, top_k, rng, jitter)
    lay = send_layout(rounds, t, ep, el)
    x_pad = torch.cat([xt, xt.new_zeros((1, d))])
    x_send3 = x_pad[lay.send_token].reshape(ep, n, d)  # pad rows: zeros
    # the counts: recv[s, le] = rows rank s sends for my local expert le.
    # Never quantized: the regroup's index math must be exact
    recv = ring.exchange_all_to_all(lay.counts, group)

    def regroup(x_chunk, lo, nc):
        return _regroup_window(recv, lo, nc, up_l, down_l, x_chunk=x_chunk,
                               ep=ep, el=el, block_t=block_t,
                               activation=activation, out_dtype=xt.dtype)

    if precision != "bf16":
        y_ret = _QuantizedDispatch.apply(
            x_send3, up_l, down_l, recv, group, ep, el, chunks, block_t,
            precision, activation).to(xt.dtype)
    elif chunks <= 1:
        x_recv = ring.all_to_all(x_send3, group)
        y_ret = ring.all_to_all(regroup(x_recv, 0, n), group)
    else:
        nc = n // chunks
        cur = ring.ring_all_to_all(x_send3[:, :nc], group)
        parts = []
        for c in range(chunks):
            nxt = (ring.ring_all_to_all(
                x_send3[:, (c + 1) * nc:(c + 2) * nc], group)
                if c + 1 < chunks else None)
            parts.append(ring.ring_all_to_all(regroup(cur, c * nc, nc),
                                              group))
            cur = nxt
        y_ret = torch.cat(parts, dim=1)
    # combine: each assignment's result sits at its own send_pos
    y_a = y_ret.reshape(ep * n, d)[lay.send_pos]
    out = xt.new_zeros((t, d)).index_add(
        0, lay.token, (y_a * lay.gate[:, None].to(y_a.dtype)).to(xt.dtype))
    # the aux loss from the group's routing fractions: the mean of
    # equal-sized local means is the global mean
    ft = ring.all_reduce_mean(metrics_l["frac_tokens"], group)
    fp = ring.all_reduce_mean(metrics_l["frac_probs"], group)
    aux = e * torch.sum(ft * fp) / max(1, top_k)
    load = ring.all_reduce_mean(metrics_l["expert_load"].detach(), group)
    metrics = {"dropped_frac": torch.zeros((), device=device),
               "expert_load": load}
    return out, aux.float(), metrics


def moe_ffn(
    params: dict,
    x: torch.Tensor,  # [B, S, D]
    config: MoEConfig,
    activation: Callable = gelu,
    train: bool = True,
    rng: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Switch-FFN block. params:
      router/kernel: [D, E]
      experts/up/kernel:   [E, D, F]
      experts/down/kernel: [E, F, D]
    ("grouped_ep" over P > 1 ranks: x is this rank's tokens and the
    expert leaves its own [E/P, ...] block.)
    Returns (output [B,S,D], aux_loss f32 scalar, metrics) with metrics
    {"dropped_frac" scalar, "expert_load" [E]}.
    """
    check_dispatch(config)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    jitter = config.router_jitter if train else 0.0
    dispatch = config.dispatch
    if dispatch == "grouped_ep":
        mesh, axes, ep = _resolve_ep_mesh(config)
        if ep > 1:
            out, aux, metrics = _moe_compute_grouped_ep(
                params, xt, config, activation, mesh, axes, ep, rng, jitter,
                chunks=resolve_dispatch_chunks(config),
                precision=resolve_moe_precision(config, x.device))
            return out.reshape(b, s, d), aux, metrics
        # no expert group of size > 1: the one-rank dropless path is the
        # same math
        dispatch = "grouped"
    logits = xt @ params["router"]["kernel"]  # [T, E]
    factor = config.capacity_factor if train else config.eval_capacity_factor
    if dispatch == "grouped":
        # DROPLESS: route with capacity = T, so nothing overflows and the
        # metrics report dropped_frac == 0
        capacity = t
    else:
        capacity = _capacity(t, config.num_experts, factor, config.top_k)
    rounds, aux, metrics = _routing(logits, capacity, config.top_k, rng,
                                    jitter)
    metrics = {k: metrics[k] for k in PUBLIC_METRICS}
    if dispatch == "grouped":
        out = _moe_compute_grouped(params, xt, rounds, config.num_experts,
                                   activation)
    else:
        compute = (_moe_compute_einsum if dispatch == "einsum"
                   else _moe_compute_gather)
        out = compute(params, xt, rounds, capacity, config.num_experts,
                      activation)
    return out.reshape(b, s, d), aux.float(), metrics


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int, dtype=torch.float32) -> dict:
    """Random router and expert weights on the generator's device (the
    reference's initialisers; torch draws other numbers)."""

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=generator.device)

    scale_in, scale_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "router": {"kernel": normal(d_model, num_experts) * scale_in},
        "experts": {
            "up": {"kernel": normal(num_experts, d_model, d_ff) * scale_in},
            "down": {"kernel": normal(num_experts, d_ff, d_model)
                     * scale_out},
        },
    }
