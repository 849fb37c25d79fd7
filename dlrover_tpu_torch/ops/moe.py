"""Mixture-of-Experts on one device: router, capacity dispatches and the
dropless grouped dispatch (port of the single-device part of
``dlrover_tpu/ops/moe.py``).

Three dispatches share one routing core (``_routing``):

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

``"grouped_ep"`` (experts sharded over devices, with ``all_to_all``),
its ``dispatch_chunks`` ring and its fp8 wire (``precision``) come with
the expert-parallel slice and raise here.

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

from dlrover_tpu_torch.ops.grouped_matmul import grouped_matmul

# metric keys surfaced to callers of ``moe_ffn``; _routing carries two
# more (the aux loss's per-expert fractions)
PUBLIC_METRICS = ("dropped_frac", "expert_load")
DISPATCHES = ("gather", "einsum", "grouped", "grouped_ep")
EP_SLICE = ("the expert-parallel slice (ROADMAP A14-EP, with A6/A7: "
            "grouped_ep over all_to_all, the chunked ring, the fp8 wire)")


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
    # "gather" | "einsum" | "grouped" | "grouped_ep" (not in this slice)
    dispatch: str = "gather"
    # the reference's Pallas interpret switch; the kernels here run on
    # CUDA tensors and the plain versions on CPU ones, so it is ignored
    kernel_interpret: Optional[bool] = None
    # "grouped_ep" only (expert-parallel slice): the expert submesh axes,
    # the mesh, the ring's chunk count, the wire precision
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
    """Raises for a dispatch this slice does not run."""
    if config.dispatch not in DISPATCHES:
        raise ValueError(
            f"unknown MoE dispatch {config.dispatch!r}; choose "
            f"'gather' (fast, capacity), 'einsum' (reference oracle), "
            f"'grouped' (dropless kernels, per-device experts) or "
            f"'grouped_ep' (dropless + expert-parallel all-to-all)"
        )
    if config.dispatch == "grouped_ep":
        raise NotImplementedError(f"MoE dispatch 'grouped_ep' comes with "
                                  f"{EP_SLICE}")
    if config.dispatch_chunks:
        raise NotImplementedError(f"MoE dispatch_chunks comes with "
                                  f"{EP_SLICE}")
    if config.precision:
        raise NotImplementedError(f"MoE wire precision comes with "
                                  f"{EP_SLICE}")


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
    Returns (output [B,S,D], aux_loss f32 scalar, metrics) with metrics
    {"dropped_frac" scalar, "expert_load" [E]}.
    """
    check_dispatch(config)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    jitter = config.router_jitter if train else 0.0
    logits = xt @ params["router"]["kernel"]  # [T, E]
    factor = config.capacity_factor if train else config.eval_capacity_factor
    if config.dispatch == "grouped":
        # DROPLESS: route with capacity = T, so nothing overflows and the
        # metrics report dropped_frac == 0
        capacity = t
    else:
        capacity = _capacity(t, config.num_experts, factor, config.top_k)
    rounds, aux, metrics = _routing(logits, capacity, config.top_k, rng,
                                    jitter)
    metrics = {k: metrics[k] for k in PUBLIC_METRICS}
    if config.dispatch == "grouped":
        out = _moe_compute_grouped(params, xt, rounds, config.num_experts,
                                   activation)
    else:
        compute = (_moe_compute_einsum if config.dispatch == "einsum"
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
