"""Llama-family decoder, training path, dense and MoE (port of
``dlrover_tpu/models/llama.py``).

Functional like the reference: ``init`` builds a nested dict of tensors
with the reference's layout (stacked ``[L, ...]`` layer weights,
``[in, out]`` kernels), so converting a reference parameter tree is a
copy (``dlrover_tpu_torch.interop``) and the optimizer takes the tree's
leaves. An ``nn.Module`` would re-key and split the stacked weights and
buy nothing the trainer uses. ``apply`` runs the layers as a
plain loop, each under the configured remat policy, with attention
through the Hopper flash kernels (``use_flash``) or the reference
attention. Packed documents (``segment_ids``) restart RoPE positions
per document and attend within their document, through the flash
kernels' segment-id mode or the reference attention with a bias. With
``num_experts`` > 0 the FFN is a mixture of experts
(``ops.moe``); ``moe_dispatch="grouped"`` runs it dropless through the
grouped-matmul kernels, and ``"grouped_ep"`` shards the experts over the
ranks of the expert group: each rank's parameter tree then holds its
own E/P experts (``init(..., expert_shard=(rank, P))``).

Numerics follow the reference: RMSNorm with f32 statistics, RoPE with
f32 angles on rotated halves, GQA, SwiGLU, untied head; params stored in
``param_dtype`` and cast to ``compute_dtype`` per layer; logits computed
in the compute dtype and cast to f32.

Not in this slice (they raise): sequence parallelism (A13), the
low-precision FSDP wire (A14), pipelining (A15) and the serving
functions (A16).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.models.common import (
    KeepLeaf,
    cast_floats,
    dense_init,
    keep_all,
    param_count as common_param_count,
    rms_norm,
    segment_positions,
    tree_map,
)
from dlrover_tpu_torch.models.losses import (
    chunked_lm_head_loss,
    masked_lm_loss,
)
from dlrover_tpu_torch.ops import moe as moe_ops
from dlrover_tpu_torch.ops.attention_ref import mha_reference
from dlrover_tpu_torch.ops.flash_attention import (
    flash_attention_auto,
    segmented_attention,
)
from dlrover_tpu_torch.ops.remat import apply_remat


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat_policy: str = "dots_saveable"
    use_flash: bool = True  # the Hopper kernels; the reference otherwise
    # kept for parity with the reference config; the CUDA kernels tile
    # at fixed sizes (see ops.flash_attention)
    flash_block_q: int = 512
    flash_block_k: int = 1024
    flash_block_q_bwd: int = 0
    flash_block_k_bwd: int = 0
    # MoE (0 = dense). "gather" (capacity) | "einsum" (the oracle) |
    # "grouped" (dropless, the grouped-matmul kernels) | "grouped_ep"
    # (dropless, experts sharded over the moe_ep_axes ranks; the row
    # exchange's chunks and wire precision: 0 / "" = the Context's)
    num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "gather"
    moe_ep_axes: Tuple[str, ...] = ("data", "fsdp")
    moe_dispatch_chunks: int = 0
    moe_precision: str = ""
    # later slices: a non-default value raises in apply
    seq_axis: Optional[str] = None
    fsdp_precision: str = ""

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def llama2_7b(**overrides) -> LlamaConfig:
    return replace(LlamaConfig(), **overrides)


def llama3_8b(**overrides) -> LlamaConfig:
    """Llama-3-8B shape: GQA 32/8, 128k vocab, theta 5e5."""
    return replace(
        LlamaConfig(vocab_size=128256, hidden_size=4096,
                    intermediate_size=14336, num_layers=32,
                    num_heads=32, num_kv_heads=8, max_seq_len=8192,
                    rope_theta=500000.0),
        **overrides,
    )


def llama_tiny(**overrides) -> LlamaConfig:
    """Test-scale config."""
    return replace(
        LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
            compute_dtype=torch.float32, use_flash=False,
        ),
        **overrides,
    )


def _moe_config(c: LlamaConfig) -> moe_ops.MoEConfig:
    return moe_ops.MoEConfig(
        num_experts=c.num_experts, capacity_factor=c.moe_capacity_factor,
        top_k=c.moe_top_k, dispatch=c.moe_dispatch,
        ep_axes=tuple(c.moe_ep_axes), dispatch_chunks=c.moe_dispatch_chunks,
        precision=c.moe_precision,
    )


def _check_supported(c: LlamaConfig) -> None:
    if c.num_experts > 0:
        moe_ops.check_dispatch(_moe_config(c))
    if c.seq_axis:
        raise NotImplementedError("sequence parallelism (ring attention) "
                                  "is not ported yet (ROADMAP A13)")
    if c.fsdp_precision not in ("", "bf16"):
        raise NotImplementedError("the low-precision FSDP wire is not "
                                  "ported yet (ROADMAP A14)")


# -- init -------------------------------------------------------------------


ExpertShard = Optional[Tuple[int, int]]  # (rank, ranks) of the experts


def _local_experts(num_experts: int, expert_shard: ExpertShard) -> range:
    """The expert indices a rank holds: [r E/P, (r+1) E/P)."""
    if expert_shard is None:
        return range(num_experts)
    rank, ranks = expert_shard
    if num_experts % ranks or not 0 <= rank < ranks:
        raise ValueError(f"expert_shard {expert_shard}: {num_experts} "
                         f"experts do not split over {ranks} ranks")
    per = num_experts // ranks
    return range(rank * per, (rank + 1) * per)


def param_shapes(config: LlamaConfig,
                 expert_shard: ExpertShard = None) -> Dict:
    """The parameter tree's layout: nested dict of shapes (a rank's own
    E/P experts with ``expert_shard=(rank, P)``)."""
    c = config
    l, d, f = c.num_layers, c.hidden_size, c.intermediate_size
    h, kv, hd = c.num_heads, c.num_kv_heads, c.head_dim
    layers = {
        "input_norm": {"scale": (l, d)},
        "q_proj": {"kernel": (l, d, h * hd)},
        "k_proj": {"kernel": (l, d, kv * hd)},
        "v_proj": {"kernel": (l, d, kv * hd)},
        "o_proj": {"kernel": (l, h * hd, d)},
        "post_norm": {"scale": (l, d)},
    }
    if c.num_experts > 0:
        e = c.num_experts
        el = len(_local_experts(e, expert_shard))
        layers["router"] = {"kernel": (l, d, e)}
        layers["experts"] = {"up": {"kernel": (l, el, d, f)},
                             "down": {"kernel": (l, el, f, d)}}
    else:
        layers.update({"gate_proj": {"kernel": (l, d, f)},
                       "up_proj": {"kernel": (l, d, f)},
                       "down_proj": {"kernel": (l, f, d)}})
    return {
        "embed_tokens": {"embedding": (c.vocab_size, d)},
        "layers": layers,
        "norm": {"scale": (d,)},
        "lm_head": {"kernel": (d, c.vocab_size)},
    }


def _expert_seed(base: int, leaf: str, layer: int, expert: int) -> int:
    """The seed of one expert's weight block: a function of the init
    seed and the block's place only, so every rank draws the same block
    whichever experts it holds."""
    return int(np.random.SeedSequence(
        [base, 0 if leaf == "up" else 1, layer, expert]).generate_state(
            2, np.uint64)[0] >> np.uint64(1))


def init(generator: torch.Generator, config: LlamaConfig,
         expert_shard: ExpertShard = None,
         keep: KeepLeaf = keep_all) -> Dict:
    """Random parameters on the generator's device, reference layout and
    initialisers (the numbers differ: torch and jax generators differ).
    Norm scales start at one.

    Each expert's [D, F] block is drawn from its own generator, seeded
    from the generator's initial seed and the block's (leaf, layer,
    expert): with ``expert_shard=(rank, P)`` a rank draws only its own
    E/P experts, and they equal those experts of the one-rank model
    from the same seed. Each leaf goes to ``keep(path, leaf)`` as soon
    as it is drawn, and the tree holds what that returns."""
    _check_supported(config)
    c, dt = config, config.param_dtype
    shapes = param_shapes(c, expert_shard)
    # the FFN's output projections start at 1/sqrt(F), the rest at
    # 1/sqrt(fan_in); norm scales at one
    down = 1.0 / math.sqrt(c.intermediate_size)
    base = generator.initial_seed()

    def experts(leaf, shape):
        scale = down if leaf == "down" else None
        blocks = [[dense_init(torch.Generator(generator.device).manual_seed(
                      _expert_seed(base, leaf, layer, expert)),
                              shape[2:], dt, scale)
                   for expert in _local_experts(c.num_experts, expert_shard)]
                  for layer in range(shape[0])]
        return torch.stack([torch.stack(b) for b in blocks])

    def layer_leaf(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape, dtype=dt, device=generator.device)
        if len(path) == 3 and path[0] == "experts":
            return experts(path[1], shape)
        scale = down if path[-2] in ("down_proj", "down") else None
        return dense_init(generator, shape, dt, scale)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return keep("layers/" + "/".join(path), layer_leaf(path, node))

    layers = walk(shapes["layers"])
    embed = keep("embed_tokens/embedding", torch.randn(
        shapes["embed_tokens"]["embedding"], generator=generator, dtype=dt,
        device=generator.device) * 0.02)
    return {
        "embed_tokens": {"embedding": embed},
        "layers": layers,
        "norm": {"scale": keep("norm/scale", torch.ones(
            shapes["norm"]["scale"], dtype=dt, device=generator.device))},
        "lm_head": {"kernel": keep("lm_head/kernel", dense_init(
            generator, shapes["lm_head"]["kernel"], dt))},
    }


def make_init_fn(config: LlamaConfig, expert_shard: ExpertShard = None):
    return functools.partial(init, config=config, expert_shard=expert_shard)


# -- forward ----------------------------------------------------------------


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, Dh]; rotate the two halves, angles in f32."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # [B, S, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def _attention_block(x, layer, config: LlamaConfig, positions,
                     segment_ids=None):
    c = config
    b, s, _ = x.shape
    h, kv, hd = c.num_heads, c.num_kv_heads, c.head_dim
    q = (x @ layer["q_proj"]["kernel"]).view(b, s, h, hd)
    k = (x @ layer["k_proj"]["kernel"]).view(b, s, kv, hd)
    v = (x @ layer["v_proj"]["kernel"]).view(b, s, kv, hd)
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    # [B, H, S, Dh]; kv heads are not repeated, the kernels read the
    # shared head of each query group
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    if segment_ids is not None:
        # packed documents: the per-document mask inside the kernels
        out = segmented_attention(
            q, k, v, segment_ids, c.use_flash, block_q=c.flash_block_q,
            block_k=c.flash_block_k, block_q_bwd=c.flash_block_q_bwd,
            block_k_bwd=c.flash_block_k_bwd,
        )
    elif c.use_flash:
        out = flash_attention_auto(
            q, k, v, True, block_q=c.flash_block_q, block_k=c.flash_block_k,
            block_q_bwd=c.flash_block_q_bwd,
            block_k_bwd=c.flash_block_k_bwd,
        )
    else:
        out = mha_reference(q, k, v, causal=True)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ layer["o_proj"]["kernel"]


def _ffn_block(x, layer, config: LlamaConfig, rng=None):
    """Returns (out, aux_loss, dropped_frac, expert_load): the MoE
    load-balance signals, None for a dense layer."""
    if config.num_experts > 0:
        moe_params = {"router": layer["router"], "experts": layer["experts"]}
        out, aux, metrics = moe_ops.moe_ffn(
            moe_params, x, _moe_config(config), activation=F.silu, rng=rng)
        return out, aux, metrics["dropped_frac"], metrics["expert_load"]
    gate = F.silu(x @ layer["gate_proj"]["kernel"])
    up = x @ layer["up_proj"]["kernel"]
    return (gate * up) @ layer["down_proj"]["kernel"], None, None, None


def _decoder_block(x, layer, config: LlamaConfig, positions, rng=None,
                   segment_ids=None):
    """One layer: params may be stored f32; compute in the configured
    dtype. Returns (x, aux_loss, dropped_frac, expert_load)."""
    c = config
    layer = cast_floats(layer, c.compute_dtype)
    attn_in = rms_norm(x, layer["input_norm"]["scale"], c.rms_eps)
    x = x + _attention_block(attn_in, layer, c, positions, segment_ids)
    ffn_in = rms_norm(x, layer["post_norm"]["scale"], c.rms_eps)
    out, *moe_stats = _ffn_block(ffn_in, layer, c, rng)
    return (x + out, *moe_stats)


def apply_hidden(params: Dict, input_ids: torch.Tensor,
                 config: LlamaConfig, rng: Any = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 with_moe_metrics: bool = False):
    """Returns (final hidden states [B, S, D] in the compute dtype,
    moe_aux_loss scalar summed over layers, zero for dense) — everything
    but the head. With ``with_moe_metrics`` a third element is returned:
    the layer-averaged {"moe_dropped_frac", "moe_expert_load" [E]}.
    ``rng`` (a ``torch.Generator``) reaches the router, which draws from
    it only under router jitter; the model sets none.
    ``segment_ids`` [B, S]: packed documents, with per-document attention
    and RoPE positions restarting at each document."""
    c = config
    _check_supported(c)
    x = params["embed_tokens"]["embedding"][input_ids].to(c.compute_dtype)
    b, s = input_ids.shape
    positions = (segment_positions(segment_ids) if segment_ids is not None
                 else torch.arange(s, device=x.device).expand(b, s))
    # one unbind per stacked leaf: its backward stacks the per-layer
    # gradients once, instead of one full-size scatter per layer
    per_layer = tree_map(lambda t: t.unbind(0), params["layers"])
    block = apply_remat(
        functools.partial(_decoder_block, config=c, positions=positions,
                          rng=rng, segment_ids=segment_ids),
        c.remat_policy,
    )
    stats = []
    for i in range(c.num_layers):
        x, *layer_stats = block(x, tree_map(lambda ts: ts[i], per_layer))
        stats.append(layer_stats)
    x = rms_norm(x, params["norm"]["scale"], c.rms_eps)
    zero = torch.zeros((), device=x.device)
    if c.num_experts > 0:
        aux, dropped, load = (torch.stack(t) for t in zip(*stats))
        aux, metrics = aux.sum(), {"moe_dropped_frac": dropped.mean(),
                                   "moe_expert_load": load.mean(dim=0)}
    else:
        aux, metrics = zero, {"moe_dropped_frac": zero,
                              "moe_expert_load": torch.zeros(
                                  (1,), device=x.device)}
    if with_moe_metrics:
        return x, aux, metrics
    return x, aux


def apply(params: Dict, input_ids: torch.Tensor, config: LlamaConfig,
          rng: Any = None, segment_ids: Optional[torch.Tensor] = None,
          with_moe_metrics: bool = False):
    """Returns (logits [B, S, V] in f32, moe_aux_loss scalar), plus the
    load-balance metrics dict when ``with_moe_metrics``."""
    c = config
    out = apply_hidden(params, input_ids, config, rng, segment_ids,
                       with_moe_metrics)
    logits = out[0] @ params["lm_head"]["kernel"].to(c.compute_dtype)
    return (logits.float(),) + tuple(out[1:])


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"llama.{name} is not ported yet "
                                  f"(ROADMAP {item})")

    fn.__name__ = name
    return fn


apply_pipelined = _not_ported("apply_pipelined", "A15")
decode_step = _not_ported("decode_step", "A16")
prefill_chunk = _not_ported("prefill_chunk", "A16")
prefill_sequence = _not_ported("prefill_sequence", "A16")
verify_step = _not_ported("verify_step", "A16")


# -- training glue ----------------------------------------------------------


def make_loss_fn(config: LlamaConfig, z_loss_weight: float = 0.0,
                 head_chunk: int = 0):
    """Causal-LM loss over batches {"input_ids", "labels"} (labels==-100
    are masked). ``head_chunk`` > 0 fuses the head with the cross
    entropy over sequence chunks so the f32 logits never exist whole."""

    moe = config.num_experts > 0

    def loss_fn(params, batch, rng):
        segment_ids = batch.get("segment_ids")
        if head_chunk > 0:
            out = apply_hidden(params, batch["input_ids"], config, rng,
                               segment_ids=segment_ids,
                               with_moe_metrics=moe)
            loss = chunked_lm_head_loss(
                out[0], params["lm_head"]["kernel"], batch["labels"],
                chunk_size=head_chunk, z_loss_weight=z_loss_weight,
            )
        else:
            out = apply(params, batch["input_ids"], config, rng,
                        segment_ids=segment_ids, with_moe_metrics=moe)
            loss = masked_lm_loss(out[0], batch["labels"], z_loss_weight)
        if not moe:
            return loss, {}
        # the load-balance signals ride the step metrics
        loss = loss + config.moe_aux_weight * out[1] / max(
            1, config.num_layers)
        return loss, dict(out[2])

    return loss_fn


def param_count(config: LlamaConfig) -> int:
    return common_param_count(param_shapes(config))


def flops_per_token(config: LlamaConfig) -> float:
    """6N + attention flops approximation for MFU accounting."""
    n = param_count(config)
    attn = 12 * config.num_layers * config.hidden_size * config.max_seq_len
    return 6.0 * n + attn
