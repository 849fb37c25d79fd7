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

Serving (``decode_step``, ``verify_step``, ``prefill_chunk``,
``prefill_sequence``) runs the same weights over the paged KV cache of
``serving.kv_cache``; see the section's comment below.

The dense FSDP wire (``fsdp_precision``, "" = the Context's): under
"fp8" every rank-3 float layer stack is quantized to block-scaled e4m3
plus f32 scales before the layer loop, and each layer decodes its
slice at consumption, inside the remat'd block; under "fp8_qdq" the
stack is decoded before the loop (the bitwise reference of "fp8").
Both consumers pass the gradient straight through to the full-precision
leaf. Over several ranks ``parallel.accelerate`` quantizes each wired
leaf's block on its rank and gathers the wire form, which it hands the
model under ``WIRE_KEY``; the model quantizes only the leaves it was not
handed.

The FSDP layer prefetch (``fsdp_prefetch``, None = the Context's, read
at each call): over several ranks ``parallel.accelerate`` hands the
model a layer source under ``LAYER_KEY`` (``parallel.layer_prefetch``),
and each layer's remat'd block fetches that layer's full parameters
from it, the next layer's gather already in flight, instead of slicing
a stack gathered whole. Without a source (one device, no mesh) the
prefetch is the plain loop: the reference's gather is the identity
without an ambient mesh, and since the port's compute order does not
change, the loop is bit for bit the loop with the prefetch off.

Sequence parallelism (``seq_axis="seq"``, ROADMAP A13): under an
ambient mesh whose seq axis has size > 1 (``parallel.accelerate``'s
over several ranks) each rank holds a contiguous block of every row's
tokens, runs every layer on it, and attention goes round the seq group
(``ops.ring_attention``), packed rows with their ids riding the ring.
RoPE positions are global: the block's start is added, and packed rows
take the batch's ``positions`` (``shard_batch`` computes them over the
whole rows, so a document that began on an earlier shard continues).
The loss's denominator is the whole rows' (``models.losses``). With no
such mesh ``seq_axis`` changes nothing. A mesh that splits the sequence
under a config without ``seq_axis`` raises, as do MoE under
``seq_axis`` (ROADMAP A13b: the load-balance loss's token means would
have to be reduced over the seq group first) and ``prefill_sequence``
under it (A16c: serving stays on one device).

Not in this slice (it raises): pipelining (A15).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, replace
from typing import Any, ClassVar, Dict, Optional, Tuple

import numpy as np

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.models.common import (
    KeepLeaf,
    cast_floats,
    dense_init,
    keep_all,
    param_count as common_param_count,
    rms_norm,
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
from dlrover_tpu_torch.ops.quantize import (
    PRECISIONS,
    dequantize_block_scaled,
    quantize_block_scaled,
)
from dlrover_tpu_torch.ops.remat import apply_remat
from dlrover_tpu_torch.ops.ring_attention import (
    ambient_ring_mesh,
    check_seq_split,
    impl_from_flags,
    ring_attention,
    seq_group,
    seq_positions,
)
from dlrover_tpu_torch.ops.shard_compat import fp8_wire_supported
from dlrover_tpu_torch.serving.kv_cache import decode_kv, encode_kv

logger = get_logger("models.llama")


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
    # the dense FSDP wire: "bf16" | "fp8" | "fp8_qdq"; "" = the
    # Context's (read at each call, so a retune swaps it)
    fsdp_precision: str = ""
    # sequence parallelism: "seq" runs ring attention over the ambient
    # mesh's seq axis (see the module docstring)
    seq_axis: Optional[str] = None
    # the FSDP layer prefetch: None = the Context's (read at each call)
    fsdp_prefetch: Any = None

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
            raise NotImplementedError(
                "MoE under sequence parallelism is not ported yet (ROADMAP "
                "A13b): the load-balance loss would need its token means "
                "reduced over the seq group")
    check_seq_split(c.seq_axis)


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
                     segment_ids=None, return_kv: bool = False):
    """Returns the projected attention output, and with ``return_kv``
    also the post-RoPE ``(k, v)`` [B, S, KV, Dh]: what serving's prefill
    writes into the KV pages."""
    c = config
    b, s, _ = x.shape
    h, kv, hd = c.num_heads, c.num_kv_heads, c.head_dim
    q = (x @ layer["q_proj"]["kernel"]).view(b, s, h, hd)
    k = (x @ layer["k_proj"]["kernel"]).view(b, s, kv, hd)
    v = (x @ layer["v_proj"]["kernel"]).view(b, s, kv, hd)
    q = _rope(q, positions, c.rope_theta)
    k = _rope(k, positions, c.rope_theta)
    kv_out = (k, v) if return_kv else None
    # [B, H, S, Dh]; kv heads are not repeated, the kernels read the
    # shared head of each query group
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    ring_mesh = ambient_ring_mesh(c.seq_axis) if c.seq_axis else None
    if ring_mesh is not None:
        # long context: K/V round the seq group, the ids with them
        out = ring_attention(q, k, v, ring_mesh, axis_name=c.seq_axis,
                             causal=True, impl=impl_from_flags(c.use_flash),
                             segment_ids=segment_ids)
    elif segment_ids is not None:
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
    out = out @ layer["o_proj"]["kernel"]
    if return_kv:
        return out, kv_out
    return out


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


# -- the dense FSDP wire -----------------------------------------------------

# where parallel.accelerate hands the model the gathered wire forms of the
# leaves it quantized on their ranks: {layer path: {"v", "s"} | {"dq"}}
WIRE_KEY = "fsdp_wire"
# where it hands the model its layer source under the layer prefetch
# (``parallel.layer_prefetch.LayerSource``)
LAYER_KEY = "fsdp_layers"


def resolve_fsdp_prefetch(config: LlamaConfig) -> bool:
    """The FSDP layer prefetch (the reference's ``_prefetch_enabled``):
    the config's when set, else the Context's (``fsdp_prefetch``), read
    at each call so that a changed knob takes effect at the next
    step."""
    if config.fsdp_prefetch is not None:
        return bool(config.fsdp_prefetch)
    return bool(get_context().fsdp_prefetch)


def _runs_prefetch(config: LlamaConfig) -> bool:
    """The layer prefetch at this call: resolved on, two layers or
    more."""
    return resolve_fsdp_prefetch(config) and config.num_layers >= 2


def resolve_fsdp_precision(config: LlamaConfig,
                           device: Optional[torch.device] = None) -> str:
    """The dense wire's precision: the config's when set, else the
    Context's (``fsdp_precision``). A quantized choice degrades to
    "bf16", with a warning, when ``device`` fails the fp8 probe."""
    p = (config.fsdp_precision or "").strip()
    if not p:
        p = str(get_context().fsdp_precision or "bf16").strip() or "bf16"
    if p not in PRECISIONS:
        raise ValueError(f"unknown FSDP wire precision {p!r}; choose one "
                         f"of {PRECISIONS}")
    if p != "bf16" and not fp8_wire_supported(device):
        logger.warning("fsdp precision %r requested but %s fails the fp8 "
                       "probe; falling back to the bf16 wire", p,
                       torch.device(device or "cpu").type)
        return "bf16"
    return p


def _wire_leaf(t: torch.Tensor) -> bool:
    """Which stacked layer leaves ride the wire: the rank-3 float weight
    matrices ([L, in, out]). Norm scales ([L, D]) stay exact, and rank-4
    expert tensors (consumed on their own rank) are left out."""
    return t.dim() == 3 and t.is_floating_point()


@dataclass(frozen=True)
class FsdpWire:
    """What ``parallel.accelerate`` reads from a loss function that
    runs the wire (``make_loss_fn``): the precision at a call, which
    parameter paths are wired, and whether the call runs the layer
    prefetch."""

    config: LlamaConfig
    # where the model takes the gathered wire forms
    key: str = WIRE_KEY
    # where the model takes its layer source
    layer_key: ClassVar[str] = LAYER_KEY

    def mode(self, device: Optional[torch.device] = None) -> str:
        return resolve_fsdp_precision(self.config, device)

    @staticmethod
    def wired(path: str, t: torch.Tensor) -> bool:
        return path.startswith("layers/") and _wire_leaf(t)

    def prefetch(self) -> bool:
        return _runs_prefetch(self.config)


def _flatten_layers(layers: Dict, prefix: str = ""):
    """(path, leaf) pairs of a nested layer tree, "/"-joined, sorted."""
    out = []
    for k in sorted(layers):
        if isinstance(layers[k], dict):
            out.extend(_flatten_layers(layers[k], f"{prefix}{k}/"))
        else:
            out.append((f"{prefix}{k}", layers[k]))
    return out


def _wire_form(leaf: torch.Tensor, mode: str, block: int = 0) -> Dict:
    """One leaf's wire form: its e4m3 values and f32 scales under
    "fp8", or under "fp8_qdq" their decode at the leaf's dtype (the same
    numbers, shipped at full precision). The quantize runs per 32-channel
    block of the last dim, so it commutes with any slice along the
    others (a layer, a rank's block)."""
    v, s = quantize_block_scaled(leaf.detach(), block)
    if mode == "fp8":
        return {"v": v, "s": s}
    return {"dq": dequantize_block_scaled(v, s, leaf.dtype)}


def _quantize_layer_stack(layers: Dict, mode: str,
                          skip=()) -> Dict[str, Dict]:
    """path -> wire form of every wired leaf of the stacked layer tree
    but those in ``skip`` (handed over already gathered)."""
    return {path: _wire_form(leaf, mode)
            for path, leaf in _flatten_layers(layers)
            if _wire_leaf(leaf) and path not in skip}


class _ConsumeFp8(torch.autograd.Function):
    """Decode a wired leaf at consumption. ``w`` (the full-precision
    leaf) gives no forward value: it is the straight-through route of
    the gradient, which e4m3 values cannot carry."""

    @staticmethod
    def forward(ctx, v, s, w):
        return dequantize_block_scaled(v, s, w.dtype)

    @staticmethod
    def backward(ctx, g):
        return None, None, g


class _ConsumeQdq(torch.autograd.Function):
    """The "fp8_qdq" consumption: the decoded value, with
    ``_ConsumeFp8``'s backward, so the two are bitwise equal forward and
    backward."""

    @staticmethod
    def forward(ctx, dq, w):
        return dq.view_as(dq)

    @staticmethod
    def backward(ctx, g):
        return None, g


def _get_path(tree: Dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _consume_wire(wire: Dict[str, Dict], layer: Dict) -> Dict:
    """``layer`` (one layer's tree) with each wired leaf replaced by its
    decoded wire form."""
    out = tree_map(lambda t: t, layer)
    for path, form in wire.items():
        *parents, last = path.split("/")
        node = out
        for k in parents:
            node = node[k]
        w = _get_path(layer, path)
        node[last] = (_ConsumeQdq.apply(form["dq"], w) if "dq" in form
                      else _ConsumeFp8.apply(form["v"], form["s"], w))
    return out


def _with_leaves(tree: Dict, leaves: Dict[str, torch.Tensor]) -> Dict:
    """``tree`` (a layer's tree) with ``leaves`` set at their "/"-joined
    paths."""
    out = tree_map(lambda t: t, tree)
    for path, t in leaves.items():
        *parents, last = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def _decoder_block(x, layer, config: LlamaConfig, positions, rng=None,
                   segment_ids=None, wire=None, fetch=None):
    """One layer: params may be stored f32; compute in the configured
    dtype. ``wire``: the layer's slice of the wire forms, decoded here
    (inside the remat'd block, so a recompute decodes again from the
    quantized values). ``fetch``: (layer source, layer index) under the
    layer prefetch; the block takes the layer's full parameters (and
    wire forms) from the source here, so a recompute fetches them
    again. Returns (x, aux_loss, dropped_frac, expert_load)."""
    c = config
    if fetch is not None:
        source, index = fetch
        full, forms = source.fetch(index)
        layer = _with_leaves(layer, full)
        wire = {**(wire or {}), **forms}
    if wire:
        layer = _consume_wire(wire, layer)
    layer = cast_floats(layer, c.compute_dtype)
    attn_in = rms_norm(x, layer["input_norm"]["scale"], c.rms_eps)
    x = x + _attention_block(attn_in, layer, c, positions, segment_ids)
    ffn_in = rms_norm(x, layer["post_norm"]["scale"], c.rms_eps)
    out, *moe_stats = _ffn_block(ffn_in, layer, c, rng)
    return (x + out, *moe_stats)


def apply_hidden(params: Dict, input_ids: torch.Tensor,
                 config: LlamaConfig, rng: Any = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 with_moe_metrics: bool = False,
                 positions: Optional[torch.Tensor] = None):
    """Returns (final hidden states [B, S, D] in the compute dtype,
    moe_aux_loss scalar summed over layers, zero for dense) — everything
    but the head. With ``with_moe_metrics`` a third element is returned:
    the layer-averaged {"moe_dropped_frac", "moe_expert_load" [E]}.
    ``rng`` (a ``torch.Generator``) reaches the router, which draws from
    it only under router jitter; the model sets none.
    ``segment_ids`` [B, S]: packed documents, with per-document attention
    and RoPE positions restarting at each document. ``positions`` [B,
    S]: the RoPE positions, when the batch gives them (``seq_positions``).

    Under the FSDP layer prefetch (``resolve_fsdp_prefetch``) with a
    layer source under ``LAYER_KEY`` (``parallel.accelerate``'s, over
    several ranks), ``params["layers"]`` holds only the layer leaves
    the source does not make full, and each layer's block fetches the
    rest from the source. With no source the prefetch is the plain loop
    (see the module's docstring)."""
    c = config
    _check_supported(c)
    source = params.get(LAYER_KEY)
    if source is not None and not _runs_prefetch(c):
        raise ValueError("the model was handed a layer source, but its "
                         "layer prefetch resolves off")
    x = params["embed_tokens"]["embedding"][input_ids].to(c.compute_dtype)
    b, s = input_ids.shape
    positions = seq_positions(b, s, c.seq_axis, x.device, segment_ids,
                              positions)
    layers = params["layers"]
    # the fp8 probe of the device the model runs on (the CPU's for the
    # meta device, where attribution counts the step)
    mode = resolve_fsdp_precision(
        c, None if x.device.type == "meta" else x.device)
    gathered = params.get(WIRE_KEY) or {}
    if gathered and mode == "bf16":
        raise ValueError("the model was handed gathered wire forms, but "
                         "its FSDP wire resolves to bf16")
    wire = {}
    if mode != "bf16":
        wire = {**_quantize_layer_stack(layers, mode, skip=gathered),
                **gathered}
    # one unbind per stacked leaf: its backward stacks the per-layer
    # gradients once, instead of one full-size scatter per layer
    per_layer = tree_map(lambda t: t.unbind(0), layers)
    per_wire = {path: {k: t.unbind(0) for k, t in form.items()}
                for path, form in wire.items()}
    block = apply_remat(
        functools.partial(_decoder_block, config=c, positions=positions,
                          rng=rng, segment_ids=segment_ids),
        c.remat_policy,
    )
    stats = []
    for i in range(c.num_layers):
        layer_wire = {path: {k: ts[i] for k, ts in form.items()}
                      for path, form in per_wire.items()}
        x, *layer_stats = block(x, tree_map(lambda ts: ts[i], per_layer),
                                wire=layer_wire,
                                fetch=None if source is None else (source, i))
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
          with_moe_metrics: bool = False,
          positions: Optional[torch.Tensor] = None):
    """Returns (logits [B, S, V] in f32, moe_aux_loss scalar), plus the
    load-balance metrics dict when ``with_moe_metrics``."""
    c = config
    out = apply_hidden(params, input_ids, config, rng, segment_ids,
                       with_moe_metrics, positions)
    logits = out[0] @ params["lm_head"]["kernel"].to(c.compute_dtype)
    return (logits.float(),) + tuple(out[1:])


def _not_ported(name: str, item: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(f"llama.{name} is not ported yet "
                                  f"(ROADMAP {item})")

    fn.__name__ = name
    return fn


apply_pipelined = _not_ported("apply_pipelined", "A15")


# -- serving ----------------------------------------------------------------
#
# The decode-time forward of the serving tier (``dlrover_tpu_torch.
# serving``): the same stacked-layer weights, with the sequence dimension
# replaced by a read of the KV pages. Attention for slot ``s`` is a plain
# slice of its own rows (``serving.kv_cache``'s slot-major pool). The
# numerics follow the reference attention: f32 logits, the ``finfo.min``
# mask, f32 softmax, and a grouped GQA product that never repeats KV
# heads. ``prefill_sequence`` routes a whole prompt through
# ``_attention_block`` itself (the flash kernels included), so its hidden
# states are bit for bit the training forward's.
#
# Every step updates the cache IN PLACE (the reference donates it) and
# writes ``length`` last: a step that raises midway leaves only rows past
# the committed length, which no mask reads. Slot, start and chunk length
# are host ints; no step reads a device value back on the host.
#
# Row independence: a verify step runs each of its K+1 positions through
# the very function a decode step runs, at a decode step's shapes
# (``_decode_layer`` on [S, D]), so every product a verified row takes is
# the one a plain decode step takes, whatever algorithm the GEMM library
# picks for a shape. That is what makes speculative decode emit, token
# for token, what plain greedy decode emits; its price is that a verify
# step reads the weights K+1 times.


def _serving_dense_only(name: str, config: LlamaConfig) -> None:
    if config.num_experts > 0:
        raise NotImplementedError(
            f"{name} serves dense llama configs; MoE decode dispatch is "
            "not built yet (prefill_sequence serves MoE prompts)")


def _layer_params(params: Dict, i: int, config: LlamaConfig) -> Dict:
    return cast_floats(tree_map(lambda t: t[i], params["layers"]),
                       config.compute_dtype)


def _layer_kv(cache: Dict, i: int):
    """(k, k_scale or None, v, v_scale or None) of layer ``i``: views
    into the pool, written in place."""
    def leaf(name):
        t = cache.get(name)
        return None if t is None else t[i]

    return leaf("k"), leaf("k_scale"), leaf("v"), leaf("v_scale")


def _kv_write_token(k_l, scale_l, new_kv, pos, write, spec) -> None:
    """Write one token's K (or V) of every slot into row ``pos[s]`` of its
    pages, in place, where ``write[s]``; other slots keep their row. The
    reference's out-of-bounds ``mode="drop"`` scatter becomes a masked
    ``where`` over the gathered rows: each slot writes exactly one row,
    either its new value or the value it held, and reading that row back
    first needs no host sync (a boolean index would, through
    ``nonzero``). ``pos`` is clamped into the pool, as the reference
    clamps it."""
    s, t = k_l.shape[0], k_l.shape[1]
    idx = torch.arange(s, device=k_l.device)
    row = pos.clamp(0, t - 1).long()
    vals, scales = encode_kv(new_kv, spec)
    keep = write[:, None, None]
    k_l[idx, row] = torch.where(keep, vals, k_l[idx, row])
    if scales is not None and scale_l is not None:
        scale_l[idx, row] = torch.where(keep, scales, scale_l[idx, row])


def _grouped_attention(qg, k, v, mask, eqn_logits, eqn_out):
    """f32 logits scaled by 1/sqrt(Dh), the ``finfo.min`` mask, f32
    softmax, then the probabilities times V (the reference attention's
    conventions)."""
    hd = qg.shape[-1]
    logits = torch.einsum(eqn_logits, qg.float(), k) * (1.0 / (hd ** 0.5))
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum(eqn_out, probs.to(v.dtype), v)


def _paged_attention(q, k_l, ks_l, v_l, vs_l, pos, spec, config):
    """Decode attention: ``q [S, H, HD]`` against each slot's own pages
    ``[S, T, KV, HD]`` under the causal mask ``t <= pos[s]``; GQA by a
    grouped product (KV heads never repeated)."""
    s, h, hd = q.shape
    t, kvh = k_l.shape[1], k_l.shape[2]
    k = decode_kv(k_l, ks_l, spec)       # [S, T, KV, HD] f32
    v = decode_kv(v_l, vs_l, spec)
    qg = q.reshape(s, kvh, h // kvh, hd)
    mask = torch.arange(t, device=q.device)[None, :] <= pos[:, None]
    out = _grouped_attention(qg, k, v, mask[:, None, None, :],
                             "skgd,stkd->skgt", "skgt,stkd->skgd")
    return out.reshape(s, h * hd).to(config.compute_dtype)


def _chunk_attention(q, k_slot, ks_slot, v_slot, vs_slot, start: int, spec,
                     config):
    """Prefill-chunk attention: chunk queries ``[C, H, HD]`` against ONE
    slot's pages (which already hold the chunk's own K/V at ``start ..
    start+C``), causal mask ``t <= start + i``."""
    cq, h, hd = q.shape
    t, kvh = k_slot.shape[0], k_slot.shape[1]
    k = decode_kv(k_slot, ks_slot, spec)    # [T, KV, HD] f32
    v = decode_kv(v_slot, vs_slot, spec)
    qg = q.reshape(cq, kvh, h // kvh, hd)
    rows = start + torch.arange(cq, device=q.device)
    mask = torch.arange(t, device=q.device)[None, :] <= rows[:, None]
    out = _grouped_attention(qg, k, v, mask[:, None, None, :],
                             "ckgd,tkd->ckgt", "ckgt,tkd->ckgd")
    return out.reshape(cq, h * hd).to(config.compute_dtype)


def _decode_layer(x_in, layer, kv, pos, write, config: LlamaConfig, spec):
    """One layer at one position for every slot (``x_in [S, D]``): the
    token's K/V go into row ``pos`` where ``write``, then the slot
    attends to its rows ``t <= pos``."""
    c = config
    s = x_in.shape[0]
    h, kvh, hd = c.num_heads, c.num_kv_heads, c.head_dim
    k_l, ks_l, v_l, vs_l = kv
    attn_in = rms_norm(x_in, layer["input_norm"]["scale"], c.rms_eps)
    q = (attn_in @ layer["q_proj"]["kernel"]).view(s, h, hd)
    k_new = (attn_in @ layer["k_proj"]["kernel"]).view(s, kvh, hd)
    v_new = (attn_in @ layer["v_proj"]["kernel"]).view(s, kvh, hd)
    # RoPE at each slot's own position (a batch of length-1 sequences)
    q = _rope(q[:, None], pos[:, None], c.rope_theta)[:, 0]
    k_new = _rope(k_new[:, None], pos[:, None], c.rope_theta)[:, 0]
    _kv_write_token(k_l, ks_l, k_new, pos, write, spec)
    _kv_write_token(v_l, vs_l, v_new, pos, write, spec)
    attn = _paged_attention(q, k_l, ks_l, v_l, vs_l, pos, spec, c)
    x_mid = x_in + attn @ layer["o_proj"]["kernel"]
    ffn_in = rms_norm(x_mid, layer["post_norm"]["scale"], c.rms_eps)
    return x_mid + _ffn_block(ffn_in, layer, c)[0]


def _head_logits(params: Dict, x, config: LlamaConfig):
    """Final norm and head of rows ``x [.., D]`` -> f32 logits."""
    c = config
    x = rms_norm(x, params["norm"]["scale"], c.rms_eps)
    return (x @ params["lm_head"]["kernel"].to(c.compute_dtype)).float()


@torch.inference_mode()
def decode_step(params, cache, tokens, active, config: LlamaConfig, spec):
    """One continuous-batching decode step for every slot at once.

    ``tokens [S] int32``: each slot's current token (the one whose
    successor is predicted). ``active [S] bool``: slots admitted and
    decoding; the others compute harmlessly but neither write pages nor
    advance ``length``. Returns ``(next_tokens [S] int32, logits [S, V]
    f32, cache)``, greedy selection on the device, so the executor's
    window never waits on the host to feed step k+1. Dense FFN only."""
    c = config
    _serving_dense_only("decode_step", c)
    pos = cache["length"]  # the row this step writes
    x = params["embed_tokens"]["embedding"][tokens].to(c.compute_dtype)
    for i in range(c.num_layers):
        x = _decode_layer(x, _layer_params(params, i, c), _layer_kv(cache, i),
                          pos, active, c, spec)
    logits = _head_logits(params, x, c)
    next_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    cache["length"].copy_(torch.where(active, pos + 1, pos))
    return next_tokens, logits, cache


@torch.inference_mode()
def verify_step(params, cache, tokens, active, n_draft,
                config: LlamaConfig, spec):
    """One speculative-decode verify step for every slot at once: the
    model over each slot's current token plus up to K drafted
    continuations, the longest matching draft prefix accepted on the
    device, and exactly the accepted tokens' rows committed.

    ``tokens [S, K+1] int32``: column 0 is the slot's current token,
    columns 1..K its drafts. ``n_draft [S] int32``: how many draft
    columns are real for each slot (mixed K in one program).
    ``active [S] bool``: as in ``decode_step``.

    With ``g[i]`` the argmax at position ``pos+i``, the accepted length
    ``a`` is the longest prefix with ``tokens[i+1] == g[i]`` for ``i <
    a``; the slot emits ``g[0..a]`` and its next current token is
    ``g[a]``. Position ``i`` runs ``_decode_layer`` at ``pos + i``, the
    function and shapes of a decode step, so ``g`` is bit for bit what
    plain greedy decode computes at every acceptance pattern. Rejected
    rows stay written past the committed length, where no mask reads
    them and later writes land first.

    Returns ``(greedy [S, K+1], accepted [S], next_tokens [S], cache)``.
    """
    c = config
    _serving_dense_only("verify_step", c)
    s, k1 = tokens.shape
    t = cache["k"].shape[2]
    pos = cache["length"]
    offs = torch.arange(k1, device=tokens.device)
    write = (active[:, None] & (offs[None, :] <= n_draft[:, None])
             & (pos[:, None] + offs[None, :] < t))
    emb = params["embed_tokens"]["embedding"]
    xs = [emb[tokens[:, i]].to(c.compute_dtype) for i in range(k1)]
    for layer_i in range(c.num_layers):
        layer = _layer_params(params, layer_i, c)
        kv = _layer_kv(cache, layer_i)
        xs = [_decode_layer(x, layer, kv, pos + i, write[:, i], c, spec)
              for i, x in enumerate(xs)]
    greedy = torch.stack([torch.argmax(_head_logits(params, x, c), dim=-1)
                          for x in xs], dim=1).to(torch.int32)
    if k1 > 1:
        match = ((tokens[:, 1:] == greedy[:, :-1])
                 & (offs[None, 1:] <= n_draft[:, None]))
        accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    else:
        accepted = torch.zeros_like(pos)
    accepted = torch.where(active, accepted, 0).to(torch.int32)
    next_tokens = torch.gather(greedy, 1, accepted[:, None].long())[:, 0]
    cache["length"].copy_(torch.where(active, pos + accepted + 1, pos))
    return greedy, accepted, next_tokens, cache


def _write_rows(cache: Dict, i: int, slot: int, start: int, k_new, v_new,
                spec) -> None:
    """Token K/V ``[n, KV, HD]`` into slot ``slot``'s rows ``start ..
    start+n`` of layer ``i``, in place."""
    n = k_new.shape[0]
    for name, new in (("k", k_new), ("v", v_new)):
        vals, scales = encode_kv(new, spec)
        cache[name][i, slot, start:start + n] = vals
        if scales is not None:
            cache[f"{name}_scale"][i, slot, start:start + n] = scales


@torch.inference_mode()
def prefill_chunk(params, cache, tokens, slot: int, start: int,
                  n_valid: int, config: LlamaConfig, spec):
    """Prefill ONE chunk of one slot's prompt: write the chunk's K/V rows
    and return ``(cache, last_logits [V] f32)``, the logits of token
    ``n_valid - 1`` (the first generated token's, on the final chunk).

    ``tokens [C] int32`` (the chunk size is fixed; trailing padding is
    written but never read); ``slot``, ``start``, ``n_valid`` are host
    ints, and the engine keeps ``start + C`` inside the pool (the chunk
    divides the pool depth). Later chunks attend to the slot's earlier
    rows through the cache, as decode does."""
    c = config
    _serving_dense_only("prefill_chunk", c)
    cq = tokens.shape[0]
    h, kvh, hd = c.num_heads, c.num_kv_heads, c.head_dim
    positions = (start + torch.arange(cq, device=tokens.device))[None]
    x = params["embed_tokens"]["embedding"][tokens].to(c.compute_dtype)
    for i in range(c.num_layers):
        layer = _layer_params(params, i, c)
        attn_in = rms_norm(x, layer["input_norm"]["scale"], c.rms_eps)
        q = (attn_in @ layer["q_proj"]["kernel"]).view(cq, h, hd)
        k_new = (attn_in @ layer["k_proj"]["kernel"]).view(cq, kvh, hd)
        v_new = (attn_in @ layer["v_proj"]["kernel"]).view(cq, kvh, hd)
        q = _rope(q[None], positions, c.rope_theta)[0]
        k_new = _rope(k_new[None], positions, c.rope_theta)[0]
        _write_rows(cache, i, slot, start, k_new, v_new, spec)
        k_l, ks_l, v_l, vs_l = _layer_kv(cache, i)
        attn = _chunk_attention(
            q, k_l[slot], None if ks_l is None else ks_l[slot], v_l[slot],
            None if vs_l is None else vs_l[slot], start, spec, c)
        x_mid = x + attn @ layer["o_proj"]["kernel"]
        ffn_in = rms_norm(x_mid, layer["post_norm"]["scale"], c.rms_eps)
        x = x_mid + _ffn_block(ffn_in, layer, c)[0]
    last = rms_norm(x, params["norm"]["scale"], c.rms_eps)[
        min(max(n_valid - 1, 0), cq - 1)]
    logits = (last @ params["lm_head"]["kernel"].to(c.compute_dtype)).float()
    # fill_ with a host int: an item assignment would copy a host
    # scalar to the device and wait for it
    cache["length"][slot].fill_(start + n_valid)
    return cache, logits


@torch.inference_mode()
def prefill_sequence(params, cache, tokens, slot: int, config: LlamaConfig,
                     spec, return_hidden: bool = False):
    """One-shot prefill of a whole prompt into slot ``slot`` (a freshly
    admitted slot: rows from 0), returning ``(cache, last_logits [V])``,
    with ``return_hidden`` also the last token's final hidden row [D].

    The prompt runs through the training forward's own blocks
    (``_attention_block(..., return_kv=True)``, so the flash kernels
    apply, and ``_ffn_block``, so MoE configs serve here), so the hidden
    states, and the first generated token, are bit for bit ``apply``'s.
    The head runs on the last row alone."""
    c = config
    if c.seq_axis:
        raise NotImplementedError("prefill_sequence under sequence "
                                  "parallelism is not ported (ROADMAP A16c: "
                                  "serving stays on one device)")
    p = tokens.shape[0]
    x = params["embed_tokens"]["embedding"][tokens][None].to(c.compute_dtype)
    positions = torch.arange(p, device=tokens.device).expand(1, p)
    for i in range(c.num_layers):
        layer = _layer_params(params, i, c)
        attn_in = rms_norm(x, layer["input_norm"]["scale"], c.rms_eps)
        attn, (k_new, v_new) = _attention_block(attn_in, layer, c, positions,
                                                return_kv=True)
        x = x + attn
        _write_rows(cache, i, slot, 0, k_new[0], v_new[0], spec)
        ffn_in = rms_norm(x, layer["post_norm"]["scale"], c.rms_eps)
        x = x + _ffn_block(ffn_in, layer, c)[0]
    hidden = rms_norm(x, params["norm"]["scale"], c.rms_eps)[0, -1]
    logits = (hidden @ params["lm_head"]["kernel"].to(c.compute_dtype)
              ).float()
    cache["length"][slot].fill_(p)
    if return_hidden:
        return cache, logits, hidden
    return cache, logits


# -- training glue ----------------------------------------------------------


def make_loss_fn(config: LlamaConfig, z_loss_weight: float = 0.0,
                 head_chunk: int = 0):
    """Causal-LM loss over batches {"input_ids", "labels"} (labels==-100
    are masked). ``head_chunk`` > 0 fuses the head with the cross
    entropy over sequence chunks so the f32 logits never exist whole."""

    moe = config.num_experts > 0

    def loss_fn(params, batch, rng):
        segment_ids = batch.get("segment_ids")
        positions = batch.get("positions")
        # the whole rows' labelled tokens under the ring
        count_group = seq_group(config.seq_axis)
        if head_chunk > 0:
            out = apply_hidden(params, batch["input_ids"], config, rng,
                               segment_ids=segment_ids,
                               with_moe_metrics=moe, positions=positions)
            loss = chunked_lm_head_loss(
                out[0], params["lm_head"]["kernel"], batch["labels"],
                chunk_size=head_chunk, z_loss_weight=z_loss_weight,
                count_group=count_group,
            )
        else:
            out = apply(params, batch["input_ids"], config, rng,
                        segment_ids=segment_ids, with_moe_metrics=moe,
                        positions=positions)
            loss = masked_lm_loss(out[0], batch["labels"], z_loss_weight,
                                  count_group)
        if not moe:
            return loss, {}
        # the load-balance signals ride the step metrics
        loss = loss + config.moe_aux_weight * out[1] / max(
            1, config.num_layers)
        return loss, dict(out[2])

    # parallel.accelerate quantizes the wired leaves' blocks before its
    # gathers when the wire is on
    loss_fn.fsdp_wire = FsdpWire(config)
    return loss_fn


def param_count(config: LlamaConfig) -> int:
    return common_param_count(param_shapes(config))


def flops_per_token(config: LlamaConfig) -> float:
    """6N + attention flops approximation for MFU accounting."""
    n = param_count(config)
    attn = 12 * config.num_layers * config.hidden_size * config.max_seq_len
    return 6.0 * n + attn
