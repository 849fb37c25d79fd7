"""GLM-family decoder, training path (port of ``dlrover_tpu/models/glm.py``).

GLM's two signatures:

  * prefix-LM attention: token ``i`` attends key ``j`` iff
    ``j < prefix_len`` (the prompt, visible in both directions) or
    ``j <= i`` (causal over the generation). ``prefix_len`` [B] arrives
    in the batch. On the flash path the mask lives inside the Hopper
    kernels' tiles (their prefix-LM mode); the reference path
    (``use_flash=False``) adds an S x S bias to the reference attention.
  * 2D positions: position ids run 0..p-1 over the prompt then stay at
    ``p``; block-position ids are 0 over the prompt and 1..n over the
    generation. Two learned tables are added to the token embedding.

Packed documents (``segment_ids``) attend within their document and
restart positions per document, as in the Llama family.

Functional like ``models.llama``: ``init`` builds a nested dict with the
reference's layout (stacked ``[L, ...]`` layer weights, ``[in, out]``
kernels), so ``dlrover_tpu_torch.interop`` converts a reference tree
leaf by leaf. Numerics follow the reference: LayerNorm with f32
statistics and a bias, biased projections, tanh-approximated GELU (the
default of ``jax.nn.gelu``), untied head; params stored in
``param_dtype`` and cast to ``compute_dtype`` per layer; logits in the
compute dtype, cast to f32.

Sequence parallelism (``seq_axis="seq"``, ROADMAP A13), in all three
modes (causal, packed, prefix-LM): under an ambient mesh whose seq axis
has size > 1 each rank holds a contiguous block of every row's tokens
and attention goes round the seq group (``ops.ring_attention``); the 2D
positions are taken over the global length and sliced, packed rows take
the batch's global ``positions``, and the prefix ring's skips read the
batch's host copy of ``prefix_len`` (``ops.ring_attention.PREFIX_HOST``,
which ``parallel.accelerate``'s ``shard_batch`` keeps). With no such mesh
``seq_axis`` changes nothing.

Not in this slice (it raises): pipelining (A15).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.models.common import (
    KeepLeaf,
    cast_floats,
    dense_init,
    keep_all,
    layer_norm,
    param_count as common_param_count,
    tree_map,
)
from dlrover_tpu_torch.models.losses import masked_lm_loss
from dlrover_tpu_torch.ops.attention_ref import mha_reference
from dlrover_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention_auto,
    flash_attention_prefix_auto,
    segmented_attention,
)
from dlrover_tpu_torch.ops.remat import apply_remat
from dlrover_tpu_torch.ops.ring_attention import (
    PREFIX_HOST,
    ambient_ring_mesh,
    check_seq_split,
    impl_from_flags,
    ring_attention,
    seq_group,
    seq_positions,
    seq_shard,
)


@dataclass(frozen=True)
class GLMConfig:
    vocab_size: int = 50304
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_seq_len: int = 1024
    ln_eps: float = 1e-5
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    remat_policy: str = "dots_saveable"
    use_flash: bool = True  # the Hopper kernels; the reference otherwise
    # kept for parity with the reference config; the CUDA kernels tile
    # at fixed sizes (see ops.flash_attention)
    flash_block_q: int = 512
    flash_block_k: int = 1024
    # sequence parallelism: "seq" runs ring attention over the ambient
    # mesh's seq axis (see the module docstring)
    seq_axis: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def glm_large(**overrides) -> GLMConfig:
    return replace(GLMConfig(), **overrides)


def glm_10b(**overrides) -> GLMConfig:
    return replace(
        GLMConfig(hidden_size=4096, num_layers=48, num_heads=64,
                  intermediate_size=16384, max_seq_len=2048),
        **overrides,
    )


def glm_tiny(**overrides) -> GLMConfig:
    return replace(
        GLMConfig(vocab_size=256, hidden_size=64, num_layers=2,
                  num_heads=4, intermediate_size=128, max_seq_len=128,
                  compute_dtype=torch.float32, use_flash=False),
        **overrides,
    )


# -- init -------------------------------------------------------------------


def param_shapes(config: GLMConfig) -> Dict:
    """The parameter tree's layout: nested dict of shapes."""
    c = config
    l, d, f = c.num_layers, c.hidden_size, c.intermediate_size
    hd = c.num_heads * c.head_dim

    def norm(n):
        return {"scale": (n, d), "bias": (n, d)}

    def proj(n_in, n_out):
        return {"kernel": (l, n_in, n_out), "bias": (l, n_out)}

    layers = {
        "input_norm": norm(l), "post_norm": norm(l),
        "q_proj": proj(d, hd), "k_proj": proj(d, hd), "v_proj": proj(d, hd),
        "o_proj": proj(hd, d), "up_proj": proj(d, f), "down_proj": proj(f, d),
    }
    return {
        "embed_tokens": {"embedding": (c.vocab_size, d)},
        # 2D positional encoding: absolute and block tables
        "pos_embed": {"embedding": (c.max_seq_len + 1, d)},
        "block_pos_embed": {"embedding": (c.max_seq_len + 1, d)},
        "layers": layers,
        "final_norm": {"scale": (d,), "bias": (d,)},
        "lm_head": {"kernel": (d, c.vocab_size)},
    }


def init(generator: torch.Generator, config: GLMConfig,
         keep: KeepLeaf = keep_all) -> Dict:
    """Random parameters on the generator's device, reference layout and
    initialisers (the numbers differ: torch and jax generators differ):
    norm scales at one, biases at zero, embedding tables N(0, 0.02),
    kernels fan-in scaled. Each leaf goes to ``keep(path, leaf)`` as
    soon as it is drawn, and the tree holds what that returns."""
    dt, dev = config.param_dtype, generator.device

    def leaf(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape, dtype=dt, device=dev)
        if path[-1] == "bias":
            return torch.zeros(shape, dtype=dt, device=dev)
        if path[-1] == "embedding":
            return torch.randn(shape, generator=generator, dtype=dt,
                               device=dev) * 0.02
        return dense_init(generator, shape, dt)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return keep("/".join(path), leaf(path, node))

    return walk(param_shapes(config))


def make_init_fn(config: GLMConfig):
    return functools.partial(init, config=config)


# -- masks / positions ------------------------------------------------------


def glm_positions(seq_len: int, prefix_len: torch.Tensor):
    """2D position ids [B, S] each from per-example prefix lengths [B]:
    prompt token i -> (i, 0), generated token g_j -> (prefix_len, j + 1).
    """
    idx = torch.arange(seq_len, device=prefix_len.device)[None, :]
    p = prefix_len.long()[:, None]
    position_ids = torch.where(idx < p, idx, p)
    block_position_ids = torch.where(idx < p, 0, idx - p + 1)
    return position_ids, block_position_ids


def prefix_lm_bias(seq_len: int, prefix_len: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Additive attention bias [B, 1, S, S]: 0 where attending is allowed
    (j < prefix_len or j <= i), ``finfo(float32).min`` cast to ``dtype``
    elsewhere (in bf16 that rounds to -inf, as in the reference)."""
    dev = prefix_len.device
    i = torch.arange(seq_len, device=dev)[:, None]  # queries
    j = torch.arange(seq_len, device=dev)[None, :]  # keys
    allowed = (j <= i)[None] | (j[None] < prefix_len[:, None, None])
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev).to(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return torch.where(allowed, zero, neg)[:, None, :, :]


# -- forward ----------------------------------------------------------------


def _attention(x, layer, c: GLMConfig, bias, prefix_len=None,
               segment_ids=None, prefix_host=None):
    b, s, _ = x.shape
    h, hd = c.num_heads, c.head_dim
    q, k, v = ((x @ layer[n]["kernel"] + layer[n]["bias"]).view(b, s, h, hd)
               .transpose(1, 2) for n in ("q_proj", "k_proj", "v_proj"))
    ring_mesh = ambient_ring_mesh(c.seq_axis) if c.seq_axis else None
    if ring_mesh is not None:
        # long context: every mode decomposes over the ring; no bias
        out = ring_attention(q, k, v, ring_mesh, axis_name=c.seq_axis,
                             causal=True, impl=impl_from_flags(c.use_flash),
                             segment_ids=segment_ids, prefix_len=prefix_len,
                             prefix_host=prefix_host)
    # the reference's order: the segment mode first (the plain flash
    # branch below would match too, and drop the per-document mask)
    elif segment_ids is not None:
        out = segmented_attention(q, k, v, segment_ids, c.use_flash,
                                  block_q=c.flash_block_q,
                                  block_k=c.flash_block_k)
    elif prefix_len is not None and c.use_flash:
        # the prefix-LM mask inside the kernels' tiles: no S x S bias
        out = flash_attention_prefix_auto(q, k, v, prefix_len,
                                          block_q=c.flash_block_q,
                                          block_k=c.flash_block_k)
    elif bias is None and c.use_flash:
        out = flash_attention_auto(q, k, v, True, block_q=c.flash_block_q,
                                   block_k=c.flash_block_k)
    else:
        # the bias holds the causal part of the prefix-LM mask
        out = mha_reference(q, k, v, bias=bias, causal=bias is None)
    out = out.transpose(1, 2).reshape(b, s, h * hd)
    return out @ layer["o_proj"]["kernel"] + layer["o_proj"]["bias"]


def _block(x, layer, c: GLMConfig, bias, prefix_len=None, segment_ids=None,
           prefix_host=None):
    layer = cast_floats(layer, c.compute_dtype)
    attn_in = layer_norm(x, layer["input_norm"]["scale"],
                         layer["input_norm"]["bias"], c.ln_eps)
    x = x + _attention(attn_in, layer, c, bias, prefix_len, segment_ids,
                       prefix_host)
    mlp_in = layer_norm(x, layer["post_norm"]["scale"],
                        layer["post_norm"]["bias"], c.ln_eps)
    up = mlp_in @ layer["up_proj"]["kernel"] + layer["up_proj"]["bias"]
    # jax.nn.gelu's default is the tanh approximation
    mlp_out = (F.gelu(up, approximate="tanh") @ layer["down_proj"]["kernel"]
               + layer["down_proj"]["bias"])
    return x + mlp_out


def apply(params: Dict, input_ids: torch.Tensor, config: GLMConfig,
          rng: Any = None, prefix_len: Optional[torch.Tensor] = None,
          segment_ids: Optional[torch.Tensor] = None,
          positions: Optional[torch.Tensor] = None,
          prefix_host: Optional[Any] = None) -> torch.Tensor:
    """Logits [B, S, V] in f32. ``prefix_len`` [B]: prefix-LM mode (None
    is a causal LM); ``segment_ids`` [B, S]: packed documents, causal
    within each and positions restarting at each; the two exclude each
    other. ``rng`` is accepted for the loss contract and unused. Under
    the ring: ``positions``, the batch's global positions of packed
    rows; ``prefix_host``, ``prefix_len`` on the host (the skips)."""
    del rng
    c = config
    check_seq_split(c.seq_axis)
    b, s = input_ids.shape
    if prefix_len is not None and segment_ids is not None:
        raise ValueError("prefix_len and segment_ids are mutually "
                         "exclusive GLM modes")
    x = params["embed_tokens"]["embedding"][input_ids]
    bias = None
    my, n = seq_shard(c.seq_axis) if c.seq_axis else (0, 1)
    if prefix_len is not None:
        # over the global length, this rank's block of it
        pos_ids, block_ids = (t[:, my * s:(my + 1) * s]
                              for t in glm_positions(n * s, prefix_len))
        # the S x S bias only on the reference path: the flash path
        # masks inside the kernels, the ring in its steps
        if not c.use_flash and n == 1:
            bias = prefix_lm_bias(s, prefix_len, c.compute_dtype)
    else:
        pos_ids = seq_positions(b, s, c.seq_axis, x.device, segment_ids,
                                positions)
        block_ids = torch.zeros((b, s), dtype=torch.long, device=x.device)
    x = (x + params["pos_embed"]["embedding"][pos_ids]
         + params["block_pos_embed"]["embedding"][block_ids])
    x = x.to(c.compute_dtype)
    # one unbind per stacked leaf: its backward stacks the per-layer
    # gradients once, instead of one full-size scatter per layer
    per_layer = tree_map(lambda t: t.unbind(0), params["layers"])
    block = apply_remat(
        functools.partial(_block, c=c, bias=bias, prefix_len=prefix_len,
                          segment_ids=segment_ids, prefix_host=prefix_host),
        c.remat_policy,
    )
    for i in range(c.num_layers):
        x = block(x, tree_map(lambda ts: ts[i], per_layer))
    x = layer_norm(x, params["final_norm"]["scale"],
                   params["final_norm"]["bias"], c.ln_eps)
    logits = x @ params["lm_head"]["kernel"].to(c.compute_dtype)
    return logits.float()


def apply_pipelined(*args, **kwargs):
    raise NotImplementedError("glm.apply_pipelined is not ported yet "
                              "(ROADMAP A15)")


# -- training glue ----------------------------------------------------------


def make_loss_fn(config: GLMConfig, z_loss_weight: float = 0.0):
    """Loss over batches {"input_ids", "labels"} and, optionally,
    "prefix_len" [B] or "segment_ids" [B, S] (never both). Labels -100
    are masked: over the prompt in prefix-LM batches, and across each
    boundary in packed ones."""

    def loss_fn(params, batch, rng):
        logits = apply(params, batch["input_ids"], config, rng,
                       prefix_len=batch.get("prefix_len"),
                       segment_ids=batch.get("segment_ids"),
                       positions=batch.get("positions"),
                       prefix_host=batch.get(PREFIX_HOST))
        # the whole rows' labelled tokens under the ring
        return masked_lm_loss(logits, batch["labels"], z_loss_weight,
                              seq_group(config.seq_axis)), {}

    return loss_fn


def param_count(config: GLMConfig) -> int:
    return common_param_count(param_shapes(config))
