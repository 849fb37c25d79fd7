"""Per-card capability for the port (the ``DeviceSpec`` of
``dlrover_tpu/parallel/planner.py:29-45``, with NVIDIA cards in place of
the TPU generations), ``kv_bytes_per_elem``, the one price of a stored
KV element that ``serving.kv_cache.KVCacheSpec`` charges, and the
serving decode term: ``ModelSpec``, the pool's byte counts and
``estimate_decode``, a serving config's predicted decode step and
tokens/s; and the dense FSDP wire's bytes a gathered parameter element
(``ModelSpec.fsdp_wire_bytes_per_elem``), the one formula the wire's
gathers are held to; and whether the FSDP layer prefetch runs
(``ModelSpec.fsdp_prefetch``). The planner's search over meshes, the
wire's byte split and collective pricing (``fsdp_byte_split``), and the
pricing of the prefetch's hidden gather legs (the reference's forward
gather, backward re-gather and two gathered layers live) come with the
collective model, ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class DeviceSpec:
    """Per-card capability, the reference's fields. Defaults: the H100
    SXM's datasheet."""

    flops_per_s: float = 989e12  # dense bf16 on the tensor cores
    hbm_bytes: float = 80e9
    hbm_bw: float = 3.35e12  # bytes/s, HBM3
    ici_bw: float = 4.5e11  # NVLink 4: bytes/s one way, all 18 links
    dcn_bw: float = 5.0e10  # bytes/s per card: one 400 Gb/s NIC


# datasheet figures (dense, no sparsity); a card's memory is replaced by
# what torch.cuda reports on it (``device_spec``)
GPU_SPECS = {
    "h100-sxm": DeviceSpec(989e12, 80e9, 3.35e12, 4.5e11, 5.0e10),
}
# the CPU's stand-in, as the reference falls back to v5e: derived
# quantities stay defined, and Context.device_peak_flops sets the real
# denominator
CPU_PLACEHOLDER = GPU_SPECS["h100-sxm"]


def spec_for_name(name: str) -> Optional[DeviceSpec]:
    """The spec whose card this ``torch.cuda.get_device_name`` names
    (None for a card not in the table)."""
    return GPU_SPECS["h100-sxm"] if "h100" in name.lower() else None


def device_spec(device=None) -> DeviceSpec:
    """The spec of ``device`` (default: the current CUDA device when one
    is available, else the CPU's placeholder). On a card, ``hbm_bytes``
    is its ``total_memory``; a card not in the table keeps the H100
    SXM's rates."""
    device = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if device.type != "cuda":
        return CPU_PLACEHOLDER
    spec = spec_for_name(torch.cuda.get_device_name(device)) or CPU_PLACEHOLDER
    return dataclasses.replace(
        spec, hbm_bytes=float(
            torch.cuda.get_device_properties(device).total_memory))


def kv_bytes_per_elem(kv_precision: str, channels: int = 0) -> float:
    """Stored bytes per KV element: int8 = the value plus its share of
    the f32 per-block scale (the ``ops.quantize`` block geometry,
    resolved against the head dim when known); the one formula the KV
    pool's byte counts share."""
    if kv_precision == "int8":
        from dlrover_tpu_torch.ops.quantize import (
            QUANT_BLOCK,
            resolve_quant_block,
        )

        block = (resolve_quant_block(channels) if channels
                 else QUANT_BLOCK)
        return 1.0 + 4.0 / block
    if kv_precision == "bf16":
        return 2.0
    return 4.0


# -- the serving decode term --------------------------------------------------

# The host's floor a decode step, a layer: the host seconds one call of
# the serve loop's decode at 8 active slots takes to return from an empty
# queue (phase 19 of chip_smoke.py, `host_ms`: Llama-3-8B x 4 layers, f32
# pool 2048 deep; NVIDIA H100 80GB HBM3, 700.00 W: 10.508 ms), over its 4
# layers. The port dispatches op by op (284 ops a step, 68 a layer), so
# the floor grows with the depth; the 12 ops outside the layers
# (embedding, final norm, head, sampling) are folded into the figure, so
# it overstates a deeper model's floor by up to their share, 0.042. It
# enters the step as a floor (max), not a term.
HOST_DISPATCH_PER_LAYER_S = 2.627e-3
# The fraction of the datasheet peak the FLOPs term may claim: no cap was
# measured on the card, so the FLOPs term is priced at the peak.
MAX_EFFICIENCY = 1.0


@dataclass
class ModelSpec:
    """What the decode term and the FSDP wire read of the workload (the
    reference's ``ModelSpec`` holds the training planner's fields
    too)."""

    param_count: int
    num_layers: int
    hidden_size: int
    # GQA shape (0 = MHA)
    num_heads: int = 0
    kv_heads: int = 0
    param_bytes: int = 2  # bf16 storage
    # the dense FSDP wire ("bf16" | "fp8" | "fp8_qdq"): "fp8" gathers
    # e4m3 values and one f32 scale a block; "fp8_qdq" decodes before
    # the wire, so it ships the parameter bytes
    fsdp_precision: str = "bf16"
    # the FSDP layer prefetch (``models.llama.resolve_fsdp_prefetch``):
    # each layer gathered under the previous layer's compute, again in
    # the backward, at most two layers gathered at once. Priced with the
    # collective model (ROADMAP A15)
    fsdp_prefetch: bool = False

    def fsdp_wire_bytes_per_elem(self) -> float:
        """Wire bytes a gathered parameter element on the dense FSDP
        gathers, the scales included: ``1 + 4 / block`` under "fp8"
        (blocks along each kernel's last dim; ``hidden_size`` stands for
        the channel count), the parameter bytes otherwise."""
        if self.fsdp_precision == "fp8":
            from dlrover_tpu_torch.ops.quantize import resolve_quant_block

            block = resolve_quant_block(max(1, int(self.hidden_size)))
            return 1.0 + 4.0 / block
        return float(self.param_bytes)


def model_spec_from_llama(config) -> ModelSpec:
    """A ModelSpec of a LlamaConfig. ``fsdp_precision`` "" and
    ``fsdp_prefetch`` None resolve the Context's, as the model does at
    each call."""
    from dlrover_tpu_torch.common.config import get_context
    from dlrover_tpu_torch.models import llama

    return ModelSpec(
        param_count=llama.param_count(config),
        num_layers=config.num_layers,
        hidden_size=config.hidden_size,
        num_heads=config.num_heads,
        kv_heads=config.num_kv_heads,
        param_bytes=torch.empty((), dtype=config.param_dtype).element_size(),
        fsdp_precision=(config.fsdp_precision
                        or str(get_context().fsdp_precision or "bf16")),
        fsdp_prefetch=llama.resolve_fsdp_prefetch(config),
    )


def _kv_geometry(m: ModelSpec):
    """(kv heads, head dim) of a ModelSpec."""
    kv_heads = m.kv_heads or m.num_heads or 1
    heads = max(1, m.num_heads or 1)
    return max(1, kv_heads), m.hidden_size // heads


def serve_cache_bytes(m: ModelSpec, serve_slots: int, max_seq: int,
                      kv_precision: str = "f32") -> float:
    """The whole pool's K and V, every slot at full depth (preallocated:
    what must fit, not an average)."""
    kv_heads, head_dim = _kv_geometry(m)
    elems = m.num_layers * serve_slots * max_seq * kv_heads * head_dim
    return 2.0 * elems * kv_bytes_per_elem(kv_precision, head_dim)


def serve_prefix_pool_bytes(m: ModelSpec, pool_pages: int, page_size: int,
                            kv_precision: str = "f32") -> float:
    """The shared prefix pool's K and V (``pool_pages`` pages of
    ``page_size`` tokens, every layer), the same byte formula; the pool
    is replicated, so a device holds all of it."""
    kv_heads, head_dim = _kv_geometry(m)
    elems = (m.num_layers * max(0, int(pool_pages))
             * max(1, int(page_size)) * kv_heads * head_dim)
    return 2.0 * elems * kv_bytes_per_elem(kv_precision, head_dim)


def decode_kv_read_bytes(m: ModelSpec, serve_slots: int, seq_fill: int,
                         kv_precision: str = "f32") -> float:
    """The KV bytes one decode step reads: every filled row's K and V,
    every layer and slot (``seq_fill``: the filled depth)."""
    kv_heads, head_dim = _kv_geometry(m)
    elems = m.num_layers * serve_slots * seq_fill * kv_heads * head_dim
    return 2.0 * elems * kv_bytes_per_elem(kv_precision, head_dim)


def estimate_decode(m: ModelSpec, num_devices: int, serve_slots: int,
                    prefill_chunk: int, max_seq: int,
                    kv_precision: str = "f32",
                    prefix_pool_pages: int = 0,
                    page_size: int = 16,
                    prefix_hit_rate: float = 0.0,
                    spec_draft_len: int = 0,
                    spec_accept_rate: float = -1.0,
                    device: Optional[DeviceSpec] = None,
                    dispatch_s: Optional[float] = None,
                    max_efficiency: Optional[float] = None) -> Dict:
    """A serving config's predicted decode step and tokens/s, with the
    breakdown (the reference's model, term for term):

      kv_read_s      the pool at half fill over the memory rate
      weight_read_s  2 bytes a parameter a step over the memory rate
      flops_s        2 x params x slots over the peak x ``max_efficiency``
      dispatch_s     the host's floor a step (``dispatch_s``)
      prefill_amort  a prompt's chunks (each a dispatch, a weight read
                     and its rows) spread over its generated tokens; a
                     prefix pool discounts it by the expected hit rate
                     (a hit's pages are copies, one dispatch a page)
      speculation    K > 0 with an observed acceptance rate: 1 + rate x
                     K tokens a step, the FLOPs term x (K + 1); with no
                     observed rate, exactly the K = 0 estimate

    Defaults are the card's: ``device`` the H100 SXM's ``DeviceSpec``,
    ``dispatch_s`` HOST_DISPATCH_PER_LAYER_S x the model's layers,
    ``max_efficiency`` MAX_EFFICIENCY. Returns {"step_s", "tokens_per_s", "cache_bytes",
    "cache_bytes_per_device", "breakdown"}; whether the pool fits is
    the caller's check."""
    dev = device or DeviceSpec()
    dispatch_s = (HOST_DISPATCH_PER_LAYER_S * m.num_layers
                  if dispatch_s is None else float(dispatch_s))
    eff = MAX_EFFICIENCY if max_efficiency is None else float(max_efficiency)
    n = max(1, int(num_devices))
    slots = max(1, int(serve_slots))
    chunk = max(1, int(prefill_chunk))
    pool_pages = max(0, int(prefix_pool_pages))
    hit_rate = (min(1.0, max(0.0, float(prefix_hit_rate)))
                if pool_pages else 0.0)
    cache_bytes = serve_cache_bytes(m, slots, max_seq, kv_precision)
    pool_bytes = serve_prefix_pool_bytes(m, pool_pages, page_size,
                                         kv_precision)
    kv_read = decode_kv_read_bytes(
        m, slots, max(1, max_seq // 2), kv_precision) / n
    kv_read_s = kv_read / dev.hbm_bw
    weight_read_s = (m.param_count * 2.0 / n) / dev.hbm_bw
    flops_s = (2.0 * m.param_count * slots / n) / (dev.flops_per_s * eff)
    # a prompt of L tokens takes ceil(L / chunk) interleaved chunks
    avg_prompt = max(1.0, max_seq / 4.0)
    prefill_calls = math.ceil(avg_prompt / chunk)
    prefill_s_per_req = prefill_calls * (
        dispatch_s + weight_read_s
        + chunk * kv_read_s / max(1, max_seq // 2) / slots)
    if pool_pages:
        pool_tokens = pool_pages * max(1, int(page_size))
        coverage = min(1.0, pool_tokens / avg_prompt)
        discount = hit_rate * coverage
        copy_pages = avg_prompt / max(1, int(page_size))
        copy_s_per_req = discount * copy_pages * dispatch_s
        prefill_s_per_req = ((1.0 - discount) * prefill_s_per_req
                             + copy_s_per_req)
    avg_new = max(1.0, max_seq / 4.0)
    prefill_amort_s = prefill_s_per_req / avg_new / slots
    k = max(0, int(spec_draft_len))
    rate = float(spec_accept_rate)
    if k > 0 and 0.0 <= rate <= 1.0:
        expected_tokens = 1.0 + rate * k
        step_s = max(kv_read_s + weight_read_s + prefill_amort_s,
                     flops_s * (k + 1), dispatch_s)
        tokens_per_s = slots * expected_tokens / step_s
    else:
        expected_tokens = 1.0
        step_s = max(kv_read_s + weight_read_s + prefill_amort_s,
                     flops_s, dispatch_s)
        tokens_per_s = slots / step_s
    return {
        "step_s": step_s,
        "tokens_per_s": tokens_per_s,
        "cache_bytes": cache_bytes,
        "cache_bytes_per_device": cache_bytes / n + pool_bytes,
        "breakdown": {
            "kv_read_s": kv_read_s,
            "weight_read_s": weight_read_s,
            "flops_s": flops_s,
            "dispatch_s": dispatch_s,
            "prefill_amort_s": prefill_amort_s,
            "prefix_pool_bytes": pool_bytes,
            "prefix_hit_rate": hit_rate,
            "spec_draft_len": k,
            "spec_accept_rate": rate if 0.0 <= rate <= 1.0 else -1.0,
            "spec_expected_tokens_per_step": expected_tokens,
            "kv_bytes_per_elem": kv_bytes_per_elem(
                kv_precision, m.hidden_size // max(1, m.num_heads or 1)),
        },
    }
