"""Paged, preallocated KV cache of the serving tier (port of
``dlrover_tpu/serving/kv_cache.py``).

Geometry: one pool of ``num_slots * pages_per_slot`` pages per layer,
``page_size`` tokens each, laid out slot-major: slot ``s`` owns the
contiguous rows ``[s * T, (s+1) * T)`` of a leaf shaped ``[L, S, T, KV,
HD]`` (``T = pages_per_slot * page_size``). Attention for slot ``s`` is
a plain slice of its own rows, with no page table on the decode path,
and admission and eviction move page ranges by index: fixed shapes, so
nothing is built again as the active set changes.

Storage precision (``serve_kv_precision``): "f32" / "bf16" pages store
that dtype; "int8" stores int8 values plus f32 per-block scales
(``ops.quantize.quantize_block_scaled_int8``), ~1/4 of an f32 page.

The pool's leaves carry the reference's sharding rules
(``kv_cache_rules``, composed with the training rules over
``parallel.sharding_rules``); this slice serves on one device, where
every rule places its leaf whole. Serving over several ranks is ROADMAP
A16c, and ``serve_shardings`` raises for a mesh of more than one rank.
``migrate_slots_host`` repacks a host copy of the pool to a new slot
count (a retune's slot-count change).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Mapping, Optional, Tuple

import torch

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.ops.quantize import (
    KV_PRECISIONS,
    dequantize_block_scaled_int8,
    quantize_block_scaled_int8,
    resolve_quant_block,
)
from dlrover_tpu_torch.parallel.sharding_rules import ShardingRules, tree_specs

logger = get_logger("serving.kv_cache")

_INT8_KV_SUPPORTED: Optional[bool] = None


def int8_kv_supported() -> bool:
    """Capability probe for int8 KV storage: a tiny round trip must
    reproduce its input to the quantization step. Probed once per
    process; a failure degrades the knob to "f32" (logged, never
    raised)."""
    global _INT8_KV_SUPPORTED
    if _INT8_KV_SUPPORTED is not None:
        return _INT8_KV_SUPPORTED
    try:
        x = torch.tensor([[1.0, -2.0, 0.5, 0.25]])
        back = dequantize_block_scaled_int8(
            *quantize_block_scaled_int8(x, block=4))
        _INT8_KV_SUPPORTED = bool(torch.allclose(back, x, atol=0.02))
    except Exception:  # noqa: BLE001 — a probe failure means "no"
        logger.warning("int8 KV probe failed", exc_info=True)
        _INT8_KV_SUPPORTED = False
    return _INT8_KV_SUPPORTED


def resolve_kv_precision(requested: Optional[str] = None) -> str:
    """The page storage precision: an explicit request wins, else the
    Context knob (``serve_kv_precision``). "int8" degrades to "f32" when
    the probe fails."""
    from dlrover_tpu_torch.common.config import get_context

    p = (requested or "").strip()
    if not p:
        p = str(getattr(get_context(), "serve_kv_precision", "f32")
                or "f32").strip() or "f32"
    if p not in KV_PRECISIONS:
        raise ValueError(
            f"unknown KV-cache precision {p!r}; choose one of "
            f"{KV_PRECISIONS}"
        )
    if p == "int8" and not int8_kv_supported():
        logger.warning("serve_kv_precision=int8 requested but the int8 "
                       "probe failed; KV pages stay f32")
        return "f32"
    return p


@dataclass(frozen=True)
class KVCacheSpec:
    """Static geometry of one serving world's KV pool."""

    num_layers: int
    num_kv_heads: int
    head_dim: int
    num_slots: int
    page_size: int = 16
    pages_per_slot: int = 8
    # "f32" | "bf16" | "int8" (see resolve_kv_precision)
    precision: str = "f32"
    # shared prefix pool, in pages (0 = off): refcounted KV pages beside
    # the slot pool, indexed on the host by serving.prefix_index; a hit
    # copies its pages into the slot's rows (copy-on-admit), so the
    # decode read never sees the pool
    prefix_pool_pages: int = 0

    @property
    def max_seq(self) -> int:
        return self.page_size * self.pages_per_slot

    @property
    def quant_block(self) -> int:
        return resolve_quant_block(self.head_dim)

    @property
    def scale_blocks(self) -> int:
        return self.head_dim // self.quant_block

    def bytes_per_slot(self) -> int:
        """One slot's K+V pages, priced by ``planner.kv_bytes_per_elem``."""
        from dlrover_tpu_torch.parallel.planner import kv_bytes_per_elem

        elems = (self.num_layers * self.max_seq
                 * self.num_kv_heads * self.head_dim)
        return int(2 * elems
                   * kv_bytes_per_elem(self.precision, self.head_dim))

    def prefix_page_bytes(self) -> int:
        """One prefix-pool page (K+V of every layer), the same formula."""
        from dlrover_tpu_torch.parallel.planner import kv_bytes_per_elem

        elems = (self.num_layers * self.page_size
                 * self.num_kv_heads * self.head_dim)
        return int(2 * elems
                   * kv_bytes_per_elem(self.precision, self.head_dim))

    def prefix_pool_bytes(self) -> int:
        return self.prefix_page_bytes() * self.prefix_pool_pages

    def total_bytes(self) -> int:
        return (self.bytes_per_slot() * self.num_slots
                + self.prefix_pool_bytes())

    @classmethod
    def from_model(cls, config, num_slots: int, max_seq: int = 0,
                   page_size: int = 16,
                   precision: Optional[str] = None,
                   prefix_pool_pages: int = 0) -> "KVCacheSpec":
        """The pool geometry of a Llama-shaped config; ``max_seq`` rounds
        up to whole pages."""
        want = int(max_seq or config.max_seq_len)
        pages = max(1, math.ceil(want / page_size))
        return cls(
            num_layers=int(config.num_layers),
            num_kv_heads=int(config.num_kv_heads),
            head_dim=int(config.head_dim),
            num_slots=int(num_slots),
            page_size=int(page_size),
            pages_per_slot=pages,
            precision=resolve_kv_precision(precision),
            prefix_pool_pages=max(0, int(prefix_pool_pages)),
        )

    def with_slots(self, num_slots: int) -> "KVCacheSpec":
        return replace(self, num_slots=int(num_slots))


def store_dtype(spec: KVCacheSpec) -> torch.dtype:
    if spec.precision == "int8":
        return torch.int8
    if spec.precision == "bf16":
        return torch.bfloat16
    return torch.float32


def cache_shapes(spec: KVCacheSpec,
                 pages: Optional[int] = None) -> Dict[str, Tuple]:
    """Leaf shapes: the slot pool, or (``pages`` given) a prefix pool of
    that many pages. ``length`` belongs to the slot pool only."""
    l, kv, hd = spec.num_layers, spec.num_kv_heads, spec.head_dim
    lead = (l, pages, spec.page_size) if pages is not None else (
        l, spec.num_slots, spec.max_seq)
    shapes = {"k": lead + (kv, hd), "v": lead + (kv, hd)}
    if spec.precision == "int8":
        shapes["k_scale"] = shapes["v_scale"] = lead + (
            kv, spec.scale_blocks)
    if pages is None:
        shapes["length"] = (spec.num_slots,)
    return shapes


def _zeros(spec: KVCacheSpec, pages: Optional[int],
           device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, shape in cache_shapes(spec, pages).items():
        if name == "length":
            out[name] = torch.zeros(shape, dtype=torch.int32, device=device)
        elif name.endswith("_scale"):
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=store_dtype(spec),
                                    device=device)
    return out


def init_kv_cache(spec: KVCacheSpec, device=None) -> Dict[str, torch.Tensor]:
    """The preallocated pool. Leaves:

      k, v             [L, S, T, KV, HD]   page payload (store dtype)
      k_scale, v_scale [L, S, T, KV, NB]   f32 per-block scales (int8)
      length           [S] int32           tokens written per slot

    Zero-filled: row ``t`` is never read before it is written (decode
    masks ``t <= pos`` and writes row ``pos`` first), so a reused slot
    needs no invalidation pass. ``device`` defaults to the CPU."""
    return _zeros(spec, None, device)


def init_prefix_pool(spec: KVCacheSpec,
                     device=None) -> Dict[str, torch.Tensor]:
    """The shared prefix pool: ``prefix_pool_pages`` pages, each K+V of
    every layer (``[L, P, page_size, KV, HD]``, scales as the slot
    pool's); ``serving.prefix_index`` decides what each page holds."""
    return _zeros(spec, spec.prefix_pool_pages, device)


# -- page copies between the prefix pool and the slot pool --------------------
#
# Copy-on-admit: a hit copies the matched pool pages into the slot's own
# rows, so the decode read stays a plain slice of the slot. Slot, row
# and page are host ints: each copy is one slice-to-slice copy a leaf,
# in place (the reference donates the cache and the pool).


def copy_page_to_slot(cache: Dict[str, torch.Tensor],
                      pool: Dict[str, torch.Tensor], slot: int,
                      dst_start: int, src_page: int,
                      spec: KVCacheSpec) -> Dict[str, torch.Tensor]:
    """One pool page -> the slot rows ``[dst_start, dst_start+page)``."""
    pg = spec.page_size
    for name, leaf in pool.items():
        cache[name][:, slot, dst_start:dst_start + pg].copy_(
            leaf[:, src_page])
    return cache


def copy_page_to_pool(pool: Dict[str, torch.Tensor],
                      cache: Dict[str, torch.Tensor], slot: int,
                      src_start: int, dst_page: int,
                      spec: KVCacheSpec) -> Dict[str, torch.Tensor]:
    """The slot rows ``[src_start, src_start+page)`` -> one pool page
    (publish after a completed prefill)."""
    pg = spec.page_size
    for name, leaf in pool.items():
        leaf[:, dst_page].copy_(
            cache[name][:, slot, src_start:src_start + pg])
    return pool


# -- encode/decode at the page boundary --------------------------------------


def encode_kv(x: torch.Tensor, spec: KVCacheSpec):
    """Token K/V (``[..., KV, HD]``, compute dtype) -> (payload, scales
    or None) in the page storage format."""
    if spec.precision == "int8":
        return quantize_block_scaled_int8(x.float(), block=spec.quant_block)
    return x.to(store_dtype(spec)), None


def decode_kv(values: torch.Tensor, scales: Optional[torch.Tensor],
              spec: KVCacheSpec, dtype: torch.dtype = torch.float32):
    """Page storage -> ``dtype`` (the read side of the pool)."""
    if spec.precision == "int8":
        return dequantize_block_scaled_int8(values, scales, dtype)
    return values.to(dtype)


# -- sharding ----------------------------------------------------------------


def kv_cache_rules(base_rule_set: str = "llama") -> ShardingRules:
    """The serving rule set: the pool's rules prepended to the unchanged
    training rules of ``base_rule_set`` (first match wins), so one table
    places ``{"params": ..., "cache": ...}`` with the parameters where
    training puts them."""
    from dlrover_tpu_torch.parallel.strategy import RULE_SETS

    factory = RULE_SETS.get(base_rule_set)
    if factory is None:
        raise ValueError(
            f"unknown base rule set {base_rule_set!r}; "
            f"have {sorted(RULE_SETS)}"
        )
    base = factory()
    return ShardingRules(rules=[
        # pool payload [L, S, T, KV, HD]: heads on the model axis, slots
        # over the data axes (each data shard serves its own slots)
        (r"cache/(k|v)$", (None, ("data", "fsdp"), None, "tensor", None)),
        # the int8 scales [L, S, T, KV, NB] ride with their payload
        (r"cache/(k|v)_scale$",
         (None, ("data", "fsdp"), None, "tensor", None)),
        (r"cache/length$", (("data", "fsdp"),)),
        # prefix pool [L, P, page, KV, HD]: heads as the slot pool's, the
        # page dimension replicated (any data shard's slot may admit any
        # page)
        (r"prefix/(k|v)(_scale)?$", (None, None, None, "tensor", None)),
        *base.rules,
    ], default=base.default)


def serve_shardings(mesh: Mapping[str, int], spec: KVCacheSpec,
                    param_shapes, base_rule_set: str = "llama"
                    ) -> Dict[str, Dict[str, Tuple]]:
    """The specs of the joint ``{"params", "cache"[, "prefix"]}`` tree a
    serve program runs over, by path within each part. ``mesh``: the axis
    sizes (or a ``ProcessMesh``). On one rank every spec places its leaf
    whole; a mesh of more than one rank raises (ROADMAP A16c)."""
    sizes = (dict(mesh) if isinstance(mesh, Mapping)
             else dict(zip(mesh.axis_names, mesh.axis_sizes)))
    if math.prod(max(1, v) for v in sizes.values()) > 1:
        raise NotImplementedError(
            f"serving over a mesh of several ranks {sizes} is not ported "
            "yet (ROADMAP A16c)")
    tree = {"params": param_shapes, "cache": cache_shapes(spec)}
    if spec.prefix_pool_pages > 0:
        tree["prefix"] = cache_shapes(spec, spec.prefix_pool_pages)
    specs = tree_specs(kv_cache_rules(base_rule_set), sizes, tree)
    out: Dict[str, Dict[str, Tuple]] = {part: {} for part in tree}
    for path, leaf_spec in specs.items():
        part, rest = path.split("/", 1)
        out[part][rest] = leaf_spec
    return out


# -- host-side slot surgery (retune across a slot-count change) --------------


def migrate_slots_host(host_cache: Mapping[str, torch.Tensor],
                       old_spec: KVCacheSpec, new_spec: KVCacheSpec,
                       slot_map: Mapping[int, int]) -> Dict[str, torch.Tensor]:
    """Repack a host copy of the pool (CPU tensors, a leaf a name) into
    a new slot count: ``slot_map`` maps old slot -> new slot for every
    live request; the rest of the new pool is zeros (scales 1.0). The
    page geometry (depth, precision) must match: a retune changes the
    slot dimension only. Returns new CPU tensors."""
    if (old_spec.max_seq, old_spec.precision) != (
            new_spec.max_seq, new_spec.precision):
        raise ValueError("migrate_slots_host only remaps the slot dim")
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in host_cache.items():
        leaf = torch.as_tensor(leaf, device="cpu")
        if name == "length":
            fresh = torch.zeros((new_spec.num_slots,), dtype=leaf.dtype)
            for old, new in slot_map.items():
                fresh[new] = leaf[old]
        else:
            fill = 1.0 if name.endswith("_scale") else 0.0
            fresh = torch.full(
                (leaf.shape[0], new_spec.num_slots) + tuple(leaf.shape[2:]),
                fill, dtype=leaf.dtype)
            for old, new in slot_map.items():
                fresh[:, new] = leaf[:, old]
        out[name] = fresh
    return out
