"""Parameter sharding rules: regex path -> spec (port of
``dlrover_tpu/parallel/sharding_rules.py``).

The engine and the tables are the reference's, pattern for pattern, over
a dict of mesh axis sizes instead of a ``jax.sharding.Mesh``. A spec is a
tuple with one entry a dim: ``None`` (replicated along it), a mesh axis
name, or a tuple of axis names (the dim split over their product,
outer axis first).

Rule grammar (first match wins):
  (r"attention/(q|k|v)_proj/kernel", ("embed", "tensor"))   explicit spec
  (r".*", FSDP_AUTO)                                        shard largest
                                                            divisible dim
                                                            on the fsdp axis
A tuple spec binds only at its own rank; an axis of size 1, or one that
does not divide the dim, replicates that dim.

Where the reference hands the specs to XLA, the port places each leaf by
them itself (``ShardLayout``, ``parallel.accelerate``): a rank holds its
block of every leaf whose spec names an axis of size > 1. With the pipe,
seq and tensor axes refused (``parallel.mesh``), at most one dim of a
leaf is sharded, over "fsdp" or over ("data", "fsdp").

The ``_pp`` tables and those of BERT, CLIP and GPT-2 come with their
models (ROADMAP A15, A17).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

FSDP_AUTO = "FSDP_AUTO"
REPLICATED = "REPLICATED"
# the data-parallel axes a batch's rows are split over, outer first
BATCH_AXES = ("data", "fsdp")

SpecLike = Union[str, Tuple, None]
Rule = Tuple[str, SpecLike]


def _auto_fsdp_spec(shape: Sequence[int], mesh_axis_sizes: Dict[str, int],
                    fsdp_axis: str = "fsdp") -> Tuple:
    """Shard the largest dim divisible by the fsdp axis size; replicate if
    nothing divides (small params aren't worth scattering)."""
    size = mesh_axis_sizes.get(fsdp_axis, 1)
    if size <= 1 or not shape:
        return tuple(None for _ in shape)
    best_dim, best_len = -1, 0
    for i, d in enumerate(shape):
        if d % size == 0 and d > best_len:
            best_dim, best_len = i, d
    spec = [None] * len(shape)
    if best_dim >= 0:
        spec[best_dim] = fsdp_axis
    return tuple(spec)


def _normalize_spec(spec: SpecLike, shape: Sequence[int],
                    mesh_axis_sizes: Dict[str, int]) -> Tuple:
    if spec == FSDP_AUTO:
        return _auto_fsdp_spec(shape, mesh_axis_sizes)
    if spec in (REPLICATED, None):
        return tuple(None for _ in shape)
    if isinstance(spec, str):
        raise ValueError(
            f"string spec {spec!r} is ambiguous: use FSDP_AUTO, REPLICATED "
            "or a tuple like (None, 'fsdp')"
        )
    spec = tuple(spec)
    if len(spec) != len(shape):
        raise ValueError(
            f"spec {spec} has rank {len(spec)} but tensor has rank "
            f"{len(shape)}"
        )
    out = []
    for dim, names in zip(shape, spec):
        if names is None:
            out.append(None)
            continue
        names_t = (names,) if isinstance(names, str) else tuple(names)
        total = math.prod(mesh_axis_sizes.get(n, 1) for n in names_t)
        if total <= 1 or dim % total != 0:
            out.append(None)  # axis collapsed or indivisible: replicate
        else:
            out.append(names if isinstance(names, str) else names_t)
    return tuple(out)


class ShardingRules:
    def __init__(self, rules: Optional[List[Rule]] = None,
                 default: SpecLike = FSDP_AUTO):
        self.rules = list(rules or [])
        self.default = default

    def raw_spec(self, path: str, ndim: int) -> SpecLike:
        """The rule that binds ``path`` at rank ``ndim``, unnormalized."""
        for pattern, spec in self.rules:
            if not re.search(pattern, path):
                continue
            # a tuple spec only binds at its exact rank; rank-mismatched
            # rules fall through (stacked [L, ...] and unstacked variants
            # of the same param coexist in one rule list)
            if isinstance(spec, (tuple, list)) and len(spec) != ndim:
                continue
            return spec
        return self.default

    def spec_for(self, path: str, shape: Sequence[int],
                 mesh_axis_sizes: Dict[str, int]) -> Tuple:
        return _normalize_spec(self.raw_spec(path, len(shape)), shape,
                               mesh_axis_sizes)


def _named_shapes(tree, prefix=""):
    """(path, shape) of a nested dict of tensors (or shapes), in sorted
    key order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _named_shapes(tree[k], f"{prefix}{k}/")]
    shape = tuple(getattr(tree, "shape", tree))
    return [(prefix.rstrip("/"), shape)]


def _axis_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


def tree_specs(rules: ShardingRules, mesh, tree) -> Dict[str, Tuple]:
    """Each path of a params tree (nested dicts of tensors or shapes,
    GLOBAL shapes) -> its spec on ``mesh`` (a ``ProcessMesh`` or a dict
    of axis sizes): the counterpart of the reference's
    ``tree_shardings``."""
    sizes = _axis_sizes(mesh)
    return {path: rules.spec_for(path, shape, sizes)
            for path, shape in _named_shapes(tree)}


def batch_sharding(mesh=None) -> Tuple:
    """The spec of an input batch: its leading (row) dim split over the
    data-parallel axes (``PartitionSpec(("data", "fsdp"))``)."""
    del mesh
    return (BATCH_AXES,)


# -- a rank's blocks ----------------------------------------------------------


def rank_coords(rank: int, sizes: Mapping[str, int],
                axes: Sequence[str]) -> Dict[str, int]:
    """Rank ``rank``'s index on each of ``axes`` (outer -> inner, the
    mesh's order), laid out as ``np.arange(world).reshape(shape)``."""
    coords = {}
    for axis in reversed(tuple(axes)):
        rank, coords[axis] = divmod(rank, max(1, sizes.get(axis, 1)))
    return {axis: coords[axis] for axis in axes}


@dataclass(frozen=True)
class LeafShard:
    """Where a sharded leaf is split: its dim and the mesh axes (outer
    first) whose product splits it."""

    dim: int
    axes: Tuple[str, ...]


def leaf_shard(spec: Tuple) -> Optional[LeafShard]:
    """The one sharded dim of a normalized spec; None when replicated."""
    dims = [(i, a) for i, a in enumerate(spec) if a is not None]
    if not dims:
        return None
    if len(dims) > 1:
        raise NotImplementedError(
            f"spec {spec} shards several dims; only one sharded dim a "
            f"leaf is ported (the tensor axis is ROADMAP A15)")
    dim, axes = dims[0]
    return LeafShard(dim, (axes,) if isinstance(axes, str) else tuple(axes))


@dataclass
class ShardLayout:
    """Where every leaf of a state lives on a ``(data x fsdp)`` mesh:
    the axis sizes (outer -> inner), the global shape of each parameter
    path and the ``LeafShard`` of each sharded one (absent: replicated).
    An optimizer slot of a parameter's rank is placed as the parameter;
    a scalar slot (AdamW's ``step``) is replicated."""

    sizes: Dict[str, int]
    shapes: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    leaves: Dict[str, LeafShard] = field(default_factory=dict)

    @classmethod
    def build(cls, rules: ShardingRules, sizes: Mapping[str, int],
              shapes: Mapping[str, Tuple[int, ...]]) -> "ShardLayout":
        leaves = {}
        for path, shape in shapes.items():
            shard = leaf_shard(rules.spec_for(path, shape, dict(sizes)))
            if shard is not None:
                leaves[path] = shard
        return cls(dict(sizes), dict(shapes), leaves)

    @property
    def world(self) -> int:
        return math.prod(self.sizes.values())

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.sizes)

    def blocks(self, path: str) -> int:
        """How many blocks the leaf at ``path`` is cut into (1:
        replicated)."""
        shard = self.leaves.get(path)
        if shard is None:
            return 1
        return math.prod(self.sizes[a] for a in shard.axes)

    def block_index(self, rank: int, path: str) -> int:
        """Which block of ``path`` rank ``rank`` holds (its coordinates
        on the leaf's axes, outer first)."""
        shard = self.leaves.get(path)
        if shard is None:
            return 0
        coords = rank_coords(rank, self.sizes, self.axes)
        index = 0
        for axis in shard.axes:
            index = index * self.sizes[axis] + coords[axis]
        return index

    def holders(self, path: str, index: int) -> List[int]:
        """The ranks that hold block ``index`` of ``path``."""
        return [r for r in range(self.world)
                if self.block_index(r, path) == index]

    def local_shape(self, path: str, shape: Sequence[int]
                    ) -> Tuple[int, ...]:
        """A rank's block shape of a tensor of global ``shape`` placed
        as ``path`` (a slot of another rank than its parameter's is
        replicated)."""
        shape = tuple(shape)
        shard = self.leaves.get(path)
        if shard is None or len(shape) != len(self.shapes[path]):
            return shape
        out = list(shape)
        out[shard.dim] //= self.blocks(path)
        return tuple(out)

    def block(self, t, rank: int, path: str):
        """Rank ``rank``'s block of the global tensor ``t`` (a view)."""
        shard = self.leaves.get(path)
        if shard is None or t.dim() != len(self.shapes[path]):
            return t
        n = t.shape[shard.dim] // self.blocks(path)
        return t.narrow(shard.dim, self.block_index(rank, path) * n, n)


# -- canonical rule sets ------------------------------------------------------


def llama_rules() -> ShardingRules:
    """Megatron-style TP + FSDP for llama-family transformers."""
    return ShardingRules(rules=[
        # scan-stacked layer params carry a leading layer dim (fsdp-sharded
        # where divisible gives ZeRO-3-style param scatter)
        (r"layers/.*(q_proj|k_proj|v_proj)/kernel$",
         ("fsdp", None, "tensor")),
        (r"layers/.*o_proj/kernel$", ("fsdp", "tensor", None)),
        (r"layers/.*(gate_proj|up_proj)/kernel$", ("fsdp", None, "tensor")),
        (r"layers/.*down_proj/kernel$", ("fsdp", "tensor", None)),
        # MoE blocks: experts over the (data x fsdp) submesh
        (r"layers/.*experts/up/kernel$",
         (None, ("data", "fsdp"), None, "tensor")),
        (r"layers/.*experts/down/kernel$",
         (None, ("data", "fsdp"), "tensor", None)),
        (r"layers/.*router/kernel$", REPLICATED),
        # unstacked variants (per-layer module trees)
        (r"(q_proj|k_proj|v_proj)/kernel$", (None, "tensor")),
        (r"o_proj/kernel$", ("tensor", None)),
        (r"(gate_proj|up_proj)/kernel$", (None, "tensor")),
        (r"down_proj/kernel$", ("tensor", None)),
        # embeddings / head: vocab-parallel
        (r"embed_tokens/embedding$", ("tensor", "fsdp")),
        (r"lm_head/kernel$", ("fsdp", "tensor")),
        # norms replicate
        (r"(norm|ln)[^/]*/(scale|bias)$", REPLICATED),
        (r".*", FSDP_AUTO),
    ])


def neox_rules() -> ShardingRules:
    """GPT-NeoX / GLM family: llama's Megatron column/row layout plus the
    bias vectors: a column-parallel projection's bias shards with its
    output dim; a row-parallel projection's bias replicates (it adds
    after the reduce)."""
    return ShardingRules(rules=[
        (r"layers/.*(q_proj|k_proj|v_proj|up_proj)/kernel$",
         ("fsdp", None, "tensor")),
        (r"layers/.*(q_proj|k_proj|v_proj|up_proj)/bias$",
         ("fsdp", "tensor")),
        (r"layers/.*(o_proj|down_proj)/kernel$", ("fsdp", "tensor", None)),
        (r"layers/.*(o_proj|down_proj)/bias$", ("fsdp", None)),
        (r"layers/.*(input_norm|post_norm)/(scale|bias)$", ("fsdp", None)),
        (r"embed_tokens/embedding$", ("tensor", "fsdp")),
        (r"(pos|block_pos)_embed/embedding$", (None, "fsdp")),
        (r"lm_head/kernel$", ("fsdp", "tensor")),
        (r"(norm|ln|final_norm)[^/]*/(scale|bias)$", REPLICATED),
        (r".*", FSDP_AUTO),
    ])


def glm_rules() -> ShardingRules:
    """GLM shares NeoX's biased-projection layout; the 2D position tables
    get their own fsdp rule (in neox_rules already)."""
    return neox_rules()


def moe_rules() -> ShardingRules:
    """Expert-parallel MoE: expert weight blocks sharded on the expert
    (data x fsdp) submesh; router replicated."""
    rules = llama_rules().rules
    return ShardingRules(rules=[
        # leading dim = experts, sharded over the (data x fsdp) submesh
        (r"experts/.*kernel$", (("data", "fsdp"), None, "tensor")),
        (r"router/kernel$", REPLICATED),
        *rules,
    ])


def moe_ep_rules() -> ShardingRules:
    """Expert-parallel MoE for the dropless ``dispatch="grouped_ep"``
    path: expert weight blocks sharded on the (data x fsdp) expert
    submesh like ``moe_rules``, the expert FFN dims unsharded (each rank
    runs the grouped kernels on its own experts). Dense (attention)
    params keep the llama TP/FSDP layout."""
    rules = llama_rules().rules
    return ShardingRules(rules=[
        # stacked [L, E, D, F] layer variants first (rank-4 binds here)
        (r"layers/.*experts/(up|down)/kernel$",
         (None, ("data", "fsdp"), None, None)),
        # unstacked [E, D, F] module trees (direct moe_ffn params)
        (r"experts/(up|down)/kernel$", (("data", "fsdp"), None, None)),
        (r"router/kernel$", REPLICATED),
        *rules,
    ])
