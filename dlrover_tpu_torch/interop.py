"""Parameter-tree conversion between the JAX package and the port.

Both sides keep one layout (nested dicts; stacked ``[L, ...]`` layer
weights; ``[in, out]`` kernels), so conversion is a copy per leaf. The
JAX side is handed over as numpy arrays (``jax.device_get(params)``),
so this module imports neither JAX nor the JAX package. f32 leaves
round-trip bitwise; bf16 leaves (numpy dtype ``bfloat16``) are moved as
their bits, and come back as f32, which holds every bf16 value exactly.

A rank of a ``(data x fsdp)`` mesh takes the same tree cut to its
blocks by a rule set's specs (``place``), as ``parallel.accelerate``
holds them: for the expert-parallel model (``rule_set="moe_ep"``) on
``MeshPlan(data=P)`` that is rank r's block of experts ``[r E/P, (r+1)
E/P)`` of the expert leaves (``expert_shard=(r, P)``), as the
reference's ``moe_ep`` rules shard them.

``kv_cache_from_numpy`` / ``kv_cache_to_numpy`` (and the same pair for
the prefix pool) carry a serving KV pool over leaf for leaf (the
reference's ``serving.kv_cache`` layout: ``k``/``v`` [L, S, T, KV, HD],
int8 ``k_scale``/``v_scale``, ``length`` [S] int32), so a cache state the
reference produced feeds the port's step functions.

``train_state_from_numpy`` carries a whole training state over: the
parameters as above, ``optax.adamw``'s moments into the per-parameter
slots of ``torch.optim.AdamW`` and the gradient wire's error-feedback
residual (``wire_residual``, laid out as the parameters), so a
checkpoint of the JAX package resumes in the port
(``train_state_to_numpy`` is its inverse).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # an owned, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


# a rank's place: (rank, {"data": d, "fsdp": f}, rule set)
Placement = Tuple[int, Dict[str, int], str]


def _placement(expert_shard, place) -> Optional[Placement]:
    if place is not None:
        if expert_shard is not None:
            raise ValueError("pass expert_shard or place, not both")
        return place
    if expert_shard is None:
        return None
    rank, ranks = expert_shard
    return rank, {"data": ranks, "fsdp": 1}, "moe_ep"


def _blocks(tree: Dict, place: Placement) -> Dict:
    """The rank's blocks of a tree of global numpy leaves, by the rule
    set's specs on the mesh."""
    from dlrover_tpu_torch.parallel.accelerate import _named_leaves
    from dlrover_tpu_torch.parallel.sharding_rules import ShardLayout
    from dlrover_tpu_torch.parallel.strategy import Strategy

    rank, sizes, rule_set = place
    named = _named_leaves(tree)
    layout = ShardLayout.build(Strategy(rule_set=rule_set).rules(),
                               dict(sizes),
                               {p: np.shape(a) for p, a in named})
    out: Dict = {}
    for path, a in named:
        a = np.asarray(a)
        shard = layout.leaves.get(path)
        if shard is not None:
            n = a.shape[shard.dim] // layout.blocks(path)
            lo = layout.block_index(rank, path) * n
            a = np.take(a, range(lo, lo + n), axis=shard.dim)
        node = out
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = a
    return out


def params_from_numpy(tree: Dict, device: DeviceLike = None,
                      expert_shard: Optional[Tuple[int, int]] = None,
                      place: Optional[Placement] = None) -> Dict:
    """Reference parameter tree (numpy leaves) -> the port's tree of
    tensors on ``device`` (default ``cuda``). ``place=(rank, {"data": d,
    "fsdp": f}, rule_set)``: every leaf cut to that rank's block by the
    rule set's specs on the ``(data x fsdp)`` mesh. ``expert_shard=(rank,
    P)`` is ``place=(rank, {"data": P, "fsdp": 1}, "moe_ep")``: the
    expert leaves hold that rank's block of experts."""
    dev = resolve_device(device)
    place = _placement(expert_shard, place)
    if place is not None:
        tree = _blocks(tree, place)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _leaf_to_torch(node, dev)

    return walk(tree)


def params_to_numpy(params: Dict) -> Dict:
    """The port's tree -> numpy leaves, ready for ``jnp.asarray``."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def kv_cache_from_numpy(cache: Dict, device: DeviceLike = None) -> Dict:
    """A reference KV pool (numpy leaves, ``jax.device_get(cache)``) ->
    the port's pool on ``device``; bf16 pages move as their bits."""
    dev = resolve_device(device)
    return {name: _leaf_to_torch(a, dev) for name, a in cache.items()}


def kv_cache_to_numpy(cache: Dict) -> Dict:
    """The port's KV pool -> numpy leaves (bf16 pages as f32, which holds
    every bf16 value exactly)."""
    out = {}
    for name, t in cache.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.numpy().copy()
    return out


# the prefix pool has the slot pool's leaves but ``length``
prefix_pool_from_numpy = kv_cache_from_numpy
prefix_pool_to_numpy = kv_cache_to_numpy


def _adam_state(opt_state):
    """The element of an optax state holding Adam's ``count``, ``mu``
    and ``nu`` (``optax.adamw``'s state is ``(ScaleByAdamState(count,
    mu, nu), EmptyState(), EmptyState())``)."""
    if all(hasattr(opt_state, k) for k in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for item in opt_state:
            found = _adam_state(item)
            if found is not None:
                return found
    return None


def _unflatten(pairs) -> Dict:
    tree: Dict = {}
    for path, leaf in pairs:
        node = tree
        *parents, last = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def train_state_from_numpy(state, optimizer, device: DeviceLike = None,
                           expert_shard: Optional[Tuple[int, int]] = None,
                           place: Optional[Placement] = None):
    """The reference's ``TrainState`` with numpy leaves
    (``jax.device_get(state)``; ``opt_state`` from ``optax.adamw``) ->
    the port's ``TrainState`` on ``device``: the parameters through
    ``params_from_numpy`` (``expert_shard`` or ``place`` as there: the
    moments are cut as their parameters), and an optimizer
    built by ``optimizer`` (a ``torch.optim.AdamW`` factory) whose
    per-parameter ``step``, ``exp_avg`` and ``exp_avg_sq`` are Adam's
    ``count``, ``mu`` and ``nu``, path for path."""
    from dlrover_tpu_torch.checkpoint.manager import slot_device
    from dlrover_tpu_torch.models.common import tree_leaves
    from dlrover_tpu_torch.parallel.accelerate import (
        TrainState,
        _named_leaves,
    )

    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("the reference state holds no Adam moments "
                         "(count, mu, nu)")
    place = _placement(expert_shard, place)
    params = params_from_numpy(state.params, device, place=place)
    mu = dict(_named_leaves(params_from_numpy(adam.mu, device,
                                              place=place)))
    nu = dict(_named_leaves(params_from_numpy(adam.nu, device,
                                              place=place)))
    for _, p in _named_leaves(params):
        p.requires_grad_(p.is_floating_point())
    opt = optimizer(tree_leaves(params))
    count = float(np.asarray(adam.count))
    for path, p in _named_leaves(params):
        opt.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=slot_device(opt, p, "step")),
            "exp_avg": mu[path].to(p.dtype),
            "exp_avg_sq": nu[path].to(p.dtype),
        }
    residual = getattr(state, "wire_residual", None)
    if residual is not None:
        residual = params_from_numpy(residual, device, place=place)
    return TrainState(step=int(np.asarray(state.step)), params=params,
                      opt_state=opt, wire_residual=residual)


def train_state_to_numpy(state) -> Dict:
    """The port's ``TrainState`` -> {"step", "params", "count", "mu",
    "nu"} as numpy (the reference's names for AdamW's ``step``,
    ``exp_avg`` and ``exp_avg_sq``; zeros and count 0 before the first
    step), and "wire_residual" when the state carries one."""
    from dlrover_tpu_torch.parallel.accelerate import _named_leaves

    named = _named_leaves(state.params)
    slots = state.opt_state.state
    counts = {float(slots[p]["step"]) for _, p in named if p in slots}
    if len(counts) > 1:
        raise ValueError(f"the parameters' step counts differ: {counts}")

    def moment(key):
        return params_to_numpy(_unflatten(
            (path, slots[p][key] if p in slots else torch.zeros_like(p))
            for path, p in named))

    out = {"step": int(state.step),
           "params": params_to_numpy(state.params),
           "count": int(counts.pop()) if counts else 0,
           "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}
    if getattr(state, "wire_residual", None) is not None:
        out["wire_residual"] = params_to_numpy(state.wire_residual)
    return out
