"""Parameter-tree conversion between the JAX package and the port.

Both sides keep one layout (nested dicts; stacked ``[L, ...]`` layer
weights; ``[in, out]`` kernels), so conversion is a copy per leaf. The
JAX side is handed over as numpy arrays (``jax.device_get(params)``),
so this module imports neither JAX nor the JAX package. f32 leaves
round-trip bitwise; bf16 leaves (numpy dtype ``bfloat16``) are moved as
their bits, and come back as f32, which holds every bf16 value exactly.

For the expert-parallel model (``rule_set="moe_ep"``) rank r of P takes
the same tree with the expert leaves (``experts/{up,down}/kernel``: the
expert dim is 1 of a stacked ``[L, E, ...]`` leaf, 0 of an ``[E, ...]``
one) cut to its block of experts ``[r E/P, (r+1) E/P)``, as the
reference's ``moe_ep`` rules shard them.
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


def _expert_block(a, expert_shard: Tuple[int, int]):
    rank, ranks = expert_shard
    axis = 1 if a.ndim == 4 else 0
    per, rest = divmod(a.shape[axis], ranks)
    if rest:
        raise ValueError(f"{a.shape[axis]} experts do not split over "
                         f"{ranks} ranks")
    return np.take(a, range(rank * per, (rank + 1) * per), axis=axis)


def params_from_numpy(tree: Dict, device: DeviceLike = None,
                      expert_shard: Optional[Tuple[int, int]] = None
                      ) -> Dict:
    """Reference parameter tree (numpy leaves) -> the port's tree of
    tensors on ``device`` (default ``cuda``); with ``expert_shard=(rank,
    P)`` the expert leaves hold that rank's block of experts."""
    dev = resolve_device(device)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if expert_shard is not None and path[-3:-1] in (
                ("experts", "up"), ("experts", "down")):
            node = _expert_block(np.asarray(node), expert_shard)
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
