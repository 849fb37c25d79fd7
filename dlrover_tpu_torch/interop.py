"""Parameter-tree conversion between the JAX package and the port.

Both sides keep one layout (nested dicts; stacked ``[L, ...]`` layer
weights; ``[in, out]`` kernels), so conversion is a copy per leaf. The
JAX side is handed over as numpy arrays (``jax.device_get(params)``),
so this module imports neither JAX nor the JAX package. f32 leaves
round-trip bitwise; bf16 leaves (numpy dtype ``bfloat16``) are moved as
their bits, and come back as f32, which holds every bf16 value exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device


def _leaf_to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # an owned, writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict, device: DeviceLike = None) -> Dict:
    """Reference parameter tree (numpy leaves) -> the port's tree of
    tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

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
