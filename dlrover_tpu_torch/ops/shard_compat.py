"""What the expert-parallel MoE asks of its surroundings (port of the
parts of ``dlrover_tpu/ops/shard_compat.py`` this slice runs): the fp8
wire's capability probe and the ambient mesh.

The ambient mesh is the process mesh ``parallel.accelerate`` sets up
around each train and eval step. A MoE config that names no mesh finds
its expert group there, so a config built before a world change keeps
working after it, as the reference's ambient-mesh lookup does.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger("ops.shard_compat")

_FP8_WIRE_SUPPORTED: Dict[str, bool] = {}
_AMBIENT_MESH = None


def fp8_wire_supported(device: Optional[torch.device] = None) -> bool:
    """Whether ``device`` (default: the CPU) can carry block-scaled fp8:
    ``torch.float8_e4m3fn`` exists and a cast round-trip runs there.
    Probed once per device type. ``ops.moe`` runs the bf16 wire, with a
    warning, when the probe fails, as the reference does."""
    kind = torch.device(device or "cpu").type
    if kind in _FP8_WIRE_SUPPORTED:
        return _FP8_WIRE_SUPPORTED[kind]
    ok = False
    dtype = getattr(torch, "float8_e4m3fn", None)
    if dtype is not None:
        try:
            x = torch.tensor([0.5, -448.0, 0.0], device=device)
            back = x.to(dtype).float().cpu()
            ok = back.tolist() == [0.5, -448.0, 0.0]
        except (RuntimeError, TypeError) as exc:
            logger.warning("fp8 wire probe failed on %s: %s", kind, exc)
    _FP8_WIRE_SUPPORTED[kind] = ok
    return ok


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Make ``mesh`` (a ``parallel.mesh.ProcessMesh``) the ambient mesh
    for the duration of the block."""
    global _AMBIENT_MESH
    saved, _AMBIENT_MESH = _AMBIENT_MESH, mesh
    try:
        yield mesh
    finally:
        _AMBIENT_MESH = saved


def ambient_mesh_with_axes(axes, min_size: int = 2):
    """The ambient mesh when it carries every axis in ``axes`` with a
    combined size >= ``min_size``; else None."""
    mesh = _AMBIENT_MESH
    if mesh is None or any(a not in mesh.axis_names for a in axes):
        return None
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    if math.prod(sizes[a] for a in axes) < min_size:
        return None
    return mesh
