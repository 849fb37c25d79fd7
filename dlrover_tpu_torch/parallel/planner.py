"""Per-card capability for the port (the ``DeviceSpec`` of
``dlrover_tpu/parallel/planner.py:29-45``, with NVIDIA cards in place of
the TPU generations). The planner's search over meshes comes with
ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

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
