"""Device-mesh planning (port of ``dlrover_tpu/parallel/mesh.py``).

``MeshPlan`` keeps the reference's axis names and its refit arithmetic.
This slice runs on one device; the ``DeviceMesh`` a plan builds for
FSDP over several GPUs comes with that slice.

Axis convention (outer -> inner): "pipe", "data", "fsdp", "seq",
"tensor".
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import torch

MESH_AXES = ("pipe", "data", "fsdp", "seq", "tensor")


@dataclass
class MeshPlan:
    """Declarative mesh shape; -1 on at most one axis means 'infer'."""

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {
            "pipe": self.pipe, "data": self.data, "fsdp": self.fsdp,
            "seq": self.seq, "tensor": self.tensor,
        }

    def resolve(self, num_devices: int) -> "MeshPlan":
        """Fill the -1 axis so the product equals num_devices."""
        sizes = self.axis_sizes()
        unknown = [k for k, v in sizes.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one -1 axis allowed: {sizes}")
        known = math.prod(v for v in sizes.values() if v != -1)
        if unknown:
            if num_devices % known:
                raise ValueError(
                    f"{num_devices} devices not divisible by fixed axes "
                    f"{sizes}"
                )
            sizes[unknown[0]] = num_devices // known
        elif known != num_devices:
            raise ValueError(
                f"mesh {sizes} wants {known} devices, have {num_devices}"
            )
        return MeshPlan(**sizes)

    def adjust_to_world(self, num_devices: int) -> "MeshPlan":
        """Refit for a new world size: tensor/seq/pipe are kept, and the
        data and fsdp axes absorb the change, preferring fsdp."""
        model_par = self.pipe * self.seq * self.tensor
        if num_devices % model_par:
            raise ValueError(
                f"world of {num_devices} devices cannot hold model-parallel "
                f"factor {model_par} (pipe x seq x tensor)"
            )
        dp_total = num_devices // model_par
        old_fsdp = max(1, self.fsdp)
        fsdp = max(
            (d for d in _divisors(dp_total) if d <= old_fsdp), default=1
        )
        return MeshPlan(pipe=self.pipe, data=dp_total // fsdp, fsdp=fsdp,
                        seq=self.seq, tensor=self.tensor)

    @property
    def dp_degree(self) -> int:
        return max(1, self.data) * max(1, self.fsdp)


def topology_key(devices: Sequence[torch.device]) -> str:
    """Stable identity of a device set (the trainer's program key)."""
    return "|".join(f"{d.type}:{d.index if d.index is not None else 0}"
                    for d in devices)


def single_device_plan() -> MeshPlan:
    return MeshPlan(pipe=1, data=1, fsdp=1, seq=1, tensor=1)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]
