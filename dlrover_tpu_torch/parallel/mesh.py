"""Device-mesh planning (port of ``dlrover_tpu/parallel/mesh.py``).

``MeshPlan`` keeps the reference's axis names and its refit arithmetic.
``MeshPlan.build`` turns a plan into a ``ProcessMesh``: the process
group of each axis of size > 1 over the ranks of ``torch.distributed``,
where the reference builds a ``jax.sharding.Mesh`` over devices. This
slice builds data-parallel meshes (``data x fsdp = world`` with
``fsdp == 1``); FSDP (``fsdp > 1``, ROADMAP A6/A7) and the model-parallel
axes raise.

Axis convention (outer -> inner): "pipe", "data", "fsdp", "seq",
"tensor".
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

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

    def build(self, world: Optional[int] = None) -> "ProcessMesh":
        """The process mesh of this plan over the ``world`` ranks of the
        default process group (default: its size, 1 when there is none).
        """
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        plan = self.resolve(world)
        if plan.fsdp > 1:
            raise NotImplementedError(
                f"fsdp={plan.fsdp}: sharded parameters (FSDP) are not "
                f"ported yet (ROADMAP A6/A7); use MeshPlan(data={world}, "
                f"fsdp=1)")
        for axis in ("pipe", "seq", "tensor"):
            if getattr(plan, axis) > 1:
                raise NotImplementedError(
                    f"mesh axis {axis!r} of size {getattr(plan, axis)} is "
                    f"not ported yet (ROADMAP)")
        groups = {}
        if plan.data > 1:
            # data x fsdp = world with fsdp == 1: the data axis spans
            # every rank, in rank order
            groups["data"] = dist.group.WORLD
        sizes = plan.axis_sizes()
        return ProcessMesh(axis_names=MESH_AXES,
                           axis_sizes=tuple(sizes[a] for a in MESH_AXES),
                           groups=groups)


@dataclass
class ProcessMesh:
    """Axis names and sizes (``jax.sharding.Mesh``'s two attributes the
    port reads), and the process group of each axis of size > 1."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    groups: Dict[str, object] = field(default_factory=dict)

    @classmethod
    def over(cls, axis: str, group=None) -> "ProcessMesh":
        """A one-axis mesh over ``group`` (default: every rank)."""
        group = group or dist.group.WORLD
        return cls((axis,), (dist.get_world_size(group),), {axis: group})

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (None when they all have
        size 1). Only one of them may be larger than 1 in this slice."""
        sizes = dict(zip(self.axis_names, self.axis_sizes))
        big = [a for a in axes if sizes[a] > 1]
        if len(big) > 1:
            raise NotImplementedError(
                f"a group over several axes of size > 1 {big} comes with "
                f"FSDP (ROADMAP A6/A7)")
        return self.groups[big[0]] if big else None


def topology_key(devices: Sequence[torch.device]) -> str:
    """Stable identity of a device set (the trainer's program key)."""
    return "|".join(f"{d.type}:{d.index if d.index is not None else 0}"
                    for d in devices)


def single_device_plan() -> MeshPlan:
    return MeshPlan(pipe=1, data=1, fsdp=1, seq=1, tensor=1)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]
