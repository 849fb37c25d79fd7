"""Device-mesh planning (port of ``dlrover_tpu/parallel/mesh.py``).

``MeshPlan`` keeps the reference's axis names and its refit arithmetic.
``MeshPlan.build`` turns a plan into a ``ProcessMesh``: the process
groups of its axes over the ranks of ``torch.distributed``, where the
reference builds a ``jax.sharding.Mesh`` over devices. The ranks are
laid out as the reference lays out devices
(``np.arange(world).reshape(shape)``, axes outer -> inner), so on a
``(data x fsdp)`` mesh rank ``r`` sits at ``data = r // fsdp``, ``fsdp =
r % fsdp``. The "fsdp" group of a rank holds the ranks of its data index
(``fsdp`` consecutive ranks), its "data" group the ranks of its fsdp
index (a stride of ``fsdp``), and the group over both axes is the world.
Those groups are made once per world and reused by every later build.
The pipe, seq and tensor axes raise (ROADMAP A15, A13).

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
        Every rank must call it (a group over part of the world is made
        by all ranks). Without a process group the mesh holds the layout
        and no group."""
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        plan = self.resolve(world)
        for axis, item in (("pipe", "A15"), ("seq", "A13"),
                           ("tensor", "A15")):
            if getattr(plan, axis) > 1:
                raise NotImplementedError(
                    f"mesh axis {axis!r} of size {getattr(plan, axis)} is "
                    f"not ported yet (ROADMAP {item})")
        sizes = plan.axis_sizes()
        groups = {}
        rank = 0
        if world > 1 and dist.is_initialized():
            rank = dist.get_rank()
            big = tuple(a for a in ("data", "fsdp") if sizes[a] > 1)
            groups[big] = dist.group.WORLD
            if len(big) == 2:
                groups.update(_axis_groups(plan.data, plan.fsdp, rank))
        return ProcessMesh(axis_names=MESH_AXES,
                           axis_sizes=tuple(sizes[a] for a in MESH_AXES),
                           groups=groups, rank=rank)


# the "fsdp" and "data" groups of every (data x fsdp) mesh built over
# the current world process group, by (data, fsdp); a new world (after
# ``destroy_process_group``) drops them
_GROUP_CACHE: Dict = {}


def _axis_groups(d: int, f: int, rank: int) -> Dict[Tuple[str, ...], object]:
    """This rank's "fsdp" and "data" groups of a (d x f) mesh. Every
    rank makes every group, in the same order, once per world: later
    builds (a retune, a rebuilt step) reuse them, since a NCCL group
    holds a communicator and its device buffers."""
    world = dist.group.WORLD
    if _GROUP_CACHE.get("world") is not world:
        _GROUP_CACHE.clear()
        _GROUP_CACHE["world"] = world
    if (d, f) not in _GROUP_CACHE:
        mine = {}
        for axis, members in (
                [("fsdp", [i * f + j for j in range(f)]) for i in range(d)]
                + [("data", [i * f + j for i in range(d)])
                   for j in range(f)]):
            group = dist.new_group(members)
            if rank in members:
                mine[(axis,)] = group
        _GROUP_CACHE[(d, f)] = mine
    return _GROUP_CACHE[(d, f)]


@dataclass
class ProcessMesh:
    """Axis names and sizes (``jax.sharding.Mesh``'s two attributes the
    port reads), this process's rank, and the process group over each
    set of axes of size > 1 that it is a member of, keyed by those axes
    in mesh order."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], object] = field(default_factory=dict)
    rank: int = 0

    @classmethod
    def over(cls, axis: str, group=None) -> "ProcessMesh":
        """A one-axis mesh over ``group`` (default: every rank)."""
        group = group or dist.group.WORLD
        return cls((axis,), (dist.get_world_size(group),), {(axis,): group},
                   dist.get_rank(group))

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def group(self, axes: Sequence[str]):
        """The process group spanning ``axes`` (None when they all have
        size 1)."""
        sizes = self.sizes
        big = tuple(a for a in self.axis_names
                    if a in axes and sizes[a] > 1)
        if not big:
            return None
        if big not in self.groups:
            raise RuntimeError(
                f"no process group over {big}: build the mesh with the "
                f"process group initialized")
        return self.groups[big]


def topology_key(devices: Sequence[torch.device]) -> str:
    """Stable identity of a device set (the trainer's program key)."""
    return "|".join(f"{d.type}:{d.index if d.index is not None else 0}"
                    for d in devices)


def mesh_axes_key(plan: MeshPlan) -> str:
    """Stable identity of a mesh factorization ("pipe.data.fsdp.seq.
    tensor"), as the reference keys its program cache."""
    return (f"{plan.pipe}.{plan.data}.{plan.fsdp}"
            f".{plan.seq}.{plan.tensor}")


def single_device_plan() -> MeshPlan:
    return MeshPlan(pipe=1, data=1, fsdp=1, seq=1, tensor=1)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]
