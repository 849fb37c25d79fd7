"""The acceleration strategy object (port of
``dlrover_tpu/parallel/strategy.py``): mesh, rules, remat and dtypes,
plus ``grad_accum_steps``, the lever that keeps the global batch fixed
when the world shrinks.

``rule_set`` names the sharding rules. On the data-parallel meshes of
this slice (``fsdp == 1``) every rule set replicates every leaf, as the
reference's rules do with no fsdp or tensor axis to shard over, except
``"moe_ep"``: its expert leaves (``experts/{up,down}/kernel``, the
reference's ``moe_ep_rules``) are sharded over the expert group, each
rank holding its own E/P experts. The FSDP rules arrive with A6/A7.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

from dlrover_tpu_torch.parallel.mesh import MeshPlan

# the leaves "moe_ep" shards over the expert group
_EXPERT_LEAF = re.compile(r"experts/(up|down)/kernel$")


def is_sharded(rule_set: str, path: str) -> bool:
    """Whether the leaf at ``path`` ("a/b/c") holds only this rank's
    part under ``rule_set``; every other leaf is replicated."""
    return rule_set == "moe_ep" and bool(_EXPERT_LEAF.search(path))


def shard_dim(ndim: int) -> int:
    """The dim a sharded (expert) leaf is split on over the ranks: 1 of
    a stacked [L, E, ...] leaf, 0 of an [E, ...] one."""
    return 1 if ndim == 4 else 0


@dataclass
class DtypePolicy:
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    output_dtype: str = "float32"


@dataclass
class Strategy:
    mesh: MeshPlan = field(default_factory=MeshPlan)
    rule_set: str = "fsdp"
    remat_policy: str = ""  # "", "full", "dots_saveable", "nothing_saveable"
    dtypes: DtypePolicy = field(default_factory=DtypePolicy)
    grad_accum_steps: int = 1
    num_virtual: int = 1
    stage_depths: Optional[Tuple[int, ...]] = None
    # global batch row count; 0 = derived from the example batch
    global_batch_size: int = 0

    def adjust_to_world(self, num_devices: int,
                        prev_num_devices: Optional[int] = None) -> "Strategy":
        """Re-fit after a membership change, keeping the global batch
        fixed: grad_accum_steps scales inversely with the DP degree."""
        new_mesh = self.mesh.adjust_to_world(num_devices)
        accum = self.grad_accum_steps
        if prev_num_devices and prev_num_devices != num_devices:
            old_dp = max(1, self.mesh.adjust_to_world(
                prev_num_devices).dp_degree)
            new_dp = max(1, new_mesh.dp_degree)
            accum = max(1, round(self.grad_accum_steps * old_dp / new_dp))
            if self.global_batch_size > 0:
                divisors = [
                    d for d in range(1, self.global_batch_size + 1)
                    if self.global_batch_size % d == 0
                ]
                accum = min(divisors, key=lambda d: abs(d - accum))
        return dataclasses.replace(self, mesh=new_mesh,
                                   grad_accum_steps=accum)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Strategy":
        raw = json.loads(text)
        raw["mesh"] = MeshPlan(**raw.get("mesh", {}))
        raw["dtypes"] = DtypePolicy(**raw.get("dtypes", {}))
        if raw.get("stage_depths") is not None:
            raw["stage_depths"] = tuple(raw["stage_depths"])
        return cls(**raw)
