"""The acceleration strategy object (port of
``dlrover_tpu/parallel/strategy.py``): mesh, rules, remat and dtypes,
plus ``grad_accum_steps``, the lever that keeps the global batch fixed
when the world shrinks.

``rule_set`` names the sharding rules (``RULE_SETS``, the reference's
names; ``parallel.sharding_rules`` holds the tables). ``Strategy.rules``
returns them, and every placement in the port reads the spec they give
a leaf: ``parallel.accelerate`` keeps a rank's block of each leaf whose
spec names an axis of size > 1. One kind of leaf is consumed as a block
by the model itself and never gathered (``block_consumed``): the
experts under ``"moe_ep"``, which the expert-parallel dispatch runs on
the rank that holds them; every other sharded leaf is gathered for the
step. The reference's ``_pp``, BERT, CLIP and GPT-2 tables come with
their models (ROADMAP A15, A17) and raise here.
"""

from __future__ import annotations

import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.sharding_rules import (
    ShardingRules,
    glm_rules,
    llama_rules,
    moe_ep_rules,
    moe_rules,
    neox_rules,
)

RULE_SETS = {
    "fsdp": lambda: ShardingRules(),
    "llama": llama_rules,
    "moe": moe_rules,
    # dropless expert-parallel ("grouped_ep" dispatch): expert FFN dims
    # unsharded so the grouped kernels run on each rank's own experts;
    # experts over (data x fsdp) as in "moe"
    "moe_ep": moe_ep_rules,
    "neox": neox_rules,
    "glm": glm_rules,
}
# the reference's rule sets whose models are not ported yet
_LATER_RULE_SETS = {"llama_pp": "A15", "neox_pp": "A15", "glm_pp": "A15",
                    "gpt2_pp": "A15", "bert_pp": "A15", "bert": "A17",
                    "clip": "A17"}

# the leaves "moe_ep"'s dispatch consumes as this rank's block
_EXPERT_LEAF = re.compile(r"experts/(up|down)/kernel$")


def block_consumed(rule_set: str, path: str) -> bool:
    """Whether the model runs on this rank's block of the leaf at
    ``path`` ("a/b/c") as it is (the experts under ``"moe_ep"``: the
    init draws only them, and the step never gathers them)."""
    return rule_set == "moe_ep" and bool(_EXPERT_LEAF.search(path))


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

    def rules(self) -> ShardingRules:
        factory = RULE_SETS.get(self.rule_set)
        if factory is None:
            later = _LATER_RULE_SETS.get(self.rule_set)
            if later:
                raise NotImplementedError(
                    f"rule set {self.rule_set!r} comes with its model "
                    f"(ROADMAP {later})")
            raise ValueError(f"unknown rule set {self.rule_set!r}; "
                             f"have {sorted(RULE_SETS)}")
        return factory()

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
