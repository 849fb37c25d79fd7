"""``accelerate`` — from (init, loss, optimizer, strategy) to a train step
(port of ``dlrover_tpu/parallel/accelerate.py``).

The reference jits a pure step over sharded state. PyTorch runs
eagerly, so the step here is a Python function over a ``TrainState``
whose parameters and optimizer moments are updated IN PLACE (the step
returns the same state object): that keeps one copy of the model and
its moments in device memory instead of two. Gradient accumulation
(the fixed-global-batch elasticity lever) sums microbatch gradients,
then divides by their count, as the reference's scan does.

Several ranks (``torch.distributed`` initialised, e.g. by
``trainer.bootstrap.init_worker``): the strategy's mesh is built over
them (``MeshPlan.build``; data parallel, ``fsdp == 1``, in this slice)
and set as the ambient mesh around every step, where the MoE finds its
expert group. Each rank takes its contiguous block of the global
batch's rows, as the reference shards dim 0 over "data". After the
backward, a replicated leaf's gradient is all-reduced as a mean; a
sharded leaf (``strategy.is_sharded``: the experts under "moe_ep") has
already received every rank's contribution through the dispatch's
reverse exchange and is divided by the rank count. Each rank's loss is
the mean over its own rows; the reported loss is the mean of the ranks'
(the global mean when every rank has as many labelled tokens), and the
gradient norm and finite check are global.

``steps_per_call = K > 1`` also builds ``train_step_multi``: K optimizer
steps in one call over K stacked batches, each the single step's own
arithmetic with the same rng stream, so it is bit for bit K calls of
``train_step``; its metrics come back stacked along a leading [K] axis,
and nothing between the K steps waits on the device. A low-precision
gradient wire comes with a later slice (ROADMAP A14) and raises here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.ops.remat import apply_remat
from dlrover_tpu_torch.ops.shard_compat import ambient_mesh
from dlrover_tpu_torch.parallel.mesh import ProcessMesh
from dlrover_tpu_torch.parallel.strategy import Strategy, is_sharded

logger = get_logger("parallel.accelerate")

# loss_fn contract: (params, batch, rng) -> (scalar_loss, aux_dict)
LossFn = Callable[[Any, Any, Any], Tuple[torch.Tensor, dict]]
# optimizer contract: (list of parameter tensors) -> torch.optim.Optimizer,
# e.g. functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1)
OptimizerFn = Callable[[list], torch.optim.Optimizer]


@dataclass
class TrainState:
    step: int
    params: Dict  # nested dict of leaf tensors with requires_grad
    opt_state: torch.optim.Optimizer  # holds the moments of ``params``


@dataclass
class AccelerateResult:
    train_step: Callable  # (state, batch, rng) -> (state, metrics)
    eval_step: Callable  # (state, batch) -> metrics
    init_fn: Callable  # (seed) -> TrainState
    device: torch.device
    strategy: Strategy
    mesh: ProcessMesh
    rank: int = 0
    world: int = 1
    # (state, stacked batches [K, rows, ...], rng) -> (state, metrics
    # stacked [K, ...]); None when steps_per_call == 1
    train_step_multi: Optional[Callable] = None
    steps_per_call: int = 1

    def shard_batch(self, batch: Dict, stacked: bool = False) -> Dict:
        """Global host batch (numpy arrays or tensors) -> this rank's
        contiguous block of its rows, as tensors on the device.
        ``stacked``: the batch has a leading K axis (``train_step_multi``'s
        input), and the rows are axis 1."""
        axis = 1 if stacked else 0
        rows = _rows(batch, axis) // self.world
        lo = self.rank * rows
        return {k: torch.as_tensor(v).narrow(axis, lo, rows).to(
                    self.device, non_blocking=True)
                for k, v in batch.items()}


def _rows(batch: Dict, axis: int = 0) -> int:
    return next(iter(batch.values())).shape[axis]


def _named_leaves(tree, prefix=""):
    """(path, tensor) pairs in ``tree_leaves``' sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def accelerate(
    init_fn: Callable[[torch.Generator], Dict],
    loss_fn: LossFn,
    optimizer: OptimizerFn,
    example_batch: Dict,
    strategy: Optional[Strategy] = None,
    rng: int = 0,
    device: DeviceLike = None,
    steps_per_call: int = 1,
    grad_precision: Optional[str] = None,
) -> AccelerateResult:
    """Build the training step.

    Args:
      init_fn: generator -> params tree (drawn on the generator's device,
        or anywhere: leaves are moved to ``device``).
      loss_fn: (params, batch, rng) -> (loss, aux dict).
      optimizer: parameter list -> ``torch.optim.Optimizer``.
      example_batch: host batch with the GLOBAL batch dimension.
      strategy: mesh/rules/remat/accum decisions; the mesh must fit the
        ranks of ``torch.distributed`` (one when it is not initialised).
      rng: seed of the init generator.
      device: default ``cuda`` (raises without one); tests pass "cpu".
      steps_per_call: K > 1 builds ``train_step_multi`` beside the step.
    """
    device = resolve_device(device)
    steps_per_call = max(1, int(steps_per_call))
    if (grad_precision or "bf16") != "bf16":
        raise NotImplementedError(
            f"grad_precision {grad_precision!r}: only the exact gradient "
            "path (bf16) is ported"
        )
    strategy = strategy or Strategy()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = strategy.mesh.build(world)
    group = mesh.group(("data", "fsdp"))
    batch_rows = _rows(example_batch)
    if strategy.global_batch_size and strategy.global_batch_size != batch_rows:
        raise ValueError(
            f"strategy.global_batch_size={strategy.global_batch_size} but "
            f"the example batch has {batch_rows} rows"
        )
    if batch_rows % world:
        raise ValueError(f"{world} ranks do not split the global batch of "
                         f"{batch_rows} rows")
    accum = max(1, strategy.grad_accum_steps)
    if (batch_rows // world) % accum:
        raise ValueError(
            f"grad_accum_steps={accum} does not divide the "
            f"{batch_rows // world} rows of each of {world} ranks"
        )
    strategy = dataclasses.replace(strategy, global_batch_size=batch_rows)
    loss_fn = apply_remat(loss_fn, strategy.remat_policy or "none")

    def make_state(seed: int = rng) -> TrainState:
        gen = torch.Generator(device=device).manual_seed(int(seed))

        def leaf(t):
            t = t.detach().to(device)
            return t.requires_grad_(t.is_floating_point())

        def walk(node):
            if isinstance(node, dict):
                return {k: walk(v) for k, v in node.items()}
            return leaf(node)

        params = walk(init_fn(gen))
        return TrainState(step=0, params=params,
                          opt_state=optimizer(tree_leaves(params)))

    def reduce_grads(named):
        """The global gradient on every rank, and its norm."""
        shard_sq = torch.zeros((), device=device)
        rep_sq = torch.zeros((), device=device)
        for path, p in named:
            if is_sharded(strategy.rule_set, path):
                p.grad.div_(world)
                shard_sq = shard_sq + p.grad.float().square().sum()
            else:
                ring.all_reduce_(p.grad, group).div_(world)
                rep_sq = rep_sq + p.grad.float().square().sum()
        return torch.sqrt(rep_sq + ring.all_reduce_(shard_sq, group))

    def train_step(state: TrainState, batch: Dict, step_rng=None):
        with ambient_mesh(mesh):
            return _train_step(state, batch, step_rng)

    def _train_step(state: TrainState, batch: Dict, step_rng=None):
        named = [(path, p) for path, p in _named_leaves(state.params)
                 if p.requires_grad]
        for _, p in named:
            p.grad = None
        if accum == 1:
            loss, aux = loss_fn(state.params, batch, step_rng)
            loss.backward()
            loss = loss.detach()
        else:
            mbs = [{k: v.chunk(accum, dim=0)[i] for k, v in batch.items()}
                   for i in range(accum)]
            loss, auxes = torch.zeros((), device=device), []
            for mb in mbs:
                mb_loss, mb_aux = loss_fn(state.params, mb, step_rng)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                auxes.append(mb_aux)
            for _, p in named:
                p.grad.div_(accum)
            loss = loss / accum
            aux = {k: torch.stack([torch.as_tensor(a[k]) for a in auxes]
                                  ).mean(dim=0) for k in auxes[0]}
        if world > 1:
            grad_norm = reduce_grads(named)
            loss = ring.all_reduce_(loss.clone(), group) / world
        else:
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad.float())
                 for _, p in named]))
        metrics = {
            **aux,
            "loss": loss,
            "grad_norm": grad_norm,
            # any non-finite gradient reaches the global norm
            "finite": torch.isfinite(loss) & torch.isfinite(grad_norm),
            "step": state.step + 1,
        }
        state.opt_state.step()
        state.step += 1
        return state, metrics

    def train_step_multi(state: TrainState, batches: Dict, step_rng=None):
        """K = ``steps_per_call`` steps over ``batches`` (this rank's
        rows of K batches, stacked on a leading axis), each drawing from
        ``step_rng`` in turn, as K calls would. Metrics come back stacked
        [K, ...]."""
        k = _rows(batches)
        if k != steps_per_call:
            raise ValueError(f"train_step_multi takes {steps_per_call} "
                             f"stacked batches, got {k}")
        per_step = []
        with ambient_mesh(mesh):
            for i in range(k):
                state, metrics = _train_step(
                    state, {key: v[i] for key, v in batches.items()},
                    step_rng)
                per_step.append(metrics)
        return state, {key: torch.stack([torch.as_tensor(m[key])
                                         for m in per_step])
                       for key in per_step[0]}

    def eval_step(state: TrainState, batch: Dict):
        with torch.no_grad(), ambient_mesh(mesh):
            loss, aux = loss_fn(state.params, batch, None)
            if world > 1:
                loss = ring.all_reduce_(loss.clone(), group) / world
        return {"loss": loss, **aux}

    if rank == 0:
        logger.info("accelerate: device=%s ranks=%d rules=%s accum=%d "
                    "remat=%s steps_per_call=%d", device, world,
                    strategy.rule_set, accum,
                    strategy.remat_policy or "none", steps_per_call)
    return AccelerateResult(
        train_step=train_step, eval_step=eval_step, init_fn=make_state,
        device=device, strategy=strategy, mesh=mesh, rank=rank, world=world,
        train_step_multi=train_step_multi if steps_per_call > 1 else None,
        steps_per_call=steps_per_call,
    )
