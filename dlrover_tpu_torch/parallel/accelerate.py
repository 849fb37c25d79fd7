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
them (``MeshPlan.build``, a ``(data x fsdp)`` mesh) and set as the
ambient mesh around every step, where the MoE finds its expert group.
Every leaf is placed by the strategy's rule table
(``parallel.sharding_rules``): a leaf whose spec names an axis of size
> 1 is held as this rank's block of it (``AccelerateResult.layout``),
and the optimizer is built over the blocks, so each rank's parameters
and moments are 1/fsdp of the fsdp-sharded leaves (ZeRO-3's state
saving). At the step each such leaf is all-gathered once along its dim
(``ops.ring.all_gather_shard``), the model runs on the full leaves,
and once every microbatch's backward has run, the summed full gradient
is reduce-scattered back to the block (the gather's backward); the
gathered copies are then dropped. The experts under "moe_ep" are the exception:
the expert-parallel dispatch runs on each rank's own experts, which
are never gathered, and its reverse exchange already sums every rank's
contribution. Then a replicated leaf's gradient is all-reduced over the
whole (data x fsdp) group, a sharded leaf's block gradient over the
axes it is not split on ("data" for an fsdp leaf), and every gradient
is divided by the rank count. Each rank takes its block over ("data",
"fsdp") of each microbatch's rows (``shard_batch``). Each rank's loss
is the mean over its own rows; the reported loss is the mean of the
ranks' (the global mean when every rank has as many labelled tokens),
and the gradient norm and finite check are global.

``steps_per_call = K > 1`` also builds ``train_step_multi``: K optimizer
steps in one call over K stacked batches, each the single step's own
arithmetic with the same rng stream, so it is bit for bit K calls of
``train_step``; its metrics come back stacked along a leading [K] axis,
and nothing between the K steps waits on the device. A low-precision
gradient wire comes with a later slice (ROADMAP A14) and raises here.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
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
from dlrover_tpu_torch.parallel.sharding_rules import (
    BATCH_AXES,
    ShardingRules,
    ShardLayout,
    batch_sharding,
    tree_specs,
)
from dlrover_tpu_torch.parallel.strategy import Strategy, block_consumed

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

    # where every leaf lives: axis sizes, global shapes, sharded leaves
    layout: Optional[ShardLayout] = None

    @property
    def specs(self) -> Dict[str, tuple]:
        """Each parameter path's spec under the strategy's rules (none
        on one rank, where every leaf is whole)."""
        return tree_specs(self.strategy.rules(), self.mesh,
                          self.layout.shapes)

    def shard_batch(self, batch: Dict, stacked: bool = False) -> Dict:
        """A host batch (numpy arrays or tensors) -> this rank's rows,
        as tensors on the device. The batch holds either the global
        rows or this process's own rows (``global_batch_size // world``:
        the reference's ``put_global_batch``, where process p's rows are
        global rows [p R/P, (p+1) R/P)); any other row count raises. Of
        the global rows the rank takes its block over ("data", "fsdp")
        (``batch_sharding``) of each microbatch: the reference cuts the
        GLOBAL batch into ``grad_accum_steps`` microbatches, each split
        over the devices, so rank r's microbatch i is its block of
        global rows [i R/A, (i+1) R/A) (with one microbatch, its
        contiguous block of the batch: its process's rows). With
        several microbatches those blocks lie in other processes' rows,
        so process-local rows are first all-gathered over the batch's
        group into the global batch (``ring.gather_shard``, one exchange
        of the rows). ``stacked``: the batch has a leading K axis
        (``train_step_multi``'s input), and the rows are axis 1."""
        axis = 1 if stacked else 0
        rows = _rows(batch, axis)
        total = self.strategy.global_batch_size or rows
        per = total // self.world
        accum = max(1, self.strategy.grad_accum_steps)
        if rows not in (total, per):
            raise ValueError(
                f"shard_batch takes the global batch ({total} rows) or "
                f"this process's rows ({per} = {total} over {self.world} "
                f"ranks), got {rows}")
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        if rows != total:
            if accum == 1:
                return {k: t.to(self.device, non_blocking=True)
                        for k, t in tensors.items()}
            group = self.mesh.group(batch_sharding()[0])
            tensors = {k: ring.gather_shard(t.to(self.device), axis, group)
                       for k, t in tensors.items()}
        mb, part = total // accum, per // accum
        starts = [i * mb + self.rank * part for i in range(accum)]

        def take(t):
            pieces = [t.narrow(axis, lo, part) for lo in starts]
            t = pieces[0] if len(pieces) == 1 else torch.cat(pieces, axis)
            return t.to(self.device, non_blocking=True)

        return {k: take(t) for k, t in tensors.items()}


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
        or anywhere: leaves are moved to ``device``). An init with a
        ``keep`` parameter (``models.common.KeepLeaf``) is handed the
        cut to this rank's blocks, and keeps one full leaf at a time.
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
    rule_set = strategy.rule_set
    layout = _layout(init_fn, strategy.rules(), rule_set, mesh)
    # the leaves gathered for the step, with the group of their axes; a
    # sharded leaf's gradient is all-reduced over its other dp axes
    gather = {path: mesh.group(shard.axes)
              for path, shard in layout.leaves.items()
              if not block_consumed(rule_set, path)}
    rest = {path: mesh.group(tuple(a for a in BATCH_AXES
                                   if a not in shard.axes))
            for path, shard in layout.leaves.items()}

    def block_of(path: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a full leaf the init drew (a copy, so
        the full leaf is freed); a block, or a replicated leaf, as it
        is."""
        if path not in gather or tuple(t.shape) != layout.shapes[path]:
            return t
        return layout.block(t, rank, path).clone()

    takes_keep = "keep" in inspect.signature(init_fn).parameters

    def make_state(seed: int = rng) -> TrainState:
        gen = torch.Generator(device=device).manual_seed(int(seed))

        def leaf(path, t):
            t = block_of(path, t).detach().to(device)
            full = layout.shapes.get(path, tuple(t.shape))
            want = layout.local_shape(path, full)
            if tuple(t.shape) != want:
                raise ValueError(f"init leaf {path}: {tuple(t.shape)}, the "
                                 f"rules place {want} on this rank")
            return t.requires_grad_(t.is_floating_point())

        def walk(node, prefix=""):
            if isinstance(node, dict):
                return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
            return leaf(prefix.rstrip("/"), node)

        # an init that takes ``keep`` (the models' ``init``) keeps only
        # the blocks as it goes, one full leaf at a time; any other
        # init's full leaves are cut by ``walk``
        tree = init_fn(gen, keep=block_of) if takes_keep else init_fn(gen)
        params = walk(tree)
        return TrainState(step=0, params=params,
                          opt_state=optimizer(tree_leaves(params)))

    def gathered(params, fulls, grad: bool):
        """``params`` with each gathered leaf full; ``fulls`` collects
        (the gather's output, the leaf the model sees) by path."""
        def walk(node, prefix=""):
            if isinstance(node, dict):
                return {k: walk(node[k], f"{prefix}{k}/")
                        for k in sorted(node)}
            path = prefix.rstrip("/")
            if path not in gather:
                return node
            dim = layout.leaves[path].dim
            if not (grad and node.requires_grad):
                return ring.gather_shard(node, dim, gather[path])
            full = ring.all_gather_shard(node, dim, gather[path])
            seen = full.detach().requires_grad_()
            fulls[path] = (full, seen)
            return seen

        return walk(params) if gather else params

    def reduce_grads(named):
        """The global gradient on every rank, and its norm."""
        rep_sq = torch.zeros((), device=device)
        # the squares of the sharded blocks, summed over their axes' group
        shard_sq = {BATCH_AXES: torch.zeros((), device=device)}
        for path, p in named:
            shard = layout.leaves.get(path)
            if shard is None:
                ring.all_reduce_(p.grad, group).div_(world)
                rep_sq = rep_sq + p.grad.float().square().sum()
                continue
            if rest[path] is not None:
                ring.all_reduce_(p.grad, rest[path])
            p.grad.div_(world)
            shard_sq[shard.axes] = (
                shard_sq.get(shard.axes, torch.zeros((), device=device))
                + p.grad.float().square().sum())
        total = rep_sq
        for axes in sorted(shard_sq):
            total = total + ring.all_reduce_(shard_sq[axes],
                                             mesh.group(axes))
        return torch.sqrt(total)

    def train_step(state: TrainState, batch: Dict, step_rng=None):
        with ambient_mesh(mesh):
            return _train_step(state, batch, step_rng)

    def _train_step(state: TrainState, batch: Dict, step_rng=None):
        named = [(path, p) for path, p in _named_leaves(state.params)
                 if p.requires_grad]
        for _, p in named:
            p.grad = None
        # gathered once a step, before the forward
        fulls: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        params = gathered(state.params, fulls, grad=True)
        seen = [fulls[path][1] if path in fulls else p for path, p in named]
        if accum == 1:
            loss, aux = loss_fn(params, batch, step_rng)
            loss.backward()
            loss = loss.detach()
        else:
            mbs = [{k: v.chunk(accum, dim=0)[i] for k, v in batch.items()}
                   for i in range(accum)]
            loss, auxes = torch.zeros((), device=device), []
            for mb in mbs:
                mb_loss, mb_aux = loss_fn(params, mb, step_rng)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                auxes.append(mb_aux)
            for t in seen:
                t.grad.div_(accum)
            loss = loss / accum
            aux = {k: torch.stack([torch.as_tensor(a[k]) for a in auxes]
                                  ).mean(dim=0) for k in auxes[0]}
        # each full gradient back to its block (the gather's backward),
        # in path order on every rank; the gathered copies go with it
        for path in sorted(fulls):
            full, leaf = fulls.pop(path)
            full.backward(leaf.grad)
        del params, seen
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
            loss, aux = loss_fn(gathered(state.params, {}, grad=False),
                                batch, None)
            if world > 1:
                loss = ring.all_reduce_(loss.clone(), group) / world
        return {"loss": loss, **aux}

    if rank == 0:
        logger.info("accelerate: device=%s ranks=%d mesh=%s rules=%s "
                    "sharded=%d gathered=%d accum=%d remat=%s "
                    "steps_per_call=%d", device, world, layout.sizes,
                    strategy.rule_set, len(layout.leaves), len(gather),
                    accum,
                    strategy.remat_policy or "none", steps_per_call)
    return AccelerateResult(
        train_step=train_step, eval_step=eval_step, init_fn=make_state,
        device=device, strategy=strategy, mesh=mesh, rank=rank, world=world,
        train_step_multi=train_step_multi if steps_per_call > 1 else None,
        steps_per_call=steps_per_call, layout=layout,
    )


def _layout(init_fn: Callable, rules: ShardingRules, rule_set: str,
            mesh: ProcessMesh) -> ShardLayout:
    """Where every leaf of ``init_fn``'s tree lives on ``mesh``'s
    ``(data x fsdp)`` axes: the tree's shapes from an init on the meta
    device (nothing drawn), made global where the init draws this
    rank's block (``block_consumed``), placed by ``rules``. On one rank
    every leaf is whole, and no shape is read."""
    from dlrover_tpu_torch.utils.meta_init import abstract_init

    sizes = {a: mesh.sizes.get(a, 1) for a in BATCH_AXES}
    if math.prod(sizes.values()) == 1:
        return ShardLayout(sizes)
    shapes = {}
    for path, t in _named_leaves(abstract_init(init_fn)):
        shape = list(t.shape)
        spec = rules.raw_spec(path, len(shape))
        if block_consumed(rule_set, path) and isinstance(spec, tuple):
            # the block's dims times the sizes of the axes splitting them
            for dim, names in enumerate(spec):
                for axis in (names,) if isinstance(names, str) else (
                        names or ()):
                    shape[dim] *= sizes.get(axis, 1)
        shapes[path] = tuple(shape)
    return ShardLayout.build(rules, sizes, shapes)
