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
them (``MeshPlan.build``, a ``(data x fsdp x seq)`` mesh) and set as the
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

Sequence parallelism (a mesh with seq > 1, ROADMAP A13; the model runs
ring attention, ``seq_axis="seq"``): the seq ranks of a row block hold
the same rows and split each row's tokens, seq rank i the contiguous
block ``[i S/n, (i+1) S/n)`` of every ``[B, S]`` key (the labels are
the next tokens already, so a block's last label is the next block's
first token). No leaf is split on seq, so a leaf's gradient is summed
over the seq ranks as well as over its other axes, and divided by the
number of row blocks (data x fsdp), not by the world. A rank's loss is
its tokens' sum over the whole rows' labelled tokens (``models.
losses``), so the seq ranks' losses sum to the rows' loss: the reported
loss is the sum over (data, fsdp, seq) over the row blocks. With seq =
1 every figure is the (data x fsdp) step's.

``steps_per_call = K > 1`` also builds ``train_step_multi``: K optimizer
steps in one call over K stacked batches, each the single step's own
arithmetic with the same rng stream, so it is bit for bit K calls of
``train_step``; its metrics come back stacked along a leading [K] axis,
and nothing between the K steps waits on the device.

The precision wires (ROADMAP A14). The dense FSDP wire: when the loss
function carries ``fsdp_wire`` (``models.llama.make_loss_fn``) and it
resolves to "fp8", each gathered leaf it wires has its block quantized
on its rank (blocks of 32 along the last dim, which no wired leaf is
split on, so the blocks are the global leaf's) and only the e4m3 values
and f32 scales are all-gathered; under "fp8_qdq" the block is decoded
first and gathered at full precision (the bitwise reference). The model
gets the gathered forms under ``fsdp_wire.key`` and, in the
wired leaf's place, a full-shape gradient route that holds no values;
the gradient that reaches it is reduce-scattered to the block as any
gathered leaf's. The gradient wire (``grad_precision`` "fp8"): once the
gradients are reduced and divided, each float leaf's block is quantized
with the error-feedback residual ``TrainState.wire_residual`` (zeros in
the parameters' layout at first, None under "bf16") added back, and the
norm, the finite check and the optimizer see the decoded gradients.

The FSDP layer prefetch (ROADMAP A6b): when the loss function's
``fsdp_wire`` says the call runs it (``fsdp_prefetch`` resolved on at
that call, two layers or more) and a stacked layer leaf is gathered,
those leaves are not gathered whole. The step hands the model a
``parallel.layer_prefetch.LayerSource`` under ``fsdp_wire.layer_key``
instead, from which each layer's block takes its layer's full
parameters (a broadcast from the rank holding the layer, or an
all-gather of its slice), the next layer's already in flight, and which
reduces each layer's gradient into the blocks as soon as the layer's
backward is done; under the fp8 wire the owner quantizes the layer and
only the wire forms travel. The other leaves are gathered once a step
as above. With the prefetch off the step is the whole-tree step.

A two-gradient optimizer (one with ``update_with_grad_fn``,
``optimizers.wsam``) is handed a function that runs the whole forward
and backward again at the parameters' current values on the same batch
and returns the reduced gradients. An optimizer factory that takes
``norm_groups`` is handed, for each parameter, the process group its
block is split over (None: whole on every rank), so a global norm sums
each block's squares over its axes.
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
from dlrover_tpu_torch.models.common import (
    segment_positions,
    tree_leaves,
    tree_map,
)
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.ops.quantize import (
    GRAD_PRECISIONS,
    WIRE_DTYPE,
    dequantize_block_scaled,
    error_feedback_qdq,
    quantize_block_scaled,
    resolve_quant_block,
)
from dlrover_tpu_torch.ops.remat import apply_remat, remat_enabled
from dlrover_tpu_torch.ops.ring_attention import PREFIX_HOST
from dlrover_tpu_torch.ops.shard_compat import (
    ambient_mesh,
    fp8_wire_supported,
)
from dlrover_tpu_torch.parallel import layer_prefetch
from dlrover_tpu_torch.parallel.mesh import ProcessMesh
from dlrover_tpu_torch.parallel.sharding_rules import (
    BATCH_AXES,
    STEP_AXES,
    ShardingRules,
    ShardLayout,
    batch_sharding,
    step_sizes,
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
    # the gradient wire's error-feedback residual: the parameters' tree
    # of zeros-at-first, each rank holding its block (None under the
    # exact "bf16" gradient path); saved, snapshotted and regrouped with
    # the parameters
    wire_residual: Optional[Dict] = None


class PlacedBatch(dict):
    """This rank's rows on its device, as ``placed_by.shard_batch``
    placed them (``stacked``: with the leading K axis), marked so by
    whoever placed them ahead of the step (``trainer.data``'s
    ``DevicePreloader``). The same result's ``shard_batch`` with the same
    ``stacked`` hands its tensors on as they are, in a plain dict:
    placing them twice would take a block of a block."""

    def __init__(self, tensors: Dict, placed_by: "AccelerateResult",
                 stacked: bool = False):
        super().__init__(tensors)
        self.placed_by = placed_by
        self.stacked = stacked


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
    # parameter tree -> the optimizer over its leaves (the factory,
    # handed the norm groups where it takes them)
    make_optimizer: Optional[Callable[[Dict], torch.optim.Optimizer]] = None

    @property
    def specs(self) -> Dict[str, tuple]:
        """Each parameter path's spec under the strategy's rules (none
        on one rank, where every leaf is whole)."""
        return tree_specs(self.strategy.rules(), self.mesh,
                          self.layout.shapes)

    @property
    def seq(self) -> int:
        """The seq ranks each row's tokens are split over."""
        return self.mesh.sizes.get("seq", 1)

    def shard_batch(self, batch: Dict, stacked: bool = False) -> Dict:
        """A host batch (numpy arrays or tensors) -> this rank's rows,
        as tensors on the device. The batch holds either the global
        rows or this process's own rows (``global_batch_size`` over the
        row blocks, data x fsdp: the reference's ``put_global_batch``,
        where process p's rows are global rows [p R/P, (p+1) R/P)); any
        other row count raises. Of the global rows the rank takes its
        block over ("data", "fsdp") (``batch_sharding``) of each
        microbatch: the reference cuts the GLOBAL batch into
        ``grad_accum_steps`` microbatches, each split over the devices,
        so rank r's microbatch i is its block of global rows [i R/A,
        (i+1) R/A) (with one microbatch, its contiguous block of the
        batch: its process's rows). With several microbatches those
        blocks lie in other processes' rows, so process-local rows are
        first all-gathered over the batch's group into the global batch
        (``ring.gather_shard``, one exchange of the rows). ``stacked``:
        the batch has a leading K axis (``train_step_multi``'s input),
        and the rows are axis 1. A ``PlacedBatch`` this result placed
        passes through. Over seq ranks, see ``_seq_block``."""
        if (isinstance(batch, PlacedBatch) and batch.placed_by is self
                and batch.stacked == stacked):
            return dict(batch)
        axis = 1 if stacked else 0
        rows = _rows(batch, axis)
        total = self.strategy.global_batch_size or rows
        row_ranks = self.world // self.seq
        per = total // row_ranks
        accum = max(1, self.strategy.grad_accum_steps)
        if rows not in (total, per):
            raise ValueError(
                f"shard_batch takes the global batch ({total} rows) or "
                f"this process's rows ({per} = {total} over {row_ranks} "
                f"row blocks), got {rows}")
        tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
        if rows != total:
            if accum == 1:
                return self._placed(self._seq_block(tensors, axis))
            group = self.mesh.group(batch_sharding()[0])
            tensors = {k: ring.gather_shard(t.to(self.device), axis, group)
                       for k, t in tensors.items()}
        mb, part = total // accum, per // accum
        block = self.rank // self.seq
        starts = [i * mb + block * part for i in range(accum)]

        def take(t):
            pieces = [t.narrow(axis, lo, part) for lo in starts]
            return pieces[0] if len(pieces) == 1 else torch.cat(pieces, axis)

        return self._placed(self._seq_block(
            {k: take(t) for k, t in tensors.items()}, axis))

    def _placed(self, tensors: Dict) -> Dict:
        """Each tensor on the device but the host copy of the prompt
        lengths."""
        return {k: t if k == PREFIX_HOST else
                t.to(self.device, non_blocking=True)
                for k, t in tensors.items()}

    def _seq_block(self, tensors: Dict, axis: int) -> Dict:
        """This rank's block of each row's tokens (none without seq
        ranks): seq rank i takes ``[i S/n, (i+1) S/n)`` of every key
        whose dim after the rows has ``input_ids``' length S. Packed
        rows (``segment_ids``) gain ``positions``, each token's position
        in its document over the whole row (a document may begin on an
        earlier rank); ``prefix_len`` stays per row, with a host copy
        under ``PREFIX_HOST`` (the prefix ring's skips)."""
        n = self.seq
        if n == 1:
            return tensors
        s = tensors["input_ids"].shape[axis + 1]
        if s % n:
            raise ValueError(f"{n} seq ranks do not split rows of {s} "
                             f"tokens")
        local = s // n
        lo = (self.rank % n) * local
        if "segment_ids" in tensors and "positions" not in tensors:
            ids = tensors["segment_ids"]
            tensors = {**tensors, "positions": segment_positions(
                ids.reshape(-1, s)).reshape(ids.shape)}
        out = {k: (t.narrow(axis + 1, lo, local)
                   if t.dim() > axis + 1 and t.shape[axis + 1] == s else t)
               for k, t in tensors.items()}
        if "prefix_len" in tensors:
            lens = tensors["prefix_len"]
            # the meta device's count has no values to copy
            out[PREFIX_HOST] = lens if lens.is_meta else lens.cpu()
        return out


def _rows(batch: Dict, axis: int = 0) -> int:
    return next(iter(batch.values())).shape[axis]


def _named_leaves(tree, prefix=""):
    """(path, tensor) pairs in ``tree_leaves``' sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def resolve_grad_precision(requested: Optional[str] = None,
                           device: DeviceLike = None) -> str:
    """The gradient wire's precision at build time: ``requested`` when
    given, else the Context's (``grad_precision``). A quantized choice
    degrades to "bf16", with a warning, when ``device`` fails the fp8
    probe. A build-time knob: the residual changes the state."""
    p = (requested or "").strip()
    if not p:
        p = str(get_context().grad_precision or "bf16").strip() or "bf16"
    if p not in GRAD_PRECISIONS:
        raise ValueError(f"unknown grad precision {p!r}; choose one of "
                         f"{GRAD_PRECISIONS}")
    if p != "bf16" and not fp8_wire_supported(device):
        logger.warning("grad precision %r requested but the device fails "
                       "the fp8 probe; gradients stay exact (bf16 path)", p)
        return "bf16"
    return p


def _apply_grad_wire(named, residual: Dict, grad_precision: str,
                     block_of: Callable[[str, torch.Tensor], int]) -> None:
    """The error-feedback quantized gradient path, in place: each float
    non-scalar leaf's gradient becomes its decoded quantization, and
    its residual the error (zeros under "fp8_nofb"). ``block_of(path,
    grad)``: the scale block, from the global leaf's last dim."""
    feedback = grad_precision != "fp8_nofb"
    res = dict(_named_leaves(residual))
    with torch.no_grad():
        for path, p in named:
            g, r = p.grad, res.get(path)
            if r is None or g is None or g.dim() == 0 \
                    or not g.is_floating_point():
                continue
            gq, nr = error_feedback_qdq(g, r, feedback=feedback,
                                        block=block_of(path, g))
            g.copy_(gq)
            r.copy_(nr)


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
      grad_precision: "bf16" (exact) | "fp8" (error feedback, the
        residual in ``TrainState.wire_residual``) | "fp8_nofb" (the
        control); None: the Context's (``resolve_grad_precision``).
    """
    device = resolve_device(device)
    steps_per_call = max(1, int(steps_per_call))
    grad_precision = resolve_grad_precision(grad_precision, device)
    strategy = strategy or Strategy()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mesh = strategy.mesh.build(world)
    # every rank: the losses and the replicated leaves' gradients
    group = mesh.group(STEP_AXES)
    # the row blocks (data x fsdp): what a gradient and a loss divide by
    row_ranks = world // mesh.sizes.get("seq", 1)
    batch_rows = _rows(example_batch)
    if strategy.global_batch_size and strategy.global_batch_size != batch_rows:
        raise ValueError(
            f"strategy.global_batch_size={strategy.global_batch_size} but "
            f"the example batch has {batch_rows} rows"
        )
    if batch_rows % row_ranks:
        raise ValueError(f"{row_ranks} row blocks do not split the global "
                         f"batch of {batch_rows} rows")
    accum = max(1, strategy.grad_accum_steps)
    if (batch_rows // row_ranks) % accum:
        raise ValueError(
            f"grad_accum_steps={accum} does not divide the "
            f"{batch_rows // row_ranks} rows of each of {row_ranks} row "
            f"blocks"
        )
    strategy = dataclasses.replace(strategy, global_batch_size=batch_rows)
    fsdp_wire = getattr(loss_fn, "fsdp_wire", None)
    loss_fn = apply_remat(loss_fn, strategy.remat_policy or "none")
    rule_set = strategy.rule_set
    layout = _layout(init_fn, strategy.rules(), rule_set, mesh)
    # the leaves gathered for the step, with the group of their axes; a
    # sharded leaf's gradient is all-reduced over its other dp axes
    gather = {path: mesh.group(shard.axes)
              for path, shard in layout.leaves.items()
              if not block_consumed(rule_set, path)}
    rest = {path: mesh.group(tuple(a for a in STEP_AXES
                                   if a not in shard.axes))
            for path, shard in layout.leaves.items()}
    # the gathered leaves the model's FSDP wire may quantize, and the
    # scale block of each (the global leaf's last dim: no wired leaf is
    # split along it, so a block's quantize is the global leaf's)
    wired: Dict[str, int] = {}
    if fsdp_wire is not None:
        for path in gather:
            shape = layout.shapes[path]
            if not fsdp_wire.wired(path, torch.empty(
                    shape, device="meta")):
                continue
            if layout.leaves[path].dim == len(shape) - 1:
                raise ValueError(
                    f"the FSDP wire quantizes {path} in blocks along its "
                    f"last dim, which the rules split: a rank's blocks "
                    f"would not be the global leaf's")
            wired[path] = resolve_quant_block(shape[-1])
    # the gathered layer stacks, which the layer prefetch makes full a
    # layer at a time
    layer_paths = sorted(p for p in gather if p.startswith("layers/"))
    # the gradient wire's scale block of each leaf, from its global
    # leaf's last dim; a rank's block of a leaf split along that dim
    # must hold whole blocks
    grad_blocks: Dict[str, int] = {}

    def grad_block(path: str, t: torch.Tensor) -> int:
        if path not in grad_blocks:
            full = layout.shapes.get(path, tuple(t.shape))
            block = resolve_quant_block(full[-1])
            if t.shape[-1] % block:
                raise ValueError(
                    f"the gradient wire's {block}-channel blocks of {path} "
                    f"straddle the ranks' blocks ({t.shape[-1]} of "
                    f"{full[-1]} channels a rank)")
            grad_blocks[path] = block
        return grad_blocks[path]

    takes_groups = "norm_groups" in inspect.signature(
        optimizer).parameters

    def make_optimizer(params: Dict) -> torch.optim.Optimizer:
        """The optimizer over the leaves of ``params`` (in
        ``tree_leaves`` order), handed each leaf's norm group where the
        factory takes them."""
        leaves = tree_leaves(params)
        if not takes_groups:
            return optimizer(leaves)
        groups = []
        for path, _ in _named_leaves(params):
            shard = layout.leaves.get(path) if world > 1 else None
            groups.append(None if shard is None else mesh.group(shard.axes))
        return optimizer(leaves, norm_groups=groups)

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
        residual = None
        if grad_precision != "bf16":
            residual = tree_map(lambda t: torch.zeros_like(
                t, requires_grad=False), params)
        return TrainState(step=0, params=params,
                          opt_state=make_optimizer(params),
                          wire_residual=residual)

    def wire_gather(node, path: str, mode: str) -> Dict:
        """The gathered wire form of a wired leaf's block: its e4m3
        values (as bytes on the wire) and f32 scales under "fp8", its
        decode at full precision under "fp8_qdq"."""
        dim, group = layout.leaves[path].dim, gather[path]
        v, s = quantize_block_scaled(node.detach(), wired[path])
        if mode == "fp8":
            v = ring.gather_shard(v.view(torch.uint8), dim, group)
            return {"v": v.view(WIRE_DTYPE),
                    "s": ring.gather_shard(s, dim, group)}
        dq = dequantize_block_scaled(v, s, node.dtype)
        return {"dq": ring.gather_shard(dq, dim, group)}

    def layer_source(params, microbatches: int, grad: bool):
        """The layer prefetch's source for one forward (and backward) of
        ``microbatches`` microbatches, when this call runs the prefetch
        and a layer stack is gathered; None otherwise."""
        if fsdp_wire is None or not layer_paths or not fsdp_wire.prefetch():
            return None
        if remat_enabled(strategy.remat_policy):
            raise ValueError(
                f"the FSDP layer prefetch takes the model's remat policy; "
                f"the strategy's remat_policy="
                f"{strategy.remat_policy!r} would run every layer's "
                f"gather again in the backward")
        mode = fsdp_wire.mode(device) if wired else "bf16"
        blocks = dict(_named_leaves(params))
        leaves = [layer_prefetch.LayerLeaf(
            path[len("layers/"):], blocks[path], layout.leaves[path].dim,
            gather[path], wired.get(path, 0) if mode != "bf16" else 0)
            for path in layer_paths]
        # the backward fetches each layer again where the model's remat
        # policy runs its block again
        plan = layer_prefetch.layer_plan(
            fsdp_wire.config.num_layers, microbatches,
            recompute=grad and remat_enabled(fsdp_wire.config.remat_policy))
        return layer_prefetch.LayerSource(leaves, plan, mode, device)

    def gathered(params, fulls, grad: bool, source=None):
        """``params`` with each gathered leaf full; ``fulls`` collects
        (the gather's output, or None for a wired leaf, and the leaf the
        model sees) by path. The leaves of ``source`` (a layer source)
        are left out, and it is handed over in their place. The gathered
        layer stacks count as every layer held while they live."""
        mode = fsdp_wire.mode(device) if wired else "bf16"
        forms: Dict[str, Dict] = {}
        stacks = []
        skip = {f"layers/{p}" for p in source.paths} if source else ()

        def walk(node, prefix=""):
            if isinstance(node, dict):
                out = {k: walk(node[k], f"{prefix}{k}/")
                       for k in sorted(node)}
                return {k: v for k, v in out.items() if v is not None}
            path = prefix.rstrip("/")
            if path in skip:
                return None
            if path not in gather:
                return node
            dim = layout.leaves[path].dim
            if mode != "bf16" and path in wired:
                forms[path[len("layers/"):]] = wire_gather(node, path, mode)
                stacks.extend(forms[path[len("layers/"):]].values())
                # the gradient's route: the full shape, no values
                seen = torch.zeros((), dtype=node.dtype,
                                   device=node.device).expand(
                                       layout.shapes[path])
                if grad and node.requires_grad:
                    seen.requires_grad_()
                    fulls[path] = (None, seen)
                return seen
            if not (grad and node.requires_grad):
                full = ring.gather_shard(node, dim, gather[path])
            else:
                full = ring.all_gather_shard(node, dim, gather[path])
                fulls[path] = (full, full.detach().requires_grad_())
            if path in layer_paths:
                stacks.append(full)
            return fulls[path][1] if path in fulls else full

        if not gather:
            return params
        out = walk(params)
        if forms:
            out[fsdp_wire.key] = forms
        if source is not None:
            out[fsdp_wire.layer_key] = source
        if stacks:
            layer_prefetch.hold(layout.shapes[layer_paths[0]][0], stacks)
        return out

    def reduce_grads(named) -> None:
        """The global gradient on every rank: a replicated leaf's summed
        over every rank, a block's over the axes it is not split on
        (seq included), each divided by the row blocks' count."""
        for path, p in named:
            shard = layout.leaves.get(path)
            if shard is None:
                ring.all_reduce_(p.grad, group)
            elif rest[path] is not None:
                ring.all_reduce_(p.grad, rest[path])
            p.grad.div_(row_ranks)

    def grad_norm_of(named) -> torch.Tensor:
        """The global gradient norm: a block's squares summed over the
        group of its axes."""
        if world == 1:
            return torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad.float())
                 for _, p in named]))
        total = torch.zeros((), device=device)
        # the squares of the sharded blocks, summed over their axes' group
        shard_sq = {BATCH_AXES: torch.zeros((), device=device)}
        for path, p in named:
            shard = layout.leaves.get(path)
            sq = p.grad.float().square().sum()
            if shard is None:
                total = total + sq
            else:
                shard_sq[shard.axes] = shard_sq.get(
                    shard.axes, torch.zeros((), device=device)) + sq
        for axes in sorted(shard_sq):
            axes_group = mesh.group(axes)
            total = total + (shard_sq[axes] if axes_group is None else
                             ring.all_reduce_(shard_sq[axes], axes_group))
        return torch.sqrt(total)

    def train_step(state: TrainState, batch: Dict, step_rng=None):
        with ambient_mesh(mesh):
            return _train_step(state, batch, step_rng)

    def _train_step(state: TrainState, batch: Dict, step_rng=None):
        named = [(path, p) for path, p in _named_leaves(state.params)
                 if p.requires_grad]
        loss, aux = compute_grads(state.params, named, batch, step_rng)
        if state.wire_residual is not None:
            _apply_grad_wire(named, state.wire_residual, grad_precision,
                             grad_block)
        grad_norm = grad_norm_of(named)
        metrics = {
            **aux,
            "loss": loss,
            "grad_norm": grad_norm,
            # any non-finite gradient reaches the global norm
            "finite": torch.isfinite(loss) & torch.isfinite(grad_norm),
            "step": state.step + 1,
        }
        opt = state.opt_state
        if hasattr(opt, "update_with_grad_fn"):
            # a two-gradient optimizer: a whole forward and backward at
            # the parameters it sets, on this batch
            def grad_fn() -> list:
                saved = [p.grad for _, p in named]
                compute_grads(state.params, named, batch, step_rng)
                out = {id(p): p.grad for _, p in named}
                for (_, p), g in zip(named, saved):
                    p.grad = g
                return [out.get(id(p)) for p in tree_leaves(state.params)]

            opt.update_with_grad_fn(grad_fn)
        else:
            opt.step()
        state.step += 1
        return state, metrics

    def compute_grads(params_tree, named, batch: Dict, step_rng):
        """The forward and backward on ``batch`` at the parameters'
        values: each parameter's ``grad`` the global gradient (reduced
        and divided over the ranks). Returns the loss (the ranks' mean)
        and the loss function's aux."""
        for _, p in named:
            p.grad = None
        # gathered once a step, before the forward (the layer stacks a
        # layer at a time under the layer prefetch, from ``source``,
        # which reduces their gradients into the blocks)
        source = layer_source(params_tree, accum, grad=True)
        fulls: Dict[str, Tuple[Optional[torch.Tensor], torch.Tensor]] = {}
        params = gathered(params_tree, fulls, grad=True, source=source)
        seen = [fulls[path][1] if path in fulls else p for path, p in named]
        if accum == 1:
            loss, aux = loss_fn(params, batch, step_rng)
            loss.backward()
            loss = loss.detach()
            if source is not None:
                source.finish()
        else:
            mbs = [{k: v.chunk(accum, dim=0)[i] for k, v in batch.items()}
                   for i in range(accum)]
            loss, auxes = torch.zeros((), device=device), []
            for mb in mbs:
                mb_loss, mb_aux = loss_fn(params, mb, step_rng)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
                auxes.append(mb_aux)
            if source is not None:
                source.finish()
            for t in seen:
                t.grad.div_(accum)
            loss = loss / accum
            aux = {k: torch.stack([torch.as_tensor(a[k]) for a in auxes]
                                  ).mean(dim=0) for k in auxes[0]}
        # each full gradient back to its block (the gather's backward),
        # in path order on every rank; the gathered copies go with it. A
        # wired leaf's gradient route is reduce-scattered the same way
        blocks_of = dict(named)
        for path in sorted(fulls):
            full, leaf = fulls.pop(path)
            if full is not None:
                full.backward(leaf.grad)
                continue
            block = ring.scatter_sum(leaf.grad, layout.leaves[path].dim,
                                     gather[path])
            p = blocks_of[path]
            p.grad = block if p.grad is None else p.grad.add_(block)
        del params, seen
        if world > 1:
            reduce_grads(named)
            loss = ring.all_reduce_(loss.clone(), group) / row_ranks
        return loss, aux

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
            source = layer_source(state.params, 1, grad=False)
            loss, aux = loss_fn(gathered(state.params, {}, grad=False,
                                         source=source), batch, None)
            if source is not None:
                source.finish()
            if world > 1:
                loss = ring.all_reduce_(loss.clone(), group) / row_ranks
        return {"loss": loss, **aux}

    if rank == 0:
        logger.info("accelerate: device=%s ranks=%d mesh=%s rules=%s "
                    "sharded=%d gathered=%d wired=%d accum=%d remat=%s "
                    "steps_per_call=%d grad_precision=%s", device, world,
                    layout.sizes, strategy.rule_set, len(layout.leaves),
                    len(gather), len(wired), accum,
                    strategy.remat_policy or "none", steps_per_call,
                    grad_precision)
    return AccelerateResult(
        train_step=train_step, eval_step=eval_step, init_fn=make_state,
        device=device, strategy=strategy, mesh=mesh, rank=rank, world=world,
        train_step_multi=train_step_multi if steps_per_call > 1 else None,
        steps_per_call=steps_per_call, layout=layout,
        make_optimizer=make_optimizer,
    )


def _layout(init_fn: Callable, rules: ShardingRules, rule_set: str,
            mesh: ProcessMesh) -> ShardLayout:
    """Where every leaf of ``init_fn``'s tree lives on ``mesh``'s
    ``(data x fsdp)`` axes, and "seq" (``step_sizes``): the tree's
    shapes from an init on the meta device (nothing drawn), made global
    where the init draws this rank's block (``block_consumed``), placed
    by ``rules``. On one rank every leaf is whole, and no shape is
    read."""
    from dlrover_tpu_torch.utils.meta_init import abstract_init

    sizes = step_sizes(mesh.sizes)
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
