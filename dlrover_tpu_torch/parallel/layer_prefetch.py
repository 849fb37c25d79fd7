"""The FSDP layer prefetch (ROADMAP A6b): per-layer gathers of the
stacked layer leaves, layer l + 1's issued before layer l computes, and
per-layer gradient reductions. Port of the reference's ``fsdp_prefetch``
(``dlrover_tpu/models/llama.py``: ``_prefetch_enabled``,
``_prefetch_gather`` and the double-buffered scan of ``apply_hidden``),
where a sharding constraint with no data dependency on layer l lets
XLA's scheduler run layer l + 1's gather under layer l's compute.

Which exchange makes a layer full. ``llama_rules`` shards the stacked
``[L, ...]`` layer leaves on their leading layer dim, so at fsdp = P a
rank holds L / P whole layers: layer l's parameters are a broadcast from
the rank that holds them, and their gradient a reduce to it. An
all-gather of "each rank's i-th local layer" would bring in P layers
consumed far apart in time, a working set growing with P. A leaf
sharded on another dim (where ``FSDP_AUTO`` picks it, or the experts
under "grouped") takes an all-gather of the layer's slice along dim - 1
and a reduce-scatter of the layer's gradient. Under the fp8 FSDP wire
the owner quantizes layer l of each wired leaf (or every rank its
slice) and only the e4m3 values and f32 scales travel; the model
decodes them at consumption, inside the remat'd block, and the
straight-through gradient of each layer is reduced the same way.

The schedule. ``parallel.accelerate`` builds a ``LayerSource`` for each
forward and backward with the plan of its requests: the forward's
layers 0 .. L-1 and, where the model's remat policy recomputes, the
backward's L-1 .. 0 (its re-gather), microbatch after microbatch. Each
request issues the plan's next one (``ops.ring``'s asynchronous forms)
before it waits for its own, so the gather of the next layer runs under
this layer's compute and the backward's re-gather of layer l - 1 under
layer l's backward; the last forward layer prefetches the backward's
first. Every rank runs the same plan, so the exchanges pair in order. A
request off the plan raises.

Why each block fetches its own layer. ``ops.remat`` wraps a layer in
non-reentrant ``torch.utils.checkpoint``, which keeps the block's tensor
inputs alive until the backward: full parameters handed in from outside
would live all step. So the layer's block takes them from the source
itself (``fetch``, an autograd function whose forward asks the source):
the forward's copy dies with the block's forward, the recompute in the
backward asks again (the re-gather), and the function's backward gets
the layer's whole gradient once, as soon as the layer's backward is
done; it is reduced to its owner (or reduce-scattered) and added into
the block's ``.grad`` once the next layer's reduction is issued. The
other way, packing the saved full parameters as ``(layer, path)``
tokens with ``saved_tensors_hooks``, would have to recognise every
tensor autograd saves that derives from a parameter (its compute-dtype
cast, its fp8 decode); the recompute derives them again by itself.

Under a remat policy that recomputes nothing ("none") the matmuls save
their weights (or their compute-dtype casts) for the backward, so every
layer's gathered parameters stay live from its forward to its backward
(the high-water mark is L) and the backward gathers nothing again.

Streams. Over NCCL the parts a layer's exchanges send (the owner's
quantize, a slice made contiguous) are made on the compute stream, which
the process group's stream waits for. Over gloo with a card (staged
through host memory) they are made on ``ring``'s copy stream, which the
source points past the work queued before the step (the parameters'
last update) and not past the layers queued since: the copy out of a
part then follows its making on one stream, while the host, a layer or
more ahead, never waits for the compute stream. The compute stream
reads such a part (the owner's own wire forms) after the host saw its
copy out end, and ``record_stream`` keeps its memory from the copy
stream's next allocation until the compute stream is done with it.

The high-water mark is measured, not assumed: a fetched layer counts as
held from the issue of its exchanges until the last tensor it handed
out is freed (each is watched by ``weakref.finalize``), and the
whole-tree step's gathered stacks count L layers while they live
(``hold``). ``stats()`` reports it with the fetches; the bytes of each
exchange are ``ops.ring``'s.
"""

from __future__ import annotations

import contextlib
import threading
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.ops.quantize import (
    WIRE_DTYPE,
    dequantize_block_scaled,
    quantize_block_scaled,
)

STATS: Dict[str, int] = {"held": 0, "held_high_water": 0, "fetches": 0}
_LOCK = threading.RLock()


def reset_stats() -> None:
    """Start a new high-water mark from what is held now."""
    with _LOCK:
        STATS["held_high_water"] = STATS["held"]
        STATS["fetches"] = 0


def stats() -> Dict[str, int]:
    with _LOCK:
        return dict(STATS)


class _Held:
    """``weight`` layers held from now until the last tensor given to
    ``watch`` is freed."""

    def __init__(self, weight: int = 1):
        self._weight, self._live = weight, 1
        with _LOCK:
            STATS["held"] += weight
            STATS["held_high_water"] = max(STATS["held_high_water"],
                                           STATS["held"])

    def watch(self, tensors: Sequence[torch.Tensor]) -> None:
        for t in tensors:
            with _LOCK:
                self._live += 1
            weakref.finalize(t, self._release)
        self._release()

    def _release(self) -> None:
        with _LOCK:
            self._live -= 1
            if self._live == 0:
                STATS["held"] -= self._weight


def hold(weight: int, tensors: Sequence[torch.Tensor]) -> None:
    """Count ``weight`` layers held while any of ``tensors`` lives."""
    _Held(weight).watch(tensors)


def layer_plan(num_layers: int, microbatches: int = 1,
               recompute: bool = True) -> List[int]:
    """The order a step asks for its layers: each microbatch's forward
    0 .. L-1, then, where the backward recomputes, its L-1 .. 0."""
    one = list(range(num_layers))
    if recompute:
        one += one[::-1]
    return one * max(1, microbatches)


@dataclass(frozen=True, eq=False)
class LayerLeaf:
    """One stacked layer leaf the source makes full: its path under
    "layers/", this rank's block of the ``[L, ...]`` stack (the
    parameter), the dim the block is cut on, the group of its axes, and
    the fp8 wire's scale block (0: not wired)."""

    path: str
    param: torch.Tensor
    dim: int
    group: object
    wire: int = 0

    def layer_shape(self) -> Tuple[int, ...]:
        shape = list(self.param.shape[1:])
        if self.dim > 0:
            shape[self.dim - 1] *= dist.get_world_size(self.group)
        return tuple(shape)

    def owner(self, layer: int) -> Tuple[int, int]:
        """(group rank holding ``layer``, its row in that block) of a
        leaf cut on the layer dim."""
        return divmod(layer, self.param.shape[0])


class _Fetch(torch.autograd.Function):
    """One layer's full parameters from the source: the forward takes
    them (the plan's next request), the backward hands their gradients
    to the source's reduction. ``anchor`` only puts the function on the
    graph. The take runs outside the dispatch modes: selective
    checkpointing replays the block's ops in the recompute and holds
    them to the forward's, which a take's exchanges are not (the
    forward's first take issues two layers, the recompute's one), and
    ``utils.prof.CostCounter`` does not count the source's own work
    (its exchanges report their bytes)."""

    @staticmethod
    def forward(ctx, source, layer, anchor):
        ctx.source, ctx.layer = source, layer
        with _disable_current_modes():
            values, forms = source._take(layer)
        if forms:
            ctx.mark_non_differentiable(*forms)
        return (*values, *forms)

    @staticmethod
    def backward(ctx, *grads):
        ctx.source._reduce(ctx.layer, grads[:len(ctx.source.leaves)])
        return None, None, None


class LayerSource:
    """Each layer's full parameters in the order of ``plan``, prefetched
    one request ahead, and each layer's gradient reduced into its
    leaves' blocks. ``mode``: the FSDP wire's precision at this step
    ("bf16" ships the parameters; "fp8" the wired leaves' e4m3 values
    and f32 scales; "fp8_qdq" their decode)."""

    def __init__(self, leaves: Sequence[LayerLeaf], plan: Sequence[int],
                 mode: str = "bf16", device: Optional[torch.device] = None):
        self.leaves = list(leaves)
        self.paths = [leaf.path for leaf in self.leaves]
        self._wired = [leaf for leaf in self.leaves
                       if leaf.wire and mode != "bf16"]
        self._mode = mode
        self._plan, self._pos = list(plan), 0
        # the exchanges of the plan's next request, issued ahead
        self._ahead: Optional[Tuple[_Held, list]] = None
        self._reducing: List[Tuple[LayerLeaf, int, ring.Pending]] = []
        self._written = set()
        device = torch.device(device or self.leaves[0].param.device)
        self._anchor = torch.zeros((), device=device,
                                   requires_grad=torch.is_grad_enabled())
        # staged exchanges: the parts are made on the copy stream, once
        # the work queued so far (the last optimizer step) has run
        self._side = None
        if device.type == "cuda" and any(
                ring.through_host(leaf.param, leaf.group)
                for leaf in self.leaves):
            self._side = ring.copy_stream(device)
            self._side.wait_stream(torch.cuda.current_stream(device))

    # -- the model's side ---------------------------------------------

    def fetch(self, layer: int) -> Tuple[Dict[str, torch.Tensor],
                                         Dict[str, Dict[str, torch.Tensor]]]:
        """Layer ``layer``'s full parameters by path (a wired leaf's
        entry is its gradient route: its shape, no values) and the wire
        forms of the wired leaves. Call it inside the remat'd block."""
        outs = _Fetch.apply(self, layer, self._anchor)
        n = len(self.leaves)
        values = dict(zip(self.paths, outs[:n]))
        forms, rest = {}, list(outs[n:])
        for leaf in self._wired:
            keys = ("v", "s") if self._mode == "fp8" else ("dq",)
            forms[leaf.path] = {k: rest.pop(0) for k in keys}
        return values, forms

    # -- the exchanges -------------------------------------------------

    def _send(self, leaf: LayerLeaf, layer: int,
              part: Optional[torch.Tensor], dtype: torch.dtype,
              shape: Tuple[int, ...]) -> ring.Pending:
        """One tensor of layer ``layer`` made full: ``part`` (this rank's
        slice, or the owner's whole tensor; None on a rank that does not
        own the layer) all-gathered along ``dim - 1``, or broadcast from
        the owner (``shape`` and ``dtype``: the full tensor's)."""
        if leaf.dim > 0:
            return ring.gather_shard_async(part, leaf.dim - 1, leaf.group)
        if part is None:  # only its shape and dtype are read
            part = torch.empty((), dtype=dtype,
                               device=leaf.param.device).expand(shape)
        return ring.broadcast_async(part, leaf.owner(layer)[0], leaf.group)

    def _issue(self, layer: int) -> Tuple[_Held, list]:
        """Layer ``layer``'s exchanges, issued now (on the copy stream
        when they are staged; see the module's docstring)."""
        with (torch.cuda.stream(self._side) if self._side is not None
              else contextlib.nullcontext()):
            return self._issue_here(layer)

    def _issue_here(self, layer: int) -> Tuple[_Held, list]:
        """Layer ``layer``'s exchanges, in leaf order (the wire forms
        after the values), on the current stream."""
        held = _Held()
        values, forms = [], []
        for leaf in self.leaves:
            block, shape = leaf.param.detach(), leaf.layer_shape()
            if leaf.dim > 0:
                part = block[layer]
            else:
                owner, row = leaf.owner(layer)
                part = (block[row] if dist.get_rank(leaf.group) == owner
                        else None)
            if leaf not in self._wired:
                values.append(self._send(leaf, layer, part, block.dtype,
                                         shape))
                continue
            values.append(None)  # the gradient route, made at the take
            v = s = None
            if part is not None:
                v, s = quantize_block_scaled(part, leaf.wire)
            if self._mode == "fp8":
                scales = shape[:-1] + (shape[-1] // leaf.wire,)
                forms.append(("v", self._send(
                    leaf, layer, None if v is None else v.view(torch.uint8),
                    torch.uint8, shape)))
                forms.append(("s", self._send(leaf, layer, s, torch.float32,
                                              scales)))
            else:
                dq = (None if v is None
                      else dequantize_block_scaled(v, s, block.dtype))
                forms.append(("dq", self._send(leaf, layer, dq, block.dtype,
                                               shape)))
        return held, [values, forms]

    def _take(self, layer: int):
        pos = self._pos
        if pos >= len(self._plan) or self._plan[pos] != layer:
            want = self._plan[pos] if pos < len(self._plan) else None
            raise RuntimeError(
                f"layer source: layer {layer} asked at request {pos}, "
                f"the plan's is {want} (plan {self._plan})")
        entry, self._ahead = self._ahead or self._issue(layer), None
        self._pos += 1
        if self._pos < len(self._plan):
            self._ahead = self._issue(self._plan[self._pos])
        held, (pending_values, pending_forms) = entry
        values = []
        for leaf, p in zip(self.leaves, pending_values):
            if p is None:
                values.append(torch.zeros(
                    (), dtype=leaf.param.dtype,
                    device=leaf.param.device).expand(leaf.layer_shape()))
            else:
                values.append(p.wait())
        forms = []
        for key, p in pending_forms:
            t = p.wait()
            forms.append(t.view(WIRE_DTYPE) if key == "v" else t)
        if self._side is not None:  # some were made on the copy stream
            current = torch.cuda.current_stream(self._anchor.device)
            for t in values + forms:
                t.record_stream(current)
        held.watch([v for v, p in zip(values, pending_values)
                    if p is not None] + forms)
        with _LOCK:
            STATS["fetches"] += 1
        return values, forms

    # -- the gradients -------------------------------------------------

    def _reduce(self, layer: int, grads) -> None:
        """Layer ``layer``'s gradients (in leaf order) to their blocks:
        the previous layer's reductions are completed first, this
        layer's issued."""
        self._complete()
        for leaf, g in zip(self.leaves, grads):
            if g is None:
                g = torch.zeros(leaf.layer_shape(), dtype=leaf.param.dtype,
                                device=leaf.param.device)
            if leaf.dim == 0:
                p = ring.reduce_async(g, leaf.owner(layer)[0], leaf.group)
            else:
                p = ring.scatter_sum_async(g, leaf.dim - 1, leaf.group)
            self._reducing.append((leaf, layer, p))

    def _complete(self) -> None:
        reducing, self._reducing = self._reducing, []
        for leaf, layer, p in reducing:
            part = p.wait()
            if part is None:  # reduced to another rank
                continue
            row = leaf.owner(layer)[1] if leaf.dim == 0 else layer
            param = leaf.param
            if param.grad is None:
                param.grad = torch.zeros_like(param)
            key = (leaf.path, row)
            if key in self._written:
                param.grad[row].add_(part)
            else:  # a copy: the reduced value itself, bit for bit
                param.grad[row].copy_(part)
                self._written.add(key)

    def finish(self) -> None:
        """After the backward (or the forward, in an evaluation): the
        last reductions completed into the blocks; the plan must have
        been taken whole."""
        if self._ahead is not None:
            _, (pending_values, pending_forms) = self._ahead
            self._ahead = None
            for p in pending_values + [p for _, p in pending_forms]:
                if p is not None:
                    p.wait()
        self._complete()
        if self._pos != len(self._plan):
            raise RuntimeError(
                f"layer source: {self._pos} of the plan's "
                f"{len(self._plan)} requests were taken (plan "
                f"{self._plan})")

