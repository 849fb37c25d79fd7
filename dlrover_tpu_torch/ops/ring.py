"""Collectives of the expert-parallel MoE and of the data-parallel step,
over ``torch.distributed`` (port of ``dlrover_tpu/ops/ring.py``, with the
one-shot exchange and the reductions the port's step needs beside it).

``x [P, ...]`` holds in block ``j`` what this rank sends to rank ``j``
of ``group``; an exchange returns ``[P, ...]`` whose block ``j`` is what
rank ``j`` sent here, ``lax.all_to_all(x, axis, 0, 0)``'s contract:

  ``all_to_all``       one ``all_to_all_single``;
  ``ring_all_to_all``  ``P - 1`` distance-``s`` point-to-point steps
                       (``batch_isend_irecv``): rank i sends block
                       i+s to rank i+s and receives rank i-s's block.
                       The diagonal block never touches the wire, and
                       every other block rides one step, so the bytes
                       are the one-shot exchange's minus the diagonal.

Both are ``torch.autograd.Function``s whose backward is the same
exchange: the operator is its own inverse (block j goes to rank j, and
the reply comes back from rank j into slot j). ``all_reduce_mean`` is
differentiable the same way, and ``all_reduce_`` reduces in place.

FSDP's two exchanges (``parallel.accelerate``) are adjoint to each
other, each the other's backward:

  ``all_gather_shard``  the group's blocks of a leaf, concatenated
                        along ``dim`` in group-rank order;
  ``reduce_scatter_``   the sum over the group of a full tensor, of
                        which this rank keeps its block along ``dim``.

On NCCL they are ``all_gather_into_tensor`` and
``reduce_scatter_tensor``. On gloo the all-gather is the list
``all_gather``, and the reduce-scatter an ``all_reduce`` of the staged
host tensor, of which the rank keeps its block (``narrow``): gloo's
reduce-scatter differs between torch versions, so the port does not
rely on it. Twice the wire bytes of a true reduce-scatter, on the host.

Tensors cross the wire as bytes (``view(torch.uint8)``): gloo has no
float8 type, and a byte permutation leaves every value as it was.

Transport by backend, chosen by the group's backend name, never by
catching a failure: NCCL takes the CUDA tensors as they are. Gloo's
point-to-point ops take host tensors only, so on a gloo group a CUDA
tensor is staged through pinned host memory (one copy out, the
collective, one copy back) for every helper here. That is the
transport of several ranks sharing one GPU, where NCCL refuses to run;
its time is the host's, not a collective's.

In this slice each step of the ring waits for its exchange before the
next starts, and the chunked dispatch's exchanges do not overlap its
grouped products yet.

``STATS`` counts each helper's calls, host seconds and bytes per rank
(``reset_stats``, ``stats``): an exchange its input buffer, an
all-reduce its tensor, an all-gather the gathered (full) tensor and a
reduce-scatter its full input, so one gather and one scatter of a leaf
count its global bytes each. On gloo the seconds are the whole
exchange, waits for the slowest rank included; on NCCL they are the
enqueue only.

Under a ``utils.prof.CostCounter`` each helper reports the bytes it puts
on the wire by the reference's HLO kind ("all-to-all",
"collective-permute" for the ring, "all-reduce", "all-gather",
"reduce-scatter") and runs uncounted; on
the meta device it only reports, and returns an output of the right
shape without calling the backend.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.utils import prof

STATS: Dict[str, Dict[str, float]] = {}


def reset_stats() -> None:
    STATS.clear()


def stats() -> Dict[str, Dict[str, float]]:
    return {k: dict(v) for k, v in STATS.items()}


def _count(name: str, t0: float, nbytes: int) -> None:
    entry = STATS.setdefault(name, {"calls": 0, "seconds": 0.0,
                                    "bytes": 0})
    entry["calls"] += 1
    entry["seconds"] += time.perf_counter() - t0
    entry["bytes"] += nbytes


def _staged(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group goes through host memory."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.uint8)


def _exchange(x: torch.Tensor, group, ring: bool) -> torch.Tensor:
    size = dist.get_world_size(group)
    if x.shape[0] != size:
        raise ValueError(f"exchange: leading dim {x.shape[0]} is not the "
                         f"group's {size} ranks")
    nbytes = x.numel() * x.element_size()
    prof.report_exchange("collective-permute" if ring else "all-to-all",
                         nbytes - (nbytes // size if ring else 0))
    if x.device.type == "meta":
        return torch.empty_like(x)
    with prof.uncounted():
        return _run_exchange(x, group, ring, size)


def _run_exchange(x: torch.Tensor, group, ring: bool,
                  size: int) -> torch.Tensor:
    t0 = time.perf_counter()
    flat = _as_bytes(x)
    staged = _staged(flat, group)
    src = _to_host(flat) if staged else flat
    out = torch.empty_like(src)
    if not ring:
        dist.all_to_all_single(out, src, group=group)
    else:
        me = dist.get_rank(group)
        out[me] = src[me]
        for s in range(1, size):
            to, frm = (me + s) % size, (me - s) % size
            ops = [dist.P2POp(dist.isend, src[to],
                              dist.get_global_rank(group, to), group),
                   dist.P2POp(dist.irecv, out[frm],
                              dist.get_global_rank(group, frm), group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    if staged:
        out = out.to(x.device)
    _count("ring_all_to_all" if ring else "all_to_all", t0,
           flat.numel() - (flat.numel() // size if ring else 0))
    return out.view(x.dtype).view(x.shape)


def exchange_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The one-shot exchange, outside autograd."""
    return _exchange(x, group, ring=False)


def exchange_ring(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ring exchange, outside autograd."""
    return _exchange(x, group, ring=True)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ring: bool):
        ctx.group, ctx.ring = group, ring
        return _exchange(x, group, ring)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group, ctx.ring), None, None


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable one-shot exchange of ``x [P, ...]``."""
    return _Exchange.apply(x, group, False)


def ring_all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable ring exchange of ``x [P, ...]``."""
    return _Exchange.apply(x, group, True)


def all_reduce_(t: torch.Tensor, group=None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of a contiguous tensor; returns it."""
    nbytes = t.numel() * t.element_size()
    prof.report_exchange("all-reduce", nbytes)
    if t.device.type == "meta":
        return t
    t0 = time.perf_counter()
    with prof.uncounted():
        if _staged(t, group):
            host = _to_host(t)
            dist.all_reduce(host, op=op, group=group)
            t.copy_(host)
        else:
            dist.all_reduce(t, op=op, group=group)
    _count("all_reduce", t0, nbytes)
    return t


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.contiguous().clone(), group).div_(
            dist.get_world_size(group))

    @staticmethod
    def backward(ctx, g):
        # every rank's output is the mean, so each input receives the
        # mean of the ranks' cotangents
        return all_reduce_(g.contiguous().clone(), ctx.group).div_(
            dist.get_world_size(ctx.group)), None


def all_reduce_mean(x: torch.Tensor, group: Optional[object] = None
                    ) -> torch.Tensor:
    """The mean of ``x`` over the group's ranks, differentiable."""
    return _AllReduceMean.apply(x, group)


# -- FSDP's all-gather and reduce-scatter ----------------------------------


def gather_shard(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The blocks ``x`` of the group's ranks concatenated along ``dim``
    (group-rank order), outside autograd."""
    size = dist.get_world_size(group)
    shape = list(x.shape)
    shape[dim] *= size
    nbytes = math.prod(shape) * x.element_size()
    prof.report_exchange("all-gather", nbytes)
    if x.device.type == "meta":
        return x.new_empty(shape)
    t0 = time.perf_counter()
    with prof.uncounted():
        # blocks stacked on a new leading dim: [P, *x.shape]
        src = x.detach().movedim(dim, 0).contiguous()
        if dist.get_backend(group) == "nccl":
            out = torch.empty((size,) + tuple(src.shape), dtype=x.dtype,
                              device=x.device)
            dist.all_gather_into_tensor(out, src, group=group)
        else:
            host = _to_host(src) if _staged(src, group) else src
            parts = [torch.empty_like(host) for _ in range(size)]
            dist.all_gather(parts, host, group=group)
            out = torch.stack(parts).to(x.device)
        out = out.reshape((size * src.shape[0],) + tuple(src.shape[1:]))
        out = out.movedim(0, dim).contiguous()
    _count("all_gather", t0, nbytes)
    return out


def scatter_sum(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the
    group, outside autograd; ``x`` is not changed."""
    size = dist.get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"reduce-scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {size} ranks")
    nbytes = x.numel() * x.element_size()
    prof.report_exchange("reduce-scatter", nbytes)
    n = x.shape[dim] // size
    if x.device.type == "meta":
        return x.narrow(dim, 0, n).clone()
    t0 = time.perf_counter()
    me = dist.get_rank(group)
    with prof.uncounted():
        src = x.detach().movedim(dim, 0).contiguous()
        if dist.get_backend(group) == "nccl":
            out = torch.empty((n,) + tuple(src.shape[1:]), dtype=x.dtype,
                              device=x.device)
            dist.reduce_scatter_tensor(out, src, group=group)
        else:
            host = _to_host(src) if _staged(src, group) else src.clone()
            dist.all_reduce(host, group=group)
            out = host.narrow(0, me * n, n).to(x.device)
        out = out.movedim(0, dim).contiguous()
    _count("reduce_scatter", t0, nbytes)
    return out


class _AllGatherShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return gather_shard(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        return scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return gather_shard(g, ctx.dim, ctx.group), None, None


def all_gather_shard(x: torch.Tensor, dim: int = 0,
                     group=None) -> torch.Tensor:
    """Differentiable all-gather of the group's blocks along ``dim``;
    the backward reduce-scatters the cotangent back to the block."""
    return _AllGatherShard.apply(x, dim, group)


def reduce_scatter_(x: torch.Tensor, dim: int = 0,
                    group=None) -> torch.Tensor:
    """Differentiable reduce-scatter (sum) of ``x`` along ``dim``: this
    rank's block; the backward all-gathers the cotangent."""
    return _ReduceScatter.apply(x, dim, group)
