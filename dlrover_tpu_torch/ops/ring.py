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
(``reset_stats``, ``stats``). On gloo the seconds are the whole
exchange, waits for the slowest rank included; on NCCL they are the
enqueue only.

Under a ``utils.prof.CostCounter`` each helper reports the bytes it puts
on the wire by the reference's HLO kind ("all-to-all",
"collective-permute" for the ring, "all-reduce") and runs uncounted; on
the meta device it only reports, and returns an output of the right
shape without calling the backend.
"""

from __future__ import annotations

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
