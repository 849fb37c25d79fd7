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
all-reduce, a broadcast and a reduce their tensor, an all-gather the
gathered (full) tensor and a reduce-scatter its full input, so one
gather and one scatter of a leaf count its global bytes each. On gloo
the seconds are the whole exchange, waits for the slowest rank
included; on NCCL they are the enqueue only.

Under a ``utils.prof.CostCounter`` each helper reports the bytes it puts
on the wire by the reference's HLO kind ("all-to-all",
"collective-permute" for the ring, "all-reduce", "all-gather",
"reduce-scatter"; "collective-broadcast" and "reduce" for the layer
prefetch's owner exchanges) and runs uncounted; on
the meta device it only reports, and returns an output of the right
shape without calling the backend.

The one-hop shift of ring attention (``ops.ring_attention``):
``ring_shift`` rotates a tensor, or a tuple of tensors sent as one
buffer, one rank forward around a group (rank i sends to i+1 and
receives from i-1, over ``batch_isend_irecv``; ``neighbor_perm`` and
``shifted_perm`` are the reference's permutation tables); it is
differentiable, its backward the reverse shift. ``shift_async`` issues
the same exchange and returns a ``Pending``, so the next shard's
exchange is in flight while the current one is attended. Both count
under "ring_shift" in ``STATS`` and report "collective-permute" bytes.

Asynchronous forms (the FSDP layer prefetch, ``parallel.layer_prefetch``):
``broadcast_async``, ``reduce_async``, ``gather_shard_async`` and
``scatter_sum_async`` issue their exchange and return a ``Pending``
whose ``wait()`` gives the result on the caller's stream. Every rank
issues them in the same order (the collectives pair by that order), and
a failed exchange raises in ``wait()``; nothing retries it on a
synchronous path. On NCCL the exchange runs on the process group's
stream, after the work the caller's stream had queued, and ``wait()``
makes the caller's stream wait for it, with no host block. On gloo a
CUDA tensor is staged through pinned host memory on a copy stream of
its own (``copy_stream``): the host waits for the copy out (after the
caller's stream's work so far; a caller that makes the tensor on the
copy stream runs the call there), then issues the exchange;
``wait()`` waits for the exchange on the host and copies the result in
on the copy stream, which the caller's stream then waits for. So the
caller's stream never waits on the host, and an exchange's
``wait_seconds`` in ``STATS`` are the host seconds ``wait()`` blocked:
its exposed wait (the seconds of its copy out are its issue's).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def through_host(t: torch.Tensor, group) -> bool:
    """A CUDA tensor on a gloo group goes through host memory."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _host_buffer(shape, dtype: torch.dtype) -> torch.Tensor:
    """A staging buffer, pinned where a card is present (PyTorch's
    caching host allocator reuses freed pinned blocks once the copies
    recorded on them have ended)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.cuda.is_available())


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = _host_buffer(t.shape, t.dtype)
    host.copy_(t)
    return host


_COPY_STREAMS: Dict[torch.device, object] = {}


def copy_stream(device: torch.device):
    """The stream the staged exchanges copy on, one a device."""
    if device not in _COPY_STREAMS:
        _COPY_STREAMS[device] = torch.cuda.Stream(device)
    return _COPY_STREAMS[device]


def _stage_out(t: torch.Tensor) -> torch.Tensor:
    """``t`` into a staging buffer, copied on the copy stream once the
    current stream's work so far has run; the host waits for the
    copy."""
    if t.device.type != "cuda":
        return _to_host(t)
    host = _host_buffer(t.shape, t.dtype)
    stream = copy_stream(t.device)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        host.copy_(t, non_blocking=True)
        done = stream.record_event()
    done.synchronize()
    return host


def _stage_in(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A new tensor on ``device`` holding ``host`` (a staging buffer),
    copied on the copy stream, which the current stream waits for."""
    if device.type != "cuda":
        return host.clone()
    stream = copy_stream(device)
    current = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        out = torch.empty(host.shape, dtype=host.dtype, device=device)
        out.copy_(host, non_blocking=True)
        done = stream.record_event()
    current.wait_event(done)
    out.record_stream(current)
    return out


def _global_rank(group, group_rank: int) -> int:
    return (group_rank if group is None
            else dist.get_global_rank(group, group_rank))


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
    staged = through_host(flat, group)
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
        if through_host(t, group):
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
            host = _to_host(src) if through_host(src, group) else src
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
            host = (_to_host(src) if through_host(src, group)
                    else src.clone())
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


# -- asynchronous forms (the FSDP layer prefetch) ----------------------------


class Pending:
    """An exchange in flight. ``wait()`` completes it on the caller's
    stream and returns its result (then holds no reference to it); the
    host seconds it blocks are added to the exchange's ``seconds`` and
    ``wait_seconds`` in ``STATS``."""

    def __init__(self, name: str, finish: Optional[Callable] = None,
                 result=None):
        self._name, self._finish, self._result = name, finish, result

    def wait(self):
        if self._finish is None:
            out, self._result = self._result, None
            return out
        t0 = time.perf_counter()
        finish, self._finish = self._finish, None
        with prof.uncounted():
            out = finish()
        waited = time.perf_counter() - t0
        entry = STATS.setdefault(self._name, {"calls": 0, "seconds": 0.0,
                                             "bytes": 0})
        entry["seconds"] += waited
        entry["wait_seconds"] = entry.get("wait_seconds", 0.0) + waited
        return out


def _done(name: str, nbytes: int, result) -> Pending:
    """The meta device's exchange: counted, no backend call."""
    _count(name, time.perf_counter(), nbytes)
    STATS[name].setdefault("wait_seconds", 0.0)
    return Pending(name, result=result)


def broadcast_async(x: torch.Tensor, src: int, group=None) -> Pending:
    """Group rank ``src``'s ``x`` on every rank of ``group``: on ``src``
    ``x`` is sent (and ``wait()`` returns it), elsewhere only its shape
    and dtype are read and ``wait()`` returns a new tensor. Counts
    ``x``'s bytes."""
    nbytes = x.numel() * x.element_size()
    prof.report_exchange("collective-broadcast", nbytes)
    me = dist.get_rank(group)
    if x.device.type == "meta":
        return _done("broadcast", nbytes,
                     x if me == src else torch.empty_like(x))
    t0 = time.perf_counter()
    with prof.uncounted():
        staged = through_host(x, group)
        if me == src:
            flat = _as_bytes(x).reshape(-1)
            buf = _stage_out(flat) if staged else flat
        else:
            buf = (_host_buffer((nbytes,), torch.uint8) if staged else
                   torch.empty(nbytes, dtype=torch.uint8, device=x.device))
        work = dist.broadcast(buf, _global_rank(group, src), group=group,
                              async_op=True)

    def finish():
        work.wait()
        if me == src:
            return x
        out = _stage_in(buf, x.device) if staged else buf
        return out.view(x.dtype).view(x.shape)

    _count("broadcast", t0, nbytes)
    return Pending("broadcast", finish)


def reduce_async(x: torch.Tensor, dst: int, group=None) -> Pending:
    """The sum of ``x`` over ``group`` on group rank ``dst``: ``wait()``
    returns it there (a new tensor) and None elsewhere; ``x`` is not
    changed. Counts ``x``'s bytes."""
    nbytes = x.numel() * x.element_size()
    prof.report_exchange("reduce", nbytes)
    me = dist.get_rank(group)
    if x.device.type == "meta":
        return _done("reduce", nbytes, x.clone() if me == dst else None)
    t0 = time.perf_counter()
    with prof.uncounted():
        src = x.detach().contiguous()
        staged = through_host(src, group)
        buf = _stage_out(src) if staged else src.clone()
        work = dist.reduce(buf, _global_rank(group, dst), group=group,
                           async_op=True)

    def finish():
        work.wait()
        if me != dst:
            return None
        return _stage_in(buf, x.device) if staged else buf

    _count("reduce", t0, nbytes)
    return Pending("reduce", finish)


def gather_shard_async(x: torch.Tensor, dim: int, group=None) -> Pending:
    """``gather_shard``'s result, issued now: ``wait()`` returns the
    group's blocks concatenated along ``dim``. Counts the gathered
    tensor's bytes under "all_gather"."""
    size = dist.get_world_size(group)
    shape = list(x.shape)
    shape[dim] *= size
    nbytes = math.prod(shape) * x.element_size()
    prof.report_exchange("all-gather", nbytes)
    if x.device.type == "meta":
        return _done("all_gather", nbytes, x.new_empty(shape))
    t0 = time.perf_counter()
    with prof.uncounted():
        src = x.detach().movedim(dim, 0).contiguous()
        whole = (size,) + tuple(src.shape)
        staged = False
        if dist.get_backend(group) == "nccl":
            out = torch.empty(whole, dtype=x.dtype, device=x.device)
            work = dist.all_gather_into_tensor(out, src, group=group,
                                               async_op=True)
        else:
            staged = through_host(src, group)
            host = _stage_out(src) if staged else src
            out = (_host_buffer(whole, x.dtype) if staged
                   else torch.empty(whole, dtype=x.dtype))
            work = dist.all_gather(list(out.unbind(0)), host, group=group,
                                   async_op=True)

    def finish():
        work.wait()
        full = out
        if staged:
            full = _stage_in(out, x.device)
        full = full.reshape((size * src.shape[0],) + tuple(src.shape[1:]))
        return full.movedim(0, dim).contiguous()

    _count("all_gather", t0, nbytes)
    return Pending("all_gather", finish)


def scatter_sum_async(x: torch.Tensor, dim: int, group=None) -> Pending:
    """``scatter_sum``'s result, issued now: ``wait()`` returns this
    rank's block along ``dim`` of the sum of ``x`` over the group; ``x``
    is not changed. Counts ``x``'s bytes under "reduce_scatter"."""
    size = dist.get_world_size(group)
    if x.shape[dim] % size:
        raise ValueError(f"reduce-scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {size} ranks")
    nbytes = x.numel() * x.element_size()
    prof.report_exchange("reduce-scatter", nbytes)
    n = x.shape[dim] // size
    if x.device.type == "meta":
        return _done("reduce_scatter", nbytes, x.narrow(dim, 0, n).clone())
    t0 = time.perf_counter()
    me = dist.get_rank(group)
    with prof.uncounted():
        src = x.detach().movedim(dim, 0).contiguous()
        staged = False
        if dist.get_backend(group) == "nccl":
            buf = torch.empty((n,) + tuple(src.shape[1:]), dtype=x.dtype,
                              device=x.device)
            work = dist.reduce_scatter_tensor(buf, src, group=group,
                                              async_op=True)
        else:
            staged = through_host(src, group)
            buf = _stage_out(src) if staged else src.clone()
            work = dist.all_reduce(buf, group=group, async_op=True)

    def finish():
        work.wait()
        out = buf
        if dist.get_backend(group) != "nccl":
            part = buf.narrow(0, me * n, n)
            out = _stage_in(part, x.device) if staged else part.clone()
        return out.movedim(0, dim).contiguous()

    _count("reduce_scatter", t0, nbytes)
    return Pending("reduce_scatter", finish)


# -- the one-hop shift (ring attention) ----------------------------------------


def neighbor_perm(n: int) -> List[Tuple[int, int]]:
    """The single-hop ring permutation (rank i -> i+1): what the K/V
    rotation uses every step."""
    return [(i, (i + 1) % n) for i in range(n)]


def shifted_perm(n: int, shift: int) -> List[Tuple[int, int]]:
    """The distance-``shift`` permutation (rank i -> i+shift)."""
    return [(i, (i + shift) % n) for i in range(n)]


def _pack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes in one flat buffer, made on the current
    stream."""
    flat = [_as_bytes(x).reshape(-1) for x in xs]
    return flat[0] if len(flat) == 1 else torch.cat(flat)


def _unpack(buf: torch.Tensor, like: Sequence[torch.Tensor]):
    out, at = [], 0
    for x in like:
        n = x.numel() * x.element_size()
        out.append(buf[at:at + n].view(x.dtype).view(x.shape))
        at += n
    return out


def shift_async(xs, group=None, step: int = 1) -> Pending:
    """Issue the rotation of ``xs`` (a tensor or a tuple of tensors,
    sent as one buffer) ``step`` ranks forward around ``group``: rank i
    sends to i+step and receives from i-step. ``wait()`` returns what
    rank i-step sent, in ``xs``'s structure, on the caller's stream.
    Every rank of the group issues its shifts in the same order. Counts
    the bytes sent under "ring_shift"."""
    single = isinstance(xs, torch.Tensor)
    xs = (xs,) if single else tuple(xs)
    nbytes = sum(x.numel() * x.element_size() for x in xs)
    prof.report_exchange("collective-permute", nbytes)

    def result(parts):
        return parts[0] if single else tuple(parts)

    if any(x.device.type == "meta" for x in xs):
        return _done("ring_shift", nbytes,
                     result([torch.empty_like(x) for x in xs]))
    t0 = time.perf_counter()
    size = dist.get_world_size(group)
    me = dist.get_rank(group)
    with prof.uncounted():
        flat = _pack(xs)
        staged = through_host(flat, group)
        # on gloo the copy out waits for the current stream's work, so
        # the packed buffer (made there) is whole when it leaves
        src = _stage_out(flat) if staged else flat
        out = (_host_buffer(src.shape, torch.uint8) if staged
               else torch.empty_like(src))
        perm = shifted_perm(size, step)
        to = perm[me][1]
        frm = next(src for src, dst in perm if dst == me)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, _global_rank(group, to), group),
            dist.P2POp(dist.irecv, out, _global_rank(group, frm), group)])

    def finish(sent=src):
        # ``sent``: the send buffer lives until its exchange is done
        for work in works:
            work.wait()
        buf = _stage_in(out, xs[0].device) if staged else out
        return result(_unpack(buf, xs))

    _count("ring_shift", t0, nbytes)
    STATS["ring_shift"].setdefault("wait_seconds", 0.0)
    return Pending("ring_shift", finish)


def shift(xs, group=None, step: int = 1):
    """``shift_async(xs, group, step).wait()``, outside autograd."""
    return shift_async(xs, group, step).wait()


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, step: int):
        ctx.group, ctx.step = group, step
        return shift(x, group, step)

    @staticmethod
    def backward(ctx, g):
        # the cotangent goes back where the value came from
        return shift(g.contiguous(), ctx.group, -ctx.step), None, None


def ring_shift(x: torch.Tensor, group=None, step: int = 1) -> torch.Tensor:
    """Differentiable rotation of ``x`` one rank forward (``step``
    ranks) around ``group``; the backward is the reverse shift."""
    return _Shift.apply(x, group, step)
