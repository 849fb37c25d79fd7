"""A host snapshot laid out for the next world or mesh: the sharded
leaves regrouped over the ranks that stay, exchanged over the old
process group before it is torn down.

Each tensor of the state has a global shape and, in the old and the new
layout (``parallel.sharding_rules.ShardLayout``: the fsdp leaves, the
experts under ``moe_ep``), the dim it is split on and into how many
blocks, or none (replicated). Old rank ``r`` holds one block of each
sharded tensor, a box of the global index space; survivor ``t`` (the
``t``-th of the old ranks that stay) needs the box of its new block.
Every piece where an old block meets a survivor's new box is moved
once: from the survivor itself when it held that block (a copy, no
wire), else from one of the block's holders (with ``data > 1`` an fsdp
block has ``data`` replicas; the survivor's index picks among them, so
the sends spread over the replicas). Each piece goes point-to-point
over the old group, so no rank ever holds a global leaf it does not
keep, a leaving rank's snapshot holds nothing, and a change that keeps
a survivor's blocks (``(2, 2) -> (1, 2)``) moves nothing. Replicated
leaves are copied as ``HostSnapshot.take`` copies them. The reference's
GSPMD reshards a global array in ``device_put``; a rank here holds only
its part, so the parts move before the group that can move them goes
away.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.checkpoint.manager import _copy_to_host, _HostArena
from dlrover_tpu_torch.parallel.sharding_rules import ShardLayout

# per tensor name: (its parameter path, its global shape)
Tensors = Dict[str, Tuple[str, Tuple[int, ...]]]


def _box(layout: ShardLayout, rank: int, path: str,
         shape: Tuple[int, ...]) -> List[Tuple[int, int]]:
    """The [lo, hi) range on each dim of ``rank``'s block."""
    box = [(0, n) for n in shape]
    shard = layout.leaves.get(path)
    if shard is not None and len(shape) == len(layout.shapes[path]):
        n = shape[shard.dim] // layout.blocks(path)
        lo = layout.block_index(rank, path) * n
        box[shard.dim] = (lo, lo + n)
    return box


def _meet(a, b) -> Optional[List[Tuple[int, int]]]:
    out = [(max(x[0], y[0]), min(x[1], y[1])) for x, y in zip(a, b)]
    return None if any(lo >= hi for lo, hi in out) else out


def _cut(t: torch.Tensor, box, origin) -> torch.Tensor:
    """The part ``box`` (global indices) of ``t``, whose own box starts
    at ``origin``."""
    for d, ((lo, hi), (o, _)) in enumerate(zip(box, origin)):
        if (lo - o, hi - lo) != (0, t.shape[d]):
            t = t.narrow(d, lo - o, hi - lo)
    return t


@dataclass
class Regroup:
    """A planned change of world or mesh: the old ``group`` (``world``
    ranks, this one ``rank``), the ``survivors`` (old rank numbers in
    their new-rank order), the ``old`` and ``new`` layouts, and by
    ``state_tensors`` name each tensor's parameter path and global
    shape."""

    group: Any
    rank: int
    world: int
    survivors: List[int]
    old: ShardLayout
    new: ShardLayout
    tensors: Tensors

    @property
    def new_rank(self) -> Optional[int]:
        return (self.survivors.index(self.rank)
                if self.rank in self.survivors else None)

    def _moves(self, name: str) -> bool:
        path, shape = self.tensors[name]
        return (self.old.local_shape(path, shape) != shape
                or self.new.local_shape(path, shape) != shape)

    def specs(self, tensors: Mapping[str, torch.Tensor]):
        """The snapshot's host shapes: a survivor's new blocks and its
        replicated leaves; nothing for a rank that leaves."""
        if self.new_rank is None:
            return {}
        out = {}
        for name, t in tensors.items():
            shape = tuple(t.shape)
            if name in self.tensors:
                path, full = self.tensors[name]
                shape = self.new.local_shape(path, full)
            out[name] = (shape, t.dtype)
        return out

    def copy(self, tensors: Mapping[str, torch.Tensor],
             arena: _HostArena) -> Dict[str, torch.Tensor]:
        """The replicated leaves copied into ``arena``, then each sharded
        one exchanged into its new block there."""
        moving = sorted(n for n in tensors if n in self.tensors
                        and self._moves(n))
        _copy_to_host({n: t for n, t in tensors.items()
                       if n not in moving and n in arena.tensors}, arena)
        staged = dist.get_backend(self.group) == "gloo"
        for name in moving:
            self._exchange(name, tensors[name], arena.tensors.get(name),
                           staged)
        return dict(arena.tensors)

    def _source(self, path: str, index: int, dest: int) -> int:
        """The old rank that sends block ``index`` to survivor ``dest``
        (new rank): the survivor itself when it holds the block, else
        one of the block's holders, picked by ``dest``."""
        holders = self.old.holders(path, index)
        if self.survivors[dest] in holders:
            return self.survivors[dest]
        return holders[dest % len(holders)]

    def _exchange(self, name: str, t: torch.Tensor,
                  out: Optional[torch.Tensor], staged: bool) -> None:
        path, shape = self.tensors[name]
        me, new = self.rank, self.new_rank
        mine = _box(self.old, me, path, shape)
        wire = torch.device("cpu") if staged else t.device
        blocks = self.old.blocks(path) if len(shape) == len(
            self.old.shapes[path]) else 1
        ops, recvs = [], []
        with torch.no_grad():
            for dest, peer in enumerate(self.survivors):
                want = _box(self.new, dest, path, shape)
                for index in range(blocks):
                    src = self._source(path, index, dest)
                    part = _meet(_box(self.old, src, path, shape), want)
                    if part is None:
                        continue
                    if src == me and peer == me:
                        _cut(out, part, want).copy_(
                            _cut(t.detach(), part, mine))
                    elif src == me:
                        send = _cut(t.detach(), part, mine).contiguous()
                        ops.append(dist.P2POp(
                            dist.isend, send.to(wire).view(torch.uint8),
                            dist.get_global_rank(self.group, peer),
                            self.group))
                    elif peer == me:
                        buf = torch.empty([hi - lo for lo, hi in part],
                                          dtype=t.dtype, device=wire)
                        ops.append(dist.P2POp(
                            dist.irecv, buf.view(torch.uint8),
                            dist.get_global_rank(self.group, src),
                            self.group))
                        recvs.append((buf, part))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            if new is not None:
                want = _box(self.new, new, path, shape)
                for buf, part in recvs:
                    _cut(out, part, want).copy_(buf)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
