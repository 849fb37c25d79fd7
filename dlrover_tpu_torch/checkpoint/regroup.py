"""A host snapshot laid out for the next world: the sharded leaves (the
experts under ``moe_ep``) regrouped over the ranks that stay, exchanged
over the old process group before it is torn down.

Rank ``s`` of the old world (``W`` ranks) holds rows ``[s L, (s+1) L)``
of a sharded leaf's split dim, ``L`` = its local rows. The survivors
``S`` (old rank numbers, in their new-rank order) split the same global
rows evenly: new rank ``t`` gets ``[t L W/|S|, (t+1) L W/|S|)``. Each old
rank sends every survivor the rows it holds of that survivor's new
slice (point-to-point over the old group; its own rows it copies), so
no rank ever holds the global leaf, and a leaving rank's snapshot holds
nothing. Replicated leaves are copied as ``HostSnapshot.take`` copies
them. The reference's GSPMD reshards a global array in ``device_put``;
a rank here holds only its part, so the parts move before the group
that can move them goes away.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.checkpoint.manager import _copy_to_host, _HostArena


@dataclass
class Regroup:
    """A planned change of world: the old ``group`` (``world`` ranks,
    this one ``rank``), the ``survivors`` and, by tensor name, the dim
    each sharded tensor is split on (``state_tensors``' names)."""

    group: Any
    rank: int
    world: int
    survivors: List[int]
    dims: Dict[str, int]

    @property
    def new_rank(self) -> Optional[int]:
        return (self.survivors.index(self.rank)
                if self.rank in self.survivors else None)

    def specs(self, tensors: Mapping[str, torch.Tensor]):
        """The snapshot's host shapes: a survivor's new slices and its
        replicated leaves; nothing for a rank that leaves."""
        if self.new_rank is None:
            return {}
        out = {}
        for name, t in tensors.items():
            shape = list(t.shape)
            d = self.dims.get(name)
            if d is not None:
                total = shape[d] * self.world
                if total % len(self.survivors):
                    raise ValueError(
                        f"{name}: {total} rows on dim {d} do not split "
                        f"over {len(self.survivors)} ranks")
                shape[d] = total // len(self.survivors)
            out[name] = (tuple(shape), t.dtype)
        return out

    def copy(self, tensors: Mapping[str, torch.Tensor],
             arena: _HostArena) -> Dict[str, torch.Tensor]:
        """The replicated leaves copied into ``arena``, then each sharded
        one exchanged into its new slice there."""
        _copy_to_host({n: t for n, t in tensors.items()
                       if n not in self.dims and n in arena.tensors}, arena)
        staged = dist.get_backend(self.group) == "gloo"
        for name in sorted(self.dims):
            self._exchange(tensors[name], self.dims[name],
                           arena.tensors.get(name), staged)
        return dict(arena.tensors)

    def _exchange(self, t: torch.Tensor, d: int,
                  out: Optional[torch.Tensor], staged: bool) -> None:
        lo = t.shape[d]
        ln = lo * self.world // len(self.survivors)
        me, new = self.rank, self.new_rank
        wire = torch.device("cpu") if staged else t.device
        ops, recvs = [], []
        with torch.no_grad():
            for dst_new, peer in enumerate(self.survivors):
                a = max(me * lo, dst_new * ln)
                b = min((me + 1) * lo, (dst_new + 1) * ln)
                if a >= b:
                    continue
                rows = t.detach().narrow(d, a - me * lo, b - a)
                if peer == me:
                    out.narrow(d, a - new * ln, b - a).copy_(rows)
                    continue
                send = rows.contiguous().to(wire).view(torch.uint8)
                ops.append(dist.P2POp(dist.isend, send,
                                      dist.get_global_rank(self.group, peer),
                                      self.group))
            if new is not None:
                for src in range(self.world):
                    a = max(src * lo, new * ln)
                    b = min((src + 1) * lo, (new + 1) * ln)
                    if src == me or a >= b:
                        continue
                    shape = list(t.shape)
                    shape[d] = b - a
                    buf = torch.empty(shape, dtype=t.dtype, device=wire)
                    ops.append(dist.P2POp(
                        dist.irecv, buf.view(torch.uint8),
                        dist.get_global_rank(self.group, src), self.group))
                    recvs.append((buf, a - new * ln))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
            for buf, off in recvs:
                out.narrow(d, off, buf.shape[d]).copy_(buf)
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
