#!/usr/bin/env python3
"""Time ``ops.ring``'s staged exchanges (gloo with a card: each tensor
copied through pinned host memory) with a fresh pinned buffer each call,
as ``ring`` stages (PyTorch's caching host allocator beneath), and with
a pinned staging arena that hands the same buffers out round after
round, on one NVIDIA GPU shared by two ranks as phase 18 of
``chip_smoke.py`` runs them.

    python3 chip_staging.py [ROUNDS [OUT.json]]

A round is one llama3_8b layer's exchanges under the FSDP layer prefetch
at (data, fsdp) = (1, 2) (the f32 leaves q, k, v, o, gate, up, down and
the two norm scales, each broadcast from rank 0 and its gradient reduced
to it through the asynchronous forms), then the whole-tree step's
all-gather and reduce-scatter of the same leaves cut in two (the
synchronous forms). The arena (``_Pool``, installed in place of
``ring._host_buffer``) keeps the buffers a round took, by shape and
dtype, and hands them out again in the next round, which starts with
the card synchronized. The two ways take turns, arena, fresh, fresh, arena,
ROUNDS rounds a turn (default 4, the first of each turn not counted),
and each exchange kind's host seconds a round (``ring.STATS``, the
copies through the host and gloo's own time together) are printed, the
medians over the counted rounds, beside the card's name and power limit.
With OUT.json the rounds' figures are also written there.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HIDDEN, KV, FFN = 4096, 1024, 14336
LEAVES = {"q": (HIDDEN, HIDDEN), "k": (HIDDEN, KV), "v": (HIDDEN, KV),
          "o": (HIDDEN, HIDDEN), "gate": (HIDDEN, FFN),
          "up": (HIDDEN, FFN), "down": (FFN, HIDDEN),
          "attn_norm": (HIDDEN,), "ffn_norm": (HIDDEN,)}
TURNS = ("arena", "fresh", "fresh", "arena")


class _Pool:
    """Pinned staging buffers by (shape, dtype): those a round took are
    handed out again once ``round_end`` has been called."""

    def __init__(self):
        self.free, self.used = {}, []

    def take(self, shape, dtype):
        import torch

        key = (tuple(shape), dtype)
        bufs = self.free.get(key)
        buf = (bufs.pop() if bufs else
               torch.empty(shape, dtype=dtype, pin_memory=True))
        self.used.append((key, buf))
        return buf

    def round_end(self):
        for key, buf in self.used:
            self.free.setdefault(key, []).append(buf)
        self.used = []


def rank_main(rounds):
    import torch

    from dlrover_tpu_torch.ops import ring
    from dlrover_tpu_torch.trainer import bootstrap

    bootstrap.init_worker("gloo", "cuda:0")
    import torch.distributed as dist

    rank = dist.get_rank()
    gen = torch.Generator(device="cuda:0").manual_seed(rank)
    leaves = {k: torch.randn(s, generator=gen, device="cuda:0")
              for k, s in LEAVES.items()}
    fresh = ring._host_buffer
    out = {way: [] for way in TURNS}
    for way in TURNS:
        pool = _Pool()
        ring._host_buffer = pool.take if way == "arena" else fresh
        for i in range(rounds):
            torch.cuda.synchronize()
            dist.barrier()
            ring.reset_stats()
            t0 = time.perf_counter()
            pending = [ring.broadcast_async(t, 0) for t in leaves.values()]
            full = [p.wait() for p in pending]
            pending = [ring.reduce_async(t, 0) for t in full]
            for p in pending:
                p.wait()
            for t in leaves.values():
                ring.scatter_sum(ring.gather_shard(
                    t.narrow(0, rank * (t.shape[0] // 2), t.shape[0] // 2),
                    0), 0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            pool.round_end()
            if i:
                stats = ring.stats()
                out[way].append(
                    {"wall": wall,
                     **{k: v["seconds"] for k, v in stats.items()}})
    ring._host_buffer = fresh
    dist.destroy_process_group()
    return out


def main():
    import subprocess

    import torch

    from dlrover_tpu_torch.trainer.run import run_local

    if not torch.cuda.is_available():
        print("chip_staging.py: no CUDA device", file=sys.stderr)
        sys.exit(1)
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ranks = run_local(rank_main, 2, (rounds,), timeout=900)
    report = {"card": card, "rounds": rounds, "ranks": ranks,
              "bytes_a_round": 4 * sum(
                  HIDDEN if len(s) == 1 else s[0] * s[1]
                  for s in LEAVES.values())}
    for r, got in enumerate(ranks):
        for way in ("arena", "fresh"):
            rows = got[way]
            med = {k: statistics.median(row[k] for row in rows)
                   for k in sorted(rows[0])}
            print(f"rank {r} {way}: host s a round, medians of "
                  f"{len(rows)}: " + ", ".join(
                      f"{k} {v:.4f}" for k, v in med.items())
                  + f"; {card}", flush=True)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
