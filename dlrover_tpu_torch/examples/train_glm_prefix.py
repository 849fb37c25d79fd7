"""GLM prefix-LM fine-tuning with the PyTorch port (counterpart of
``examples/train_glm_prefix.py``, same flags and batch).

Each row is a prompt and a response: the prompt is visible in both
directions (GLM's prefix mask, inside the flash kernels' tiles on the
GPU), the response is generated causally with 2D block positions, and
the loss covers the response tokens only. One fixed synthetic batch,
trained on until the loss falls, as a demo.

    # on the GPU (the default device)
    python -m dlrover_tpu_torch.examples.train_glm_prefix --steps 25

    # on the CPU (the kernels' plain versions)
    python -m dlrover_tpu_torch.examples.train_glm_prefix --steps 25 \\
        --device cpu

The reference example reports each step to a master client when one is
set in the environment; that report waits for the master client's port
(ROADMAP A12), so this example runs on its own.
"""

from __future__ import annotations

import argparse
import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.models import glm
from dlrover_tpu_torch.parallel.accelerate import accelerate
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.strategy import Strategy


def synth_instruction_batch(vocab, batch, seq, seed) -> Dict[str, np.ndarray]:
    """The reference example's rows, the same RandomState draws: a prompt
    of random length, a response echoing the prompt shifted by one token
    id (learnable, so the loss visibly falls), labels on the response
    only. Numpy arrays: the trainer moves them to the device."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((batch, seq), np.int64)
    prefix = rng.randint(4, seq // 2, size=(batch,))
    labels = np.full((batch, seq), -100, np.int64)
    for b in range(batch):
        p = prefix[b]
        prompt = rng.randint(2, vocab, size=(p,))
        ids[b, :p] = prompt
        n = min(seq - p, p)
        ids[b, p:p + n] = (prompt[:n] + 1) % vocab
        # loss on response tokens only (predict token t at t - 1)
        labels[b, p - 1:p + n - 1] = ids[b, p:p + n]
    return {"input_ids": ids, "labels": labels,
            "prefix_len": prefix.astype(np.int32)}


def adam():
    """The reference example's ``optax.adam(2e-3)``."""
    return functools.partial(torch.optim.Adam, lr=2e-3, betas=(0.9, 0.999),
                             eps=1e-8)


def train(config: glm.GLMConfig, batch: Dict[str, np.ndarray], steps: int,
          device=None, init_fn: Optional[Callable] = None) -> List[float]:
    """``steps`` Adam steps on ``batch`` through ``accelerate``; the
    per-step losses. ``init_fn`` (generator -> params) defaults to
    ``glm.make_init_fn(config)``."""
    result = accelerate(
        init_fn or glm.make_init_fn(config), glm.make_loss_fn(config),
        adam(), batch,
        strategy=Strategy(mesh=MeshPlan(data=-1), rule_set="glm"),
        device=device,
    )
    state = result.init_fn(0)
    sharded = result.shard_batch(batch)
    losses = []
    for _ in range(steps):
        state, metrics = result.train_step(state, sharded)
        losses.append(float(metrics["loss"]))
    return losses


def main(argv=None) -> List[float]:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.seq < 10:
        p.error("--seq must be >= 10 (prompts span 4..seq/2 tokens)")
    # the flash path: on the GPU the kernels' prefix-LM mode, on the CPU
    # their plain versions
    config = glm.glm_tiny(max_seq_len=args.seq, use_flash=True)
    batch = synth_instruction_batch(config.vocab_size, args.batch, args.seq,
                                    seed=0)
    losses = train(config, batch, args.steps, args.device)
    print(f"glm prefix-LM: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(response-only loss, fused prefix mask)")
    return losses


if __name__ == "__main__":
    main()
