"""Pretrain a Llama-family model with the PyTorch port (counterpart of
``examples/train_llama.py``, same flags and presets).

    # on the GPU (the default device)
    python -m dlrover_tpu_torch.examples.train_llama --preset tiny --steps 20

    # on the CPU (the kernels' plain versions)
    python -m dlrover_tpu_torch.examples.train_llama --preset tiny \\
        --steps 20 --device cpu

``--moe_experts N`` makes every FFN a mixture of N experts, routed by
the reference example's default ("gather", capacity-based). This slice
runs one device; ``--ckpt_dir``, ``--ring`` and ``--pipe`` belong to
later slices and are refused.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel.mesh import single_device_plan
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer.conf import build_configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor


def synthetic_batches(vocab_size, batch, seq, seed=0):
    """The reference example's token stream: the same RandomState draws,
    as numpy arrays (the trainer moves them to the device)."""
    rng = np.random.RandomState(seed)

    def gen():
        while True:
            ids = rng.randint(0, vocab_size, size=(batch, seq + 1))
            yield {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}

    return gen


def adamw():
    """The reference example's ``optax.adamw(3e-4, weight_decay=0.1)``:
    decay on every parameter, as optax applies it without a mask."""
    return functools.partial(torch.optim.AdamW, lr=3e-4, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.1)


def preset_config(preset: str, layers: int = 0, moe_experts: int = 0):
    """(config, default seq) of a preset. The tiny preset turns the
    flash path on: on the GPU it runs the kernels, on the CPU their
    plain versions."""
    kw = {"num_experts": moe_experts}
    if layers:
        kw["num_layers"] = layers
    if preset == "tiny":
        return llama.llama_tiny(use_flash=True, **kw), 128
    if preset == "1b":
        kw.setdefault("num_layers", 16)
        return llama.llama2_7b(
            hidden_size=2048, intermediate_size=5504,
            num_heads=16, num_kv_heads=16,
            param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, **kw,
        ), 2048
    return llama.llama2_7b(**kw), 4096


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="tiny", choices=["tiny", "1b", "7b"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=0, help="0 = preset default")
    p.add_argument("--layers", type=int, default=0,
                   help="override the preset's layer count")
    p.add_argument("--ckpt_dir", default="")
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--ring", type=int, default=0)
    p.add_argument("--pipe", type=int, default=0)
    p.add_argument("--pipe_virtual", type=int, default=1)
    p.add_argument("--pipe_depths", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    for flag in ("ckpt_dir", "ring", "pipe", "pipe_depths"):
        if getattr(args, flag):
            p.error(f"--{flag} is not ported yet (see ROADMAP.md)")

    config, default_seq = preset_config(args.preset, args.layers,
                                        args.moe_experts)
    seq = args.seq or default_seq
    batches = synthetic_batches(config.vocab_size, args.batch, seq)
    trainer = ElasticTrainer(
        llama.make_init_fn(config),
        llama.make_loss_fn(config),
        adamw(),
        next(batches()),
        strategy=Strategy(mesh=single_device_plan(),
                          rule_set="moe" if args.moe_experts else "llama",
                          remat_policy=""),  # the model remats per layer
        device=args.device,
    )
    executor = TrainExecutor(
        trainer,
        train_iter_fn=batches,
        conf=build_configuration({
            "train_steps": args.steps, "log_every_steps": 10,
        }),
    )
    out = executor.train_and_evaluate()
    print(f"finished at step {out['step']} "
          f"({llama.param_count(config) / 1e6:.1f}M params, "
          f"{trainer.device})")
    return out


if __name__ == "__main__":
    main()
