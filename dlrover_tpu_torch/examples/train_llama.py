"""Pretrain a Llama-family model with the PyTorch port (counterpart of
``examples/train_llama.py``, same flags and presets).

    # on the GPU (the default device)
    python -m dlrover_tpu_torch.examples.train_llama --preset tiny --steps 20

    # on the CPU (the kernels' plain versions)
    python -m dlrover_tpu_torch.examples.train_llama --preset tiny \\
        --steps 20 --device cpu

``--moe_experts N`` makes every FFN a mixture of N experts, routed by
the reference example's default ("gather", capacity-based) or by
``--moe_dispatch`` (``--moe_top_k`` choices per token).

Several ranks: under a launcher that sets the worker environment
(``DLROVER_TPU_NUM_PROCESSES`` > 1, ``DLROVER_TPU_PROCESS_ID``,
``DLROVER_TPU_COORDINATOR_ADDR``), each process joins the process group
(``trainer.bootstrap.init_worker``, ``--backend``: NCCL by default on
the GPU, one GPU per rank; gloo for ranks that share a GPU, or on the
CPU) and the job runs over a ``(data x fsdp)`` mesh of the ranks,
``--batch`` being the global batch: with four ranks or more ``fsdp = 2``
(each pair of ranks holds half of every leaf the llama rules shard, and
gathers it for the step), ``data`` the rest, as the reference's example
picks its mesh; below four, data parallel. With ``--moe_dispatch grouped_ep`` the experts are
sharded over the ranks (``rule_set="moe_ep"``); ``--moe_precision`` and
``--dispatch_chunks`` set its wire::

    # four ranks, each on its own GPU
    python -m dlrover_tpu_torch.trainer.run --nproc 4 -- \
        -m dlrover_tpu_torch.examples.train_llama --preset tiny \
        --moe_experts 8 --moe_top_k 2 --moe_dispatch grouped_ep \
        --moe_precision fp8

``--ckpt_dir DIR`` checkpoints the run there (a forced save at the end)
and resumes from the newest step DIR holds. ``--ring`` and ``--pipe``
belong to later slices and are refused.
"""

from __future__ import annotations

import argparse
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel.mesh import MeshPlan, single_device_plan
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer import bootstrap
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


def preset_config(preset: str, layers: int = 0, moe_experts: int = 0,
                  **moe):
    """(config, default seq) of a preset, ``moe`` holding LlamaConfig's
    MoE fields. The tiny preset turns the flash path on: on the GPU it
    runs the kernels, on the CPU their plain versions."""
    kw = {"num_experts": moe_experts, **moe}
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


def main(argv=None, hooks=()):
    """Train as the flags say; ``hooks`` (``TrainHook``s) ride the
    executor. Returns the executor's result."""
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="tiny", choices=["tiny", "1b", "7b"])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8,
                   help="global batch rows (split over the ranks)")
    p.add_argument("--seq", type=int, default=0, help="0 = preset default")
    p.add_argument("--layers", type=int, default=0,
                   help="override the preset's layer count")
    p.add_argument("--ckpt_dir", default="")
    p.add_argument("--moe_experts", type=int, default=0)
    p.add_argument("--moe_top_k", type=int, default=1)
    p.add_argument("--moe_dispatch", default="gather",
                   choices=["gather", "einsum", "grouped", "grouped_ep"])
    p.add_argument("--moe_precision", default=None,
                   choices=["bf16", "fp8", "fp8_qdq"],
                   help="grouped_ep wire (default: the Context's)")
    p.add_argument("--dispatch_chunks", type=int, default=None,
                   help="grouped_ep row-exchange chunks (default: the "
                        "Context's)")
    p.add_argument("--steps_per_call", type=int, default=None,
                   help="optimizer steps fused per call (default: the "
                        "Context's, DLROVER_TPU_STEPS_PER_CALL)")
    p.add_argument("--ring", type=int, default=0)
    p.add_argument("--pipe", type=int, default=0)
    p.add_argument("--pipe_virtual", type=int, default=1)
    p.add_argument("--pipe_depths", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, cuda:<LOCAL_RANK> "
                        "over several ranks)")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend over several ranks "
                        "(default: nccl on the GPU, gloo on the CPU)")
    args = p.parse_args(argv)
    for flag in ("ring", "pipe", "pipe_depths"):
        if getattr(args, flag):
            p.error(f"--{flag} is not ported yet (see ROADMAP.md)")

    world, rank, joined, device = 1, 0, False, args.device
    if int(os.environ.get(NodeEnv.NUM_PROCESSES, "1")) > 1:
        joined = not dist.is_initialized()
        worker = (bootstrap.init_worker(args.backend, device) if joined
                  else None)
        world, rank = dist.get_world_size(), dist.get_rank()
        if worker is not None:
            device = worker.device
    ep = args.moe_dispatch == "grouped_ep" and world > 1
    config, default_seq = preset_config(
        args.preset, args.layers, args.moe_experts,
        moe_top_k=args.moe_top_k, moe_dispatch=args.moe_dispatch)
    seq = args.seq or default_seq
    batches = synthetic_batches(config.vocab_size, args.batch, seq)
    if world > 1:
        # fsdp once there are at least four ranks, data the rest, as the
        # reference's example picks its mesh
        strategy = Strategy(mesh=MeshPlan(data=-1,
                                          fsdp=2 if world >= 4 else 1),
                            rule_set="moe_ep" if ep else "llama",
                            remat_policy="")
    else:
        strategy = Strategy(mesh=single_device_plan(),
                            rule_set="moe" if args.moe_experts else "llama",
                            remat_policy="")  # the model remats per layer
    trainer = ElasticTrainer(
        llama.make_init_fn(config, (rank, world) if ep else None),
        llama.make_loss_fn(config),
        adamw(),
        next(batches()),
        strategy=strategy,
        ckpt_dir=args.ckpt_dir,
        device=device,
        steps_per_call=args.steps_per_call,
        dispatch_chunks=args.dispatch_chunks,
        moe_precision=args.moe_precision,
    )
    executor = TrainExecutor(
        trainer,
        train_iter_fn=batches,
        hooks=list(hooks),
        conf=build_configuration({
            "train_steps": args.steps, "log_every_steps": 10,
        }),
    )
    try:
        out = executor.train_and_evaluate()
    finally:
        if joined:
            dist.destroy_process_group()
    if rank == 0:
        print(f"finished at step {out['step']} "
              f"({llama.param_count(config) / 1e6:.1f}M params, "
              f"{trainer.device} x {world})")
    return out


if __name__ == "__main__":
    main()
