"""Rank functions of ``tests/test_torch_data.py``.

Each runs in a process that ``dlrover_tpu_torch.trainer.run.run_local``
spawns, imports torch and the port only (and
``tests/torch_recovery_workers.py``'s ``_join``), joins the gloo process
group on the CPU and returns plain lists.
"""

import functools

import torch

from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.data import (
    DevicePreloader,
    ElasticDataLoader,
    ElasticDistributedSampler,
    _default_collate,
)
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook
from torch_recovery_workers import _join


class _Losses(TrainHook):
    def __init__(self):
        self.losses = []

    def after_step(self, step, metrics):
        self.losses.append(float(metrics["loss"]))


def loader_ranks(tree, samples, steps, global_batch, accum, lr, seed):
    """The tiny Llama trained for ``steps`` steps on a world of data
    parallel ranks, each fed its process-local rows by an
    ``ElasticDataLoader`` over ``samples`` whose sampler is sharded by
    rank (shuffled with ``seed``), through ``DevicePreloader`` placing
    them by the trainer's ``shard_batch``, into ``TrainExecutor``.
    Returns the losses, the ``row`` ids the loader gave this rank each
    step, and the ``row`` ids the loss saw in each microbatch."""
    rank, ranks, device = _join()
    config = llama.llama_tiny()
    sampler = ElasticDistributedSampler(
        len(samples), num_shards=ranks, shard_rank=rank, shuffle=True,
        seed=seed, drop_last=True)
    loader = ElasticDataLoader(samples, global_batch // ranks,
                               sampler=sampler)
    base = llama.make_loss_fn(config)
    seen = []

    def loss_fn(params, batch, rng):
        if batch["row"].device.type != "meta":
            seen.append(batch["row"].tolist())
        return base(params, batch, rng)

    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, device), loss_fn,
        functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=0.1),
        _default_collate(samples[:global_batch]),
        strategy=Strategy(mesh=MeshPlan(data=ranks), rule_set="llama",
                          remat_policy="", grad_accum_steps=accum),
        device=device)
    given = []

    def batches():
        for batch in loader:
            given.append(batch["row"].tolist())
            yield batch

    hook = _Losses()
    preloaders = []

    def train_iter():
        pre = DevicePreloader(batches(), sharding=trainer.accelerated,
                              global_rows=global_batch, device=device)
        preloaders.append(pre)
        return iter(pre)

    TrainExecutor(trainer, train_iter_fn=train_iter, hooks=[hook],
                  conf=Configuration({"train_steps": steps,
                                      "log_every_steps": 0,
                                      "preemption_grace": False})
                  ).train_and_evaluate()
    for pre in preloaders:
        pre.close()
    torch.distributed.destroy_process_group()
    return {"losses": hook.losses, "given": given[:steps], "seen": seen}
