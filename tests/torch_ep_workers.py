"""Rank functions of ``tests/test_torch_ep.py``.

Each runs in a process that ``dlrover_tpu_torch.trainer.run.run_local``
spawns, so it lives at a module's top level, and it imports torch and
the port only. Each joins the gloo process group on the CPU, does its
rank's share and returns numpy arrays for the test to hold against the
JAX package.
"""

import functools

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch import interop
from dlrover_tpu_torch.examples import train_llama as example
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import grouped_matmul as gm
from dlrover_tpu_torch.ops import moe, ring
from dlrover_tpu_torch.ops.shard_compat import ambient_mesh
from dlrover_tpu_torch.parallel.accelerate import accelerate
from dlrover_tpu_torch.parallel.mesh import MeshPlan, ProcessMesh
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer import bootstrap
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer


def _join():
    torch.set_num_threads(1)
    worker = bootstrap.init_worker("gloo", "cpu")
    return worker.process_id, worker.num_processes


def moe_ranks(tree, x, num_experts, top_k, cases):
    """``moe_ffn(dispatch="grouped_ep")`` over the "expert" axis of all
    ranks, for each (precision, chunks) of ``cases``: this rank's
    output rows, x gradient rows and expert-gradient blocks, the summed
    router gradient, the aux loss and dropped_frac, of the loss
    sum(out^2) + aux, taken as the sum of the ranks' sum(out_r^2) +
    aux / P."""
    rank, ranks = _join()
    rows = x.shape[0] // ranks
    mesh = ProcessMesh.over("expert")
    results = {}
    for precision, chunks in cases:
        params = interop.params_from_numpy(tree, "cpu", (rank, ranks))
        leaves = [params["router"]["kernel"],
                  params["experts"]["up"]["kernel"],
                  params["experts"]["down"]["kernel"]]
        for t in leaves:
            t.requires_grad_()
        xr = torch.from_numpy(x[rank * rows:(rank + 1) * rows]
                              ).requires_grad_()
        cfg = moe.MoEConfig(num_experts=num_experts, top_k=top_k,
                            dispatch="grouped_ep", ep_axes=("expert",),
                            mesh=mesh, dispatch_chunks=chunks,
                            precision=precision)
        out, aux, metrics = moe.moe_ffn(params, xr[None], cfg, train=False)
        ((out.float() ** 2).sum() + aux / ranks).backward()
        router = ring.all_reduce_(leaves[0].grad.clone())
        results[(precision, chunks)] = {
            "out": out[0].detach().numpy(), "aux": aux.item(),
            "x": xr.grad.numpy(), "router": router.numpy(),
            "up": leaves[1].grad.numpy(), "down": leaves[2].grad.numpy(),
            "dropped_frac": metrics["dropped_frac"].item(),
            "expert_load": metrics["expert_load"].numpy(),
        }
    dist.destroy_process_group()
    return results


def train_ranks(tree, batches, config_kw, lr):
    """``accelerate`` with ``rule_set="moe_ep"`` on ``MeshPlan(data=P)``
    from the reference's parameters (each rank's experts sliced by
    ``interop``), one Adam step per batch: the global losses and
    metrics of each step, and the shapes this rank's tree holds."""
    rank, ranks = _join()
    config = llama.llama_tiny(**config_kw)
    result = accelerate(
        lambda gen: interop.params_from_numpy(tree, "cpu", (rank, ranks)),
        llama.make_loss_fn(config),
        functools.partial(torch.optim.Adam, lr=lr),
        batches[0],
        strategy=Strategy(mesh=MeshPlan(data=ranks, fsdp=1),
                          rule_set="moe_ep"),
        device="cpu",
    )
    state = result.init_fn(0)
    steps = []
    for batch in batches:
        state, metrics = result.train_step(state, result.shard_batch(batch))
        steps.append({k: np.asarray(torch.as_tensor(v).detach())
                      for k, v in metrics.items()})
    up = state.params["layers"]["experts"]["up"]["kernel"]
    dist.destroy_process_group()
    return {"steps": steps, "up_shape": tuple(up.shape)}


def example_ranks(argv):
    """The example's entry point as one rank of a launched job."""
    torch.set_num_threads(1)
    ring.reset_stats()
    out = example.main(argv)
    return {"out": out, "stats": ring.stats()}


def init_ranks(config_kw):
    """Each rank's experts from ``llama.init`` with ``expert_shard``."""
    rank, ranks = _join()
    config = llama.llama_tiny(**config_kw)
    tree = llama.init(torch.Generator().manual_seed(5), config,
                      expert_shard=(rank, ranks))
    dist.destroy_process_group()
    return {k: tree["layers"]["experts"][k]["kernel"].numpy()
            for k in ("up", "down")}


def checkpoint_ranks(ckpt_dir, config_kw, batch, save):
    """An ``ElasticTrainer`` with ``rule_set="moe_ep"`` over the ranks
    on ``ckpt_dir``: ``prepare`` (a restore when the directory holds a
    checkpoint), this rank's experts and their Adam moments as
    prepared, then one step, and with ``save`` a checkpoint of it: the
    step prepared at, the experts (and moments) and the replicated
    embedding before and after the step, and the step's loss."""
    rank, ranks = _join()
    config = llama.llama_tiny(**config_kw)
    trainer = ElasticTrainer(
        llama.make_init_fn(config, (rank, ranks)),
        llama.make_loss_fn(config),
        functools.partial(torch.optim.Adam, lr=1e-2), batch,
        strategy=Strategy(mesh=MeshPlan(data=ranks, fsdp=1),
                          rule_set="moe_ep"),
        ckpt_dir=ckpt_dir, device="cpu")
    state = trainer.prepare()

    def experts():
        out = {"embed": state.params["embed_tokens"]["embedding"]
               .detach().numpy().copy()}
        for key in ("up", "down"):
            p = state.params["layers"]["experts"][key]["kernel"]
            out[key] = p.detach().numpy().copy()
            slots = state.opt_state.state.get(p, {})
            if "exp_avg" in slots:
                out[f"{key}_exp_avg"] = slots["exp_avg"].numpy().copy()
        return out

    prepared = {"step": state.step, **experts()}
    state, metrics = trainer.step(state, batch)
    if save:
        trainer.save(state)
    trainer.finalize()
    if dist.is_initialized():  # one rank joins no group
        dist.destroy_process_group()
    return {"prepared": prepared, "stepped": experts(),
            "loss": float(metrics["loss"]),
            "finite": bool(metrics["finite"])}


def failing_rank():
    """Rank 1 raises; the launcher must report it."""
    rank, _ = _join()
    if rank == 1:
        raise ValueError("planted failure on rank 1")
    dist.destroy_process_group()
    return rank


def count_ranks(config_kw, chunk_counts, ids):
    """Calls of each grouped-matmul wrapper in one forward and backward
    of the MoE llama on the fp8 wire, per ``moe_dispatch_chunks``: what
    the launch counters count on the card."""
    rank, ranks = _join()
    calls = {}

    def counting(name):
        real = getattr(gm, name)

        def fn(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real(*args, **kwargs)

        return fn

    for name in gm.WRAPPERS:
        setattr(gm, name, counting(name))
    rows = ids.shape[0] // ranks
    batch = {"input_ids": torch.from_numpy(ids[rank * rows:(rank + 1) * rows,
                                               :-1]),
             "labels": torch.from_numpy(ids[rank * rows:(rank + 1) * rows,
                                            1:])}
    mesh = MeshPlan(data=ranks, fsdp=1).build()
    out = {}
    for chunks in chunk_counts:
        config = llama.llama_tiny(moe_dispatch_chunks=chunks, **config_kw)
        params = llama.init(torch.Generator().manual_seed(0), config,
                            expert_shard=(rank, ranks))
        for t in [t for layer in params.values() for t in _leaves(layer)]:
            t.requires_grad_()
        calls.clear()
        with ambient_mesh(mesh):
            loss, _ = llama.make_loss_fn(config)(params, batch, None)
            loss.backward()
        out[chunks] = dict(calls)
    dist.destroy_process_group()
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]
