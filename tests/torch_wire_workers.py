"""Rank functions of ``tests/test_torch_fsdp_wire.py``.

Each runs in a process that ``dlrover_tpu_torch.trainer.run.run_local``
spawns, imports torch and the port only, joins the gloo process group on
the CPU and returns numpy arrays: global leaves gathered from the
rank's blocks, exchange statistics, losses.
"""

import functools

import torch
import torch.distributed as dist

from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.optimizers import global_norm, wsam
from dlrover_tpu_torch.parallel.accelerate import _named_leaves, accelerate
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from torch_fsdp_workers import gathered
from torch_recovery_workers import SURVIVORS, _join


def _np(t):
    return t.detach().cpu().numpy().copy()


def global_grads(result, state):
    """Each parameter's gradient as its global leaf (a block gathered
    over the group of its axes), by path."""
    layout, mesh = result.layout, result.mesh
    out = {}
    for path, p in _named_leaves(state.params):
        g = p.grad
        shard = layout.leaves.get(path)
        if shard is not None:
            g = ring.gather_shard(g, shard.dim, mesh.group(shard.axes))
        out[path] = _np(g)
    return out


def _build(tree, config, mesh, batch, optimizer, **kw):
    return accelerate(lambda gen: interop.params_from_numpy(tree, "cpu"),
                      llama.make_loss_fn(config), optimizer, batch,
                      strategy=Strategy(mesh=mesh, rule_set="llama"),
                      device="cpu", **kw)


def fp8_wire_ranks(tree, config_kw, batch, batches, lr):
    """fsdp = 2 over the two ranks. (a) one step of the fp8 FSDP wire
    with SGD at lr 0 (the parameters stay, the gradients stay in
    ``grad``): the loss, the global gradients, the exchange statistics
    of that step, which leaves were gathered and wired, and
    ``optimizers.global_norm`` over the blocks with the norm groups
    ``accelerate`` hands the factory; (b) WSAM steps over ``batches``;
    (c) gradient-wire fp8 steps over ``batches`` and the global
    residual."""
    rank, ranks, _ = _join()
    config = llama.llama_tiny(**config_kw)
    mesh = MeshPlan(data=1, fsdp=ranks)
    out = {"rank": rank}
    groups = []

    def sgd0(params, norm_groups=None):
        groups.append(norm_groups)
        return torch.optim.SGD(params, lr=0.0)

    result = _build(tree, config, mesh, batch, sgd0)
    state = result.init_fn(0)
    placed = result.shard_batch(batch)
    ring.reset_stats()
    state, metrics = result.train_step(state, placed)
    out["stats"] = ring.stats()
    out["loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    out["grads"] = global_grads(result, state)
    blocks = [p.grad for _, p in _named_leaves(state.params)]
    out["block_norm"] = float(global_norm(blocks, groups[0]))
    layout = result.layout
    out["sharded"] = sorted(layout.leaves)
    out["shapes"] = {p: tuple(s) for p, s in layout.shapes.items()}
    out["split_dims"] = {p: s.dim for p, s in layout.leaves.items()}

    result = _build(tree, llama.llama_tiny(**{**config_kw,
                                              "fsdp_precision": ""}),
                    mesh, batch,
                    wsam(functools.partial(torch.optim.SGD, lr=lr),
                         learning_rate=lr, max_norm=1.0))
    state = result.init_fn(0)
    out["wsam"] = []
    for b in batches:
        state, metrics = result.train_step(state, result.shard_batch(b))
        out["wsam"].append(float(metrics["loss"]))

    result = _build(tree, llama.llama_tiny(**{**config_kw,
                                              "fsdp_precision": ""}),
                    mesh, batch, functools.partial(torch.optim.SGD, lr=lr),
                    grad_precision="fp8")
    state = result.init_fn(0)
    out["grad_wire"] = []
    for b in batches:
        state, metrics = result.train_step(state, result.shard_batch(b))
        out["grad_wire"].append(float(metrics["loss"]))
    out["residual"] = {k: v for k, v in gathered(result, state).items()
                       if k.startswith("wire_residual/")}
    dist.destroy_process_group()
    return out


def residual_reshard_ranks(tree, config_kw, batches, lr):
    """(data, fsdp) = (2, 2) over four ranks under the fp8 gradient
    wire: two steps, ``live_reshard`` onto ranks 0 and 1 (2 and 3
    leave), one more step. Returns every global tensor before the change
    and right after it, and the residual after the last step."""
    rank, ranks, _ = _join()
    config = llama.llama_tiny(**config_kw)
    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config),
        functools.partial(torch.optim.AdamW, lr=lr), batches[0],
        strategy=Strategy(mesh=MeshPlan(data=2, fsdp=2), rule_set="llama"),
        device="cpu", grad_precision="fp8")
    state = trainer.prepare()
    for b in batches[:2]:
        state, _ = trainer.step(state, b)
    out = {"rank": rank, "before": gathered(trainer.accelerated, state),
           "mesh_before": dict(trainer.accelerated.layout.sizes)}
    state = trainer.live_reshard(state, devices=SURVIVORS, reason="test")
    if state is None:
        out["left"] = True
        return out
    out["mesh_after"] = dict(trainer.accelerated.layout.sizes)
    out["after"] = gathered(trainer.accelerated, state)
    state, metrics = trainer.step(state, batches[2])
    out["finite"] = bool(metrics["finite"])
    out["residual_after_step"] = {
        k: v for k, v in gathered(trainer.accelerated, state).items()
        if k.startswith("wire_residual/")}
    dist.destroy_process_group()
    return out
