"""Rank functions of ``tests/test_torch_fsdp.py``.

Each runs in a process that ``dlrover_tpu_torch.trainer.run.run_local``
spawns, so it lives at a module's top level, and it imports torch and
the port only (and ``tests/torch_recovery_workers.py``'s ``_join`` and
``_trainer``). Each joins the gloo process group on the CPU (or, with
``device="cuda"``, NCCL with a card a rank), runs its rank's share on a
``(data x fsdp)`` mesh and returns numpy arrays: the parameters it
gathers back to global leaves, its own block shapes, exchange counts.
"""

import functools
import types

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch import interop
from dlrover_tpu_torch.checkpoint.manager import state_tensors
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.parallel.accelerate import _named_leaves, accelerate
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.sharding_rules import rank_coords
from dlrover_tpu_torch.parallel.strategy import Strategy, block_consumed
from dlrover_tpu_torch.telemetry import names as tm
from dlrover_tpu_torch.telemetry.attribution import count_step
from dlrover_tpu_torch.telemetry.metrics import process_registry
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor
from dlrover_tpu_torch.utils.prof import CostCounter
from torch_recovery_workers import SURVIVORS, _join, _trainer

def _adamw(lr):
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.1)


def _np(t):
    return t.detach().cpu().numpy().copy()


def gathered(result, state):
    """Every tensor of ``state`` (``state_tensors``' names) as its global
    leaf: each sharded block gathered over the group of its axes."""
    layout, mesh = result.layout, result.mesh
    tensors, _ = state_tensors(state)
    out = {}
    for name in sorted(tensors):
        t = tensors[name]
        kind, rest = name.split("/", 1)
        path = rest.rsplit("/", 1)[0] if kind == "opt" else rest
        shard = layout.leaves.get(path)
        if shard is not None and t.dim() == len(layout.shapes[path]):
            t = ring.gather_shard(t.detach(), shard.dim,
                                  mesh.group(shard.axes))
        out[name] = _np(t)
    return out


def _blocks(state):
    tensors, _ = state_tensors(state)
    return {name: tuple(t.shape) for name, t in tensors.items()}


def _steps(result, state, batches):
    losses = []
    for batch in batches:
        state, metrics = result.train_step(state, result.shard_batch(batch))
        losses.append(float(metrics["loss"]))
    return state, losses


def _accelerate(tree, config, mesh, lr, batch, rule_set="llama",
                accum=1, init_fn=None, device="cpu", optimizer=None):
    return accelerate(
        init_fn or (lambda gen: interop.params_from_numpy(tree, device)),
        llama.make_loss_fn(config), optimizer or _adamw(lr), batch,
        strategy=Strategy(mesh=MeshPlan(data=mesh[0], fsdp=mesh[1]),
                          rule_set=rule_set, grad_accum_steps=accum),
        device=device)


def _exchanges(rank, ranks):
    """``all_gather_shard`` / ``reduce_scatter_`` in f64 over the world
    and over the (2, 2) mesh's fsdp group, along dim 1: outputs and
    gradients against their sums, the adjoint identity, the bytes."""
    mesh = MeshPlan(data=2, fsdp=2).build()
    out = {}
    for label, group in (("world", None), ("fsdp", mesh.group(("fsdp",)))):
        size = dist.get_world_size(group)
        me = dist.get_rank(group)
        members = dist.get_process_group_ranks(group or dist.group.WORLD)

        def block(r, salt):
            g = torch.Generator().manual_seed(100 * salt + r)
            return torch.randn(3, 2, 5, generator=g, dtype=torch.float64)

        ring.reset_stats()
        x = block(rank, 1).requires_grad_()
        full = ring.all_gather_shard(x, 1, group)
        want = torch.cat([block(r, 1) for r in members], dim=1)
        w = torch.randn(full.shape, generator=torch.Generator().manual_seed(
            7 + rank), dtype=torch.float64)
        (full * w).sum().backward()
        ws = [torch.randn(full.shape, generator=torch.Generator()
                          .manual_seed(7 + r), dtype=torch.float64)
              for r in members]
        grad_want = sum(ws).narrow(1, 2 * me, 2)
        y = torch.randn(3, 2 * size, 5, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(50 + rank)
                        ).requires_grad_()
        part = ring.reduce_scatter_(y, 1, group)
        ys = [torch.randn(3, 2 * size, 5, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(50 + r))
              for r in members]
        part_want = sum(ys).narrow(1, 2 * me, 2)
        v = block(rank, 3)
        (part * v).sum().backward()
        y_grad_want = torch.cat([block(r, 3) for r in members], dim=1)
        # <AG(x), w> summed over ranks == <x, RS(w)> summed over ranks
        lhs = ring.all_reduce_((full.detach() * w).sum().reshape(1), group)
        rhs = ring.all_reduce_((x.detach() * ring.scatter_sum(w, 1, group))
                               .sum().reshape(1), group)
        stats = ring.stats()
        with CostCounter() as counter:
            ring.all_gather_shard(x.detach(), 1, group)
            ring.reduce_scatter_(y.detach(), 1, group)
        meta = ring.all_gather_shard(torch.empty(3, 2, 5, device="meta"),
                                     1, group)
        out[label] = {
            "size": size,
            "gather_err": float((full.detach() - want).abs().max()),
            "x_grad_err": float((x.grad - grad_want).abs().max()),
            "scatter_err": float((part.detach() - part_want).abs().max()),
            "y_grad_err": float((y.grad - y_grad_want).abs().max()),
            "adjoint": (float(lhs), float(rhs)),
            "stats": stats,
            "counted": dict(counter.collective_bytes),
            "meta_shape": tuple(meta.shape),
        }
    return out


def dense_ranks(tree, config_kw, batches, lr, ckpt_dir, host_state,
                orbax_batches, device="cpu"):
    """The dense tiny Llama on four ranks, in one process group:

    - 3 AdamW steps from ``tree`` at (1, 4), (2, 2) and (4, 1): losses,
      the gathered final state, this rank's block shapes;
    - (2, 2) with ``grad_accum_steps=2``;
    - the init drawn by ``llama.make_init_fn`` at (2, 2), gathered;
    - ``shard_batch`` with global and with process-local rows;
    - the exchanges (``_exchanges``);
    - a checkpoint written at (2, 2) into ``ckpt_dir``, restored by a
      trainer at (4, 1);
    - the reference's state ``host_state`` resumed at (2, 2) through
      ``interop.train_state_from_numpy`` over ``orbax_batches``;
    - ``prewarm`` and ``retune`` onto fsdp meshes.
    """
    rank, ranks, device = _join(device)
    config = llama.llama_tiny(**config_kw)
    out = {"rank": rank, "runs": {}}
    for mesh in ((1, 4), (2, 2), (4, 1)):
        result = _accelerate(tree, config, mesh, lr, batches[0],
                             device=device)
        state = result.init_fn(0)
        ring.reset_stats()
        state, losses = _steps(result, state, batches)
        stats = ring.stats()
        out["runs"][mesh] = {
            "losses": losses, "state": gathered(result, state),
            "blocks": _blocks(state), "stats": stats,
            "sharded": sorted(result.layout.leaves),
            "specs": result.specs}
    if device.type != "cpu":
        dist.destroy_process_group()
        return out
    result = _accelerate(tree, config, (2, 2), lr, batches[0], accum=2)
    state, losses = _steps(result, result.init_fn(0), batches)
    out["accum"] = {"losses": losses, "state": gathered(result, state)}

    result = _accelerate(None, config, (2, 2), lr, batches[0],
                         init_fn=llama.make_init_fn(config))
    out["init"] = gathered(result, result.init_fn(0))

    glob = {k: np.asarray(v) for k, v in batches[0].items()}
    rows = glob["input_ids"].shape[0] // ranks
    local = {k: v[rank * rows:(rank + 1) * rows] for k, v in glob.items()}
    a, b = result.shard_batch(glob), result.shard_batch(local)
    out["batch_same"] = all(torch.equal(a[k], b[k]) for k in a)
    accum = _accelerate(tree, config, (2, 2), lr, batches[0], accum=2)
    a, b = accum.shard_batch(glob), accum.shard_batch(local)
    out["accum_batch_same"] = all(torch.equal(a[k], b[k]) for k in a)
    out["accum_rows"] = _np(accum.shard_batch(
        {"row": np.arange(8)[:, None]})["row"][:, 0]).tolist()
    try:
        result.shard_batch({k: v[:rows + 1] for k, v in glob.items()})
        out["batch_error"] = ""
    except ValueError as e:
        out["batch_error"] = str(e)

    out["exchanges"] = _exchanges(rank, ranks)
    mesh = MeshPlan(data=2, fsdp=2).build()
    coords = rank_coords(mesh.rank, mesh.sizes, mesh.axis_names)
    again = MeshPlan(data=2, fsdp=2).build()
    out["groups"] = {
        "coords": (coords["data"], coords["fsdp"]),
        **{name: dist.get_process_group_ranks(mesh.group(axes))
           for name, axes in (("fsdp", ("fsdp",)), ("data", ("data",)),
                              ("both", ("data", "fsdp")))},
        "reused": all(again.group((axis,)) is mesh.group((axis,))
                      for axis in ("data", "fsdp"))}

    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config), _adamw(lr), batches[0],
        strategy=Strategy(mesh=MeshPlan(data=2, fsdp=2), rule_set="llama"),
        ckpt_dir=ckpt_dir, device="cpu")
    state = trainer.prepare()
    for batch in batches[:2]:
        state, _ = trainer.step(state, batch)
    trainer.save(state)
    trainer.finalize()
    out["saved"] = gathered(trainer.accelerated, state)
    out["saved_blocks"] = _blocks(state)
    other = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config), _adamw(lr), batches[0],
        strategy=Strategy(mesh=MeshPlan(data=4, fsdp=1), rule_set="llama"),
        ckpt_dir=ckpt_dir, device="cpu")
    restored = other.prepare()
    out["restored_41"] = gathered(other.accelerated, restored)
    out["restored_step"] = restored.step
    other.finalize()

    host = types.SimpleNamespace(
        step=host_state["step"], params=host_state["params"],
        opt_state=types.SimpleNamespace(**host_state["adam"]))
    place = (rank, {"data": 2, "fsdp": 2}, "llama")
    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config), _adamw(host_state["lr"]),
        orbax_batches[0],
        strategy=Strategy(mesh=MeshPlan(data=2, fsdp=2), rule_set="llama"),
        device="cpu")
    state = trainer.prepare(interop.train_state_from_numpy(
        host, _adamw(host_state["lr"]), "cpu", place=place))
    losses = []
    for batch in orbax_batches:
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    out["orbax"] = {"losses": losses,
                    "params": gathered(trainer.accelerated, state)}

    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config), _adamw(lr), batches[0],
        strategy=Strategy(mesh=MeshPlan(data=4, fsdp=1), rule_set="llama"),
        device="cpu")
    state = trainer.prepare()
    state, _ = trainer.step(state, batches[0])
    before = gathered(trainer.accelerated, state)
    built = trainer.prewarm(mesh=MeshPlan(data=1, fsdp=4))
    state = trainer.retune(state, mesh=MeshPlan(data=2, fsdp=2))
    after = gathered(trainer.accelerated, state)
    out["retune"] = {
        "prewarm_built": built,
        "mesh": dict(trainer.accelerated.layout.sizes),
        "same": all(before[k].tobytes() == after[k].tobytes()
                    for k in before),
        "blocks": _blocks(state)}
    losses = []
    for batch in batches[1:]:
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    out["retune"]["losses"] = losses
    dist.destroy_process_group()
    return out


def restore_ranks(tree, config_kw, batch, lr, ckpt_dir, moe_tree, moe_kw,
                  moe_batches):
    """Two ranks at (1, 2): the checkpoint of ``dense_ranks`` restored
    and gathered; the step's cost counted on the meta device
    (``count_step``) beside the same count at (2, 1); ``moe_ep`` from
    ``moe_tree`` with two microbatches a step, at (1, 2) and (2, 1),
    fed the global rows and then each process's own rows: the global
    losses; and the executor's exposed-comm gauge (``_exposed_comm``)."""
    rank, ranks, _ = _join()
    moe, moe_local = {}, {}
    for mesh in ((1, 2), (2, 1)):
        result = _accelerate(
            None, llama.llama_tiny(**moe_kw), mesh, lr, moe_batches[0],
            rule_set="moe_ep", accum=2,
            init_fn=lambda gen: interop.params_from_numpy(
                moe_tree, "cpu", (rank, ranks)),
            optimizer=functools.partial(torch.optim.Adam, lr=lr))
        _, moe[mesh] = _steps(result, result.init_fn(0), moe_batches)
        # the same steps from this process's rows of each batch
        n = len(moe_batches[0]["input_ids"]) // ranks
        local = [{k: np.asarray(v)[rank * n:(rank + 1) * n]
                  for k, v in b.items()} for b in moe_batches]
        _, moe_local[mesh] = _steps(result, result.init_fn(0), local)
    config = llama.llama_tiny(**config_kw)
    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config), _adamw(lr), batch,
        strategy=Strategy(mesh=MeshPlan(data=1, fsdp=2), rule_set="llama"),
        ckpt_dir=ckpt_dir, device="cpu")
    state = trainer.prepare()
    out = {"restored": gathered(trainer.accelerated, state),
           "step": state.step}
    trainer.finalize()
    counts = {}
    for mesh in ((1, 2), (2, 1)):
        result = _accelerate(tree, config, mesh, lr, batch)
        counter = count_step(result, 1, batch)
        gathered_bytes = sum(
            4 * int(np.prod(result.layout.shapes[p]))
            for p in result.layout.leaves)
        counts[mesh] = {"collective": dict(counter.collective_bytes),
                        "matmul_flops": counter.matmul_flops,
                        "gathered_bytes": gathered_bytes}
    out["counts"] = counts
    out["moe_accum"] = moe
    out["moe_accum_local"] = moe_local
    out["exposed"] = _exposed_comm(tree, config, batch, lr)
    dist.destroy_process_group()
    return out


def _exposed_comm(tree, config, batch, lr, steps=4):
    """``steps`` steps through ``TrainExecutor`` at (1, 2) with
    attribution on, at a peak so high that compute explains next to
    none of a step: for each measured step its time, the exchange
    seconds the executor read, the exposed-comm gauge it set and the
    record's ideal compute seconds."""
    ctx = get_context()
    ctx.telemetry_enabled = ctx.attribution_enabled = True
    ctx.device_peak_flops = 1e18
    process_registry().reset()
    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config), _adamw(lr), batch,
        strategy=Strategy(mesh=MeshPlan(data=1, fsdp=2), rule_set="llama"),
        device="cpu")
    seen = []
    original = TrainExecutor._observe_attribution

    def spy(self, per_step):
        original(self, per_step)
        gauge = process_registry().get(tm.ATTR_EXPOSED_COMM_FRAC)
        seen.append((per_step, self._step_exchange_s,
                     None if gauge is None else gauge.value,
                     self._attr_record.predicted_compute_s))

    TrainExecutor._observe_attribution = spy
    try:
        TrainExecutor(trainer, train_iter_fn=lambda: [batch] * steps,
                      conf=Configuration({
                          "train_steps": steps, "log_every_steps": 0,
                          "train_window": 1,
                          "preemption_grace": False})).train_and_evaluate()
    finally:
        TrainExecutor._observe_attribution = original
    return seen


def moe_ep_ranks(tree, config_kw, batches, lr):
    """``rule_set="moe_ep"`` at (2, 2) from ``tree`` (each rank's
    experts cut by ``interop``): the global losses and metrics, the
    gathered final state and this rank's block shapes."""
    rank, ranks, _ = _join()
    config = llama.llama_tiny(**config_kw)
    result = _accelerate(
        None, config, (2, 2), lr, batches[0], rule_set="moe_ep",
        init_fn=lambda gen: interop.params_from_numpy(tree, "cpu",
                                                      (rank, ranks)),
        optimizer=functools.partial(torch.optim.Adam, lr=lr))
    state = result.init_fn(0)
    steps = []
    for batch in batches:
        state, metrics = result.train_step(state, result.shard_batch(batch))
        steps.append({k: np.asarray(torch.as_tensor(v).detach())
                      for k, v in metrics.items()})
    consumed = sorted(p for p in result.layout.leaves
                      if block_consumed("moe_ep", p))
    out = {"steps": steps, "blocks": _blocks(state), "consumed": consumed,
           "sharded": sorted(result.layout.leaves)}
    dist.destroy_process_group()
    return out


def reshard_ranks(tree, config_kw, batches, lr, before, rule_set):
    """Four ranks at (2, 2): ``before`` steps, a snapshot for ranks 0
    and 1, ``live_reshard`` onto them (2 and 3 leave), the rest; then on
    the survivors a cold trainer for the new world from the same
    snapshot over the same batches. Returns the losses, the gathered
    state before and right after the change, both paths' final state,
    the mesh and the regroup's exchange bytes."""
    rank, ranks, device = _join()
    trainer = _trainer(tree, config_kw, lr, batches[0], Strategy(
        mesh=MeshPlan(data=2, fsdp=2), rule_set=rule_set))
    state = trainer.prepare()
    losses = []
    for batch in batches[:before]:
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    out = {"rank": rank, "losses": losses,
           "before": gathered(trainer.accelerated, state),
           "blocks_before": _blocks(state)}
    snap = trainer.snapshot(state, world_to=SURVIVORS)
    state = trainer.live_reshard(state, devices=SURVIVORS, snapshot=snap,
                                 reason="test")
    if state is None:
        out["left"] = not dist.is_initialized()
        return out
    result = trainer.accelerated
    out.update(world_after=dist.get_world_size(),
               mesh_after=dict(result.layout.sizes),
               accum_after=result.strategy.grad_accum_steps,
               after=gathered(result, state), blocks_after=_blocks(state))
    live = []
    for batch in batches[before:]:
        state, metrics = trainer.step(state, batch)
        live.append(float(metrics["loss"]))
    out.update(live=live, live_state=gathered(result, state))
    # built for the new world from scratch, with the live step's
    # strategy ((1, 2), two microbatches)
    cold = _trainer(tree, config_kw, lr, batches[0], result.strategy)
    cstate = cold.restore_snapshot(cold.prepare(), snap)
    closses = []
    for batch in batches[before:]:
        cstate, metrics = cold.step(cstate, batch)
        closses.append(float(metrics["loss"]))
    out.update(cold=closses, cold_state=gathered(cold.accelerated, cstate))
    dist.destroy_process_group()
    return out


def leaf_paths(tree):
    """The parameter paths of a tree, sorted (for the test's layout)."""
    return [path for path, _ in _named_leaves(tree)]
