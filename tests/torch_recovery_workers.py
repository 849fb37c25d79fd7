"""Rank functions of ``tests/test_torch_recovery.py``.

Each runs in a process that ``dlrover_tpu_torch.trainer.run.run_local``
spawns, imports torch and the port only, joins the gloo process group on
the CPU (or, with ``device="cuda"``, NCCL with a card a rank) and
returns numpy arrays. The worlds change in the processes:
four ranks train, ranks 2 and 3 leave, ranks 0 and 1 go on as a world
of two (``ElasticTrainer.live_reshard``), and then a cold trainer built
for that world is restored from the same snapshot and stepped over the
same batches.
"""

import functools

import torch
import torch.distributed as dist

from dlrover_tpu_torch import interop
from dlrover_tpu_torch.checkpoint.manager import state_tensors
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import kernel_build
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer import bootstrap
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook

SURVIVORS = [0, 1]


def _join(device="cpu"):
    torch.set_num_threads(1)
    if device == "cuda":
        worker = bootstrap.init_worker("nccl")  # cuda:<LOCAL_RANK>
    else:
        worker = bootstrap.init_worker("gloo", "cpu")
    return worker.process_id, worker.num_processes, worker.device


def _trainer(tree, config_kw, lr, batch, strategy, device="cpu"):
    """An Adam trainer on the reference's parameters; under ``moe_ep``
    each rank takes its block of experts for the world it is in when
    the init runs."""
    config = llama.llama_tiny(**config_kw)
    sharded = strategy.rule_set == "moe_ep"

    def init_fn(gen):
        shard = ((dist.get_rank(), dist.get_world_size())
                 if sharded and dist.is_initialized() else None)
        return interop.params_from_numpy(tree, device, shard)

    return ElasticTrainer(init_fn, llama.make_loss_fn(config),
                          functools.partial(torch.optim.Adam, lr=lr), batch,
                          strategy=strategy, device=device)


def _arrays(state):
    """Every parameter and optimizer tensor, by ``state_tensors`` name."""
    tensors, _ = state_tensors(state)
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def _cold(tree, config_kw, lr, batches, strategy, snapshot, device="cpu"):
    """A fresh trainer for the current world with ``strategy`` (the
    live one's after the change), restored from ``snapshot`` (its rng
    and host step too), stepped over ``batches``."""
    trainer = _trainer(tree, config_kw, lr, batches[0], strategy, device)
    state = trainer.restore_snapshot(trainer.prepare(), snapshot)
    losses = []
    for batch in batches:
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, _arrays(state)


def moe_reshard_ranks(tree, batches, config_kw, lr, before_steps,
                      device="cpu"):
    """``rule_set="moe_ep"`` over four ranks: ``before_steps`` steps,
    a snapshot for the world of ranks 0 and 1, ``live_reshard`` onto it
    (2 and 3 leave), the remaining steps; then, on the survivors, the
    cold path from the same snapshot. Returns the losses, this rank's
    state before the change, the survivors' state right after it and at
    the end of both paths, and the strategy's grad accumulation."""
    rank, ranks, device = _join(device)
    strategy = Strategy(mesh=MeshPlan(data=ranks, fsdp=1), rule_set="moe_ep")
    trainer = _trainer(tree, config_kw, lr, batches[0], strategy, device)
    state = trainer.prepare()
    losses = []
    for batch in batches[:before_steps]:
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    out = {"rank": rank, "losses": losses, "before": _arrays(state),
           "accum_before": trainer.accelerated.strategy.grad_accum_steps}
    snap = trainer.snapshot(state, world_to=SURVIVORS)
    loads = dict(kernel_build.LOADS)
    state = trainer.live_reshard(state, devices=SURVIVORS, snapshot=snap,
                                 reason="test")
    if state is None:
        out["left"] = not dist.is_initialized()
        return out
    out.update(rank_after=dist.get_rank(), world_after=dist.get_world_size(),
               backend=dist.get_backend(),
               step_after=state.step, after=_arrays(state),
               accum_after=trainer.accelerated.strategy.grad_accum_steps,
               reshard=dict(trainer.last_reshard))
    live = []
    for batch in batches[before_steps:]:
        state, metrics = trainer.step(state, batch)
        live.append(float(metrics["loss"]))
    out.update(live=live, live_state=_arrays(state),
               kernels_loaded_again=kernel_build.LOADS != loads)
    cold, cold_state = _cold(tree, config_kw, lr, batches[before_steps:],
                             trainer.accelerated.strategy, snap, device)
    out.update(cold=cold, cold_state=cold_state)
    dist.destroy_process_group()
    return out


def dense_executor_ranks(tree, batches, lr, at_step, window):
    """A dense data-parallel run through ``TrainExecutor`` over four
    ranks, with ``request_live_reshard([0, 1])`` made before step
    ``at_step``: every step's loss as the hooks saw it, how the run
    ended, and on the survivors the cold path from the snapshot the
    reshard took."""
    rank, ranks, _ = _join()
    strategy = Strategy(mesh=MeshPlan(data=ranks, fsdp=1), rule_set="llama")
    trainer = _trainer(tree, {}, lr, batches[0], strategy)
    snaps = []
    take = trainer.snapshot

    def snapshot(*args, **kwargs):
        snaps.append(take(*args, **kwargs))
        return snaps[-1]

    trainer.snapshot = snapshot
    seen = {}
    box = []

    class Hook(TrainHook):
        def before_step(self, step):
            if step == at_step:
                box[0].request_live_reshard(SURVIVORS)

        def after_step(self, step, metrics):
            assert step not in seen, f"step {step} materialized twice"
            seen[step] = float(metrics["loss"])

    source = iter(batches)
    executor = TrainExecutor(
        trainer, train_iter_fn=lambda: source, hooks=[Hook()],
        conf=Configuration({"train_steps": len(batches),
                            "log_every_steps": 0, "train_window": window,
                            "preemption_grace": False}))
    box.append(executor)
    result = executor.train_and_evaluate()
    out = {"rank": rank, "result": result, "seen": seen,
           "snapshot_steps": [s.step for s in snaps]}
    if result.get("left_world"):
        return out
    out.update(world_after=dist.get_world_size(),
               state=_arrays(executor.state))
    cold, cold_state = _cold(tree, {}, lr, batches[snaps[-1].step:],
                             trainer.accelerated.strategy, snaps[-1])
    out.update(cold=cold, cold_state=cold_state)
    dist.destroy_process_group()
    return out


def attribution_reshard_ranks(batches, lr, at_step, window):
    """The dense executor run of ``dense_executor_ranks`` with the
    attribution plane on: four ranks, ``request_live_reshard([0, 1])``
    before step ``at_step``. Returns each ``attribution_captured``
    event's world and counts, the record the trainer holds at the end,
    and the parameter bytes the gradient all-reduce moves."""
    from dlrover_tpu_torch.telemetry.events import recent_events
    from dlrover_tpu_torch.utils.prof import param_bytes

    rank, ranks, _ = _join()
    strategy = Strategy(mesh=MeshPlan(data=ranks, fsdp=1), rule_set="llama")
    config = llama.llama_tiny()
    trainer = ElasticTrainer(llama.make_init_fn(config),
                             llama.make_loss_fn(config),
                             functools.partial(torch.optim.Adam, lr=lr),
                             batches[0], strategy=strategy, device="cpu")
    box = []

    class Hook(TrainHook):
        def before_step(self, step):
            if step == at_step:
                box[0].request_live_reshard(SURVIVORS)

    source = iter(batches)
    executor = TrainExecutor(
        trainer, train_iter_fn=lambda: source, hooks=[Hook()],
        conf=Configuration({"train_steps": len(batches),
                            "log_every_steps": 0, "train_window": window,
                            "preemption_grace": False}))
    box.append(executor)
    result = executor.train_and_evaluate()
    captured = [{k: e[k] for k in ("n_devices", "flops_per_step",
                                   "bytes_accessed_per_step")}
                for e in recent_events() if e["kind"] == "attribution_captured"]
    out = {"rank": rank, "result": result, "captured": captured,
           "param_bytes": param_bytes(executor.state.params)
           if executor.state is not None else None}
    if not result.get("left_world"):
        record = trainer.attribution()
        out.update(record=record.to_dict(),
                   cached=len(trainer._attr_records))
        dist.destroy_process_group()
    return out


def moe_ep_attribution_ranks(tree, batch, config_kw, lr):
    """``moe_ep`` over two ranks: the meta-device count of one step
    (``telemetry.attribution.count_step``) beside one real step on the
    CPU counted by the same ``CostCounter``, with the rows each grouped
    call was given (a spy on the wrapper) and the bytes ``ops.ring``'s
    own statistics saw the real step move."""
    from dlrover_tpu_torch.ops import grouped_matmul as gm
    from dlrover_tpu_torch.ops import ring
    from dlrover_tpu_torch.telemetry.attribution import count_step
    from dlrover_tpu_torch.utils.prof import CostCounter

    rank, ranks, device = _join()
    strategy = Strategy(mesh=MeshPlan(data=ranks, fsdp=1), rule_set="moe_ep")
    trainer = _trainer(tree, config_kw, lr, batch, strategy, device)
    state = trainer.prepare()
    result = trainer.accelerated
    meta = count_step(result, 1, batch)
    gen = torch.Generator().manual_seed(0)
    sharded = result.shard_batch(batch)
    state, _ = result.train_step(state, sharded, gen)
    rows = []
    fwd, dw = gm.grouped_matmul_fwd, gm.grouped_matmul_dw

    def spy_fwd(x, w, *args, **kwargs):
        rows.append(("grouped_matmul_fwd", x.shape[0], w.shape[1],
                     w.shape[2]))
        return fwd(x, w, *args, **kwargs)

    def spy_dw(x, dy, *args, **kwargs):
        rows.append(("grouped_matmul_dw", x.shape[0], x.shape[1],
                     dy.shape[1]))
        return dw(x, dy, *args, **kwargs)

    gm.grouped_matmul_fwd, gm.grouped_matmul_dw = spy_fwd, spy_dw
    ring.reset_stats()
    try:
        with CostCounter() as real:
            result.train_step(state, sharded, gen)
    finally:
        gm.grouped_matmul_fwd, gm.grouped_matmul_dw = fwd, dw
    stats = ring.stats()
    dist.destroy_process_group()
    return {"rank": rank, "meta": meta.summary(), "real": real.summary(),
            "meta_flops": meta.flops, "real_flops": real.flops,
            "meta_bytes": meta.bytes, "real_bytes": real.bytes,
            "rows": rows, "stats": stats}
