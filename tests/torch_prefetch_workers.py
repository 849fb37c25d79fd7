"""Rank functions of ``tests/test_torch_fsdp_prefetch.py``.

Each runs in a process that ``dlrover_tpu_torch.trainer.run.run_local``
spawns, imports torch and the port only, joins the gloo process group on
the CPU (or NCCL with a card a rank) and returns plain values and numpy
arrays: losses, each step's block gradients, the final blocks, exchange
and held-layer statistics, each run with the layer prefetch off and on
from the same weights and batches.
"""

import functools
import gc

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch import interop
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.optimizers import wsam
from dlrover_tpu_torch.parallel import layer_prefetch
from dlrover_tpu_torch.parallel.accelerate import _named_leaves, accelerate
from dlrover_tpu_torch.parallel import strategy as strategy_mod
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.sharding_rules import (
    REPLICATED,
    ShardingRules,
    llama_rules,
)
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.telemetry.attribution import count_step
from torch_recovery_workers import _join


# the stacked layer leaves cut on their first dim after the layer dim
# (never a kernel's last), the rest as "llama": every layer leaf a slice
# to all-gather, as FSDP_AUTO cuts a stack it cannot split by layers
SLICES = "layer_slices"


def _slice_rules():
    return ShardingRules(rules=[
        (r"layers/.*kernel$", (None, "fsdp", None)),
        (r"layers/.*scale$", (None, "fsdp")),
        (r"^norm/scale$", REPLICATED),
        *llama_rules().rules])


def _np(t):
    return t.detach().cpu().numpy().copy()


def _build(tree, config, mesh, batch, rule_set="llama", accum=1, lr=1e-2,
           moe_ep=False, device="cpu"):
    def init_fn(gen):
        shard = ((dist.get_rank(), dist.get_world_size()) if moe_ep
                 else None)
        return interop.params_from_numpy(tree, device, shard)

    return accelerate(
        init_fn, llama.make_loss_fn(config),
        functools.partial(torch.optim.SGD, lr=lr), batch,
        strategy=Strategy(mesh=MeshPlan(data=mesh[0], fsdp=mesh[1]),
                          rule_set=rule_set, grad_accum_steps=accum),
        device=device)


def _run(result, batches):
    """Steps over ``batches`` from the init: losses, this rank's block
    gradients after each step, the final blocks, and the exchange and
    held-layer statistics of the steps."""
    state = result.init_fn(0)
    gc.collect()  # what an earlier run left to the collector
    ring.reset_stats()
    layer_prefetch.reset_stats()
    losses, grads = [], []
    for batch in batches:
        state, metrics = result.train_step(state, result.shard_batch(batch))
        losses.append(float(metrics["loss"]))
        grads.append({path: _np(p.grad)
                      for path, p in _named_leaves(state.params)})
    return {"losses": losses, "grads": grads,
            "params": {path: _np(p) for path, p in
                       _named_leaves(state.params)},
            "stats": ring.stats(), "held": layer_prefetch.stats(),
            "sharded": {p: (s.dim, result.layout.shapes[p])
                        for p, s in result.layout.leaves.items()}}


def _pair(tree, config_kw, batches, mesh, rule_set="llama", accum=1,
          moe_ep=False, device="cpu"):
    """The same steps with the prefetch off, then on."""
    out = {}
    for on in (False, True):
        config = llama.llama_tiny(**config_kw, fsdp_prefetch=on)
        result = _build(tree, config, mesh, batches[0], rule_set, accum,
                        moe_ep=moe_ep, device=device)
        out[on] = _run(result, batches)
    return out


def _counted(tree, config_kw, batch, mesh):
    """Collective bytes ``CostCounter`` counts on the meta device for one
    step, the prefetch on."""
    config = llama.llama_tiny(**config_kw, fsdp_prefetch=True)
    result = _build(tree, config, mesh, batch)
    return dict(count_step(result, 1, batch).collective_bytes)


def _other_callers(tree, config_kw, batches, mesh):
    """The two other callers of the step's forward and backward, each
    with the prefetch off and on: ``train_step_multi`` (K = 2 steps in
    one call) and a two-gradient optimizer (WSAM, whose second gradient
    runs the whole forward and backward again). Their losses and final
    blocks."""
    out = {}
    for on in (False, True):
        loss_fn = llama.make_loss_fn(llama.llama_tiny(**config_kw,
                                                      fsdp_prefetch=on))
        strategy = Strategy(mesh=MeshPlan(data=mesh[0], fsdp=mesh[1]),
                            rule_set="llama")

        def init_fn(gen):
            return interop.params_from_numpy(tree, "cpu")

        sgd = functools.partial(torch.optim.SGD, lr=1e-2)
        multi = accelerate(init_fn, loss_fn, sgd, batches[0],
                           strategy=strategy, device="cpu", steps_per_call=2)
        state = multi.init_fn(0)
        stacked = {k: np.stack([b[k] for b in batches[:2]])
                   for k in batches[0]}
        state, metrics = multi.train_step_multi(
            state, multi.shard_batch(stacked, stacked=True))
        two = accelerate(init_fn, loss_fn,
                         wsam(sgd, learning_rate=1e-2, max_norm=1.0),
                         batches[0], strategy=strategy, device="cpu")
        wstate = two.init_fn(0)
        wlosses = []
        for batch in batches:
            wstate, m = two.train_step(wstate, two.shard_batch(batch))
            wlosses.append(float(m["loss"]))
        out[on] = {
            "multi": [float(x) for x in metrics["loss"]],
            "multi_params": {p: _np(t) for p, t in
                             _named_leaves(state.params)},
            "wsam": wlosses,
            "wsam_params": {p: _np(t) for p, t in
                            _named_leaves(wstate.params)}}
    return out


def _knob_flip(tree, config_kw, batches, mesh):
    """One ``accelerate`` result with the config's prefetch left to the
    Context, the knob off, on, off across three steps: each step's
    exchange kinds and held-layer mark."""
    ctx = get_context()
    saved = ctx.fsdp_prefetch
    result = _build(tree, llama.llama_tiny(**config_kw), mesh, batches[0])
    state = result.init_fn(0)
    seen = []
    try:
        for on, batch in zip((False, True, False), batches):
            ctx.fsdp_prefetch = on
            ring.reset_stats()
            layer_prefetch.reset_stats()
            state, _ = result.train_step(state, result.shard_batch(batch))
            seen.append({"stats": ring.stats(),
                         "held": layer_prefetch.stats()})
    finally:
        ctx.fsdp_prefetch = saved
    return seen


def _staged(rank):
    """The gloo staging forced on CPU tensors: every exchange, three
    rounds, against the unstaged exchanges."""
    group = dist.group.WORLD
    size = dist.get_world_size()

    def run():
        x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) + rank
        y = torch.arange(10, dtype=torch.float32) * (rank + 1)
        return [
            ring.all_reduce_(x.clone(), group),
            ring.gather_shard(x, 1, group),
            ring.scatter_sum(x.repeat(1, size, 1), 1, group),
            ring.exchange_all_to_all(x[:size], group),
            ring.broadcast_async(x, 1, group).wait(),
            ring.reduce_async(x, 0, group).wait(),
            ring.gather_shard_async(x, 1, group).wait(),
            ring.scatter_sum_async(x.repeat(1, size, 1), 1, group).wait(),
            ring.all_reduce_(y.clone(), group)]

    want = run()
    original = ring.through_host
    ring.through_host = lambda t, g: True
    try:
        got = [run() for _ in range(3)]
    finally:
        ring.through_host = original
    return all(
        (a is None and b is None) or (a is not None and b is not None
                                      and a.shape == b.shape
                                      and torch.equal(a, b))
        for g in got for a, b in zip(g, want))


def pair_ranks(tree, moe_tree, config_kw, moe_kw, batches):
    """Two ranks at (data, fsdp) = (1, 2), three SGD steps a run, each
    with the prefetch off and on: "llama" rules (layers broadcast from
    their owner) and ``SLICES`` (layer slices all-gathered), each under
    the bf16, fp8 and fp8_qdq wires, and the grouped MoE under "moe"
    rules (the experts' slices all-gathered); two microbatches; the remat
    policies "full" and "none"; the meta device's count; an evaluation;
    the fused K-step call and a two-gradient optimizer; the Context knob
    flipped between steps; the staging forced on CPU tensors."""
    rank, _, _ = _join()
    strategy_mod.RULE_SETS[SLICES] = _slice_rules
    out = {"rank": rank, "runs": {}}
    for rule_set, precision in (("llama", "bf16"), ("llama", "fp8"),
                                ("llama", "fp8_qdq"), (SLICES, "bf16"),
                                (SLICES, "fp8"), (SLICES, "fp8_qdq")):
        kw = {**config_kw, "fsdp_precision": precision}
        out["runs"][(rule_set, precision)] = _pair(tree, kw, batches,
                                                   (1, 2), rule_set)
    out["runs"][("moe", "bf16")] = _pair(moe_tree, moe_kw, batches,
                                         (1, 2), "moe")
    out["accum"] = _pair(tree, config_kw, batches, (1, 2), accum=2)
    for policy in ("full", "none"):
        out[policy] = _pair(tree, {**config_kw, "remat_policy": policy},
                            batches[:1], (1, 2))
    out["counted"] = _counted(tree, config_kw, batches[0], (1, 2))
    try:
        result = accelerate(
            lambda gen: interop.params_from_numpy(tree, "cpu"),
            llama.make_loss_fn(llama.llama_tiny(**config_kw,
                                                fsdp_prefetch=True)),
            functools.partial(torch.optim.SGD, lr=1e-2), batches[0],
            strategy=Strategy(mesh=MeshPlan(data=1, fsdp=2),
                              rule_set="llama", remat_policy="full"),
            device="cpu")
        result.train_step(result.init_fn(0),
                          result.shard_batch(batches[0]))
        out["strategy_remat"] = ""
    except ValueError as e:
        out["strategy_remat"] = str(e)
    out["eval"] = {}
    for on in (False, True):
        result = _build(tree, llama.llama_tiny(**config_kw,
                                               fsdp_prefetch=on),
                        (1, 2), batches[0])
        state = result.init_fn(0)
        layer_prefetch.reset_stats()
        loss = result.eval_step(state, result.shard_batch(batches[0]))
        out["eval"][on] = (float(loss["loss"]), layer_prefetch.stats())
    out["callers"] = _other_callers(tree, config_kw, batches, (1, 2))
    out["flip"] = _knob_flip(tree, config_kw, batches, (1, 2))
    out["staged"] = _staged(rank)
    dist.destroy_process_group()
    return out


def one_card_ranks(tree, config_kw, batches, delay_cycles):
    """Two ranks sharing ``cuda:0`` over gloo at (1, 2), so the layer
    exchanges are staged through host memory on ``ring``'s copy stream:
    under the fp8 and fp8_qdq wires, "llama" and ``SLICES`` rules, the
    prefetch off and on. With it on, the stream each layer's quantize
    runs on first spins ``delay_cycles`` (``torch.cuda._sleep``) and
    fills a block of the quantized values' size with e4m3 NaNs, freed at
    once, so a copy out that did not wait for the quantize would send
    those bytes, or another step's. Each run's wire precision as resolved on the card."""
    from dlrover_tpu_torch.trainer import bootstrap

    torch.set_num_threads(1)
    worker = bootstrap.init_worker("gloo", "cuda:0")
    strategy_mod.RULE_SETS[SLICES] = _slice_rules
    quantize = layer_prefetch.quantize_block_scaled

    def late(x, block):
        torch.cuda._sleep(delay_cycles)
        # e4m3's NaN where the quantized values are likely to be made
        torch.full(x.shape, 0xFF, dtype=torch.uint8, device=x.device)
        return quantize(x, block)

    layer_prefetch.quantize_block_scaled = late
    out = {"rank": worker.process_id, "runs": {}}
    try:
        for rule_set in ("llama", SLICES):
            for precision in ("fp8", "fp8_qdq"):
                kw = {**config_kw, "fsdp_precision": precision}
                out["runs"][(rule_set, precision)] = {
                    **_pair(tree, kw, batches, (1, 2), rule_set,
                            device="cuda:0"),
                    "resolved": llama.resolve_fsdp_precision(
                        llama.llama_tiny(**kw), torch.device("cuda:0"))}
    finally:
        layer_prefetch.quantize_block_scaled = quantize
    dist.destroy_process_group()
    return out


def quad_ranks(tree, moe_tree, config_kw, moe_kw, batches, moe_batches,
               device="cpu"):
    """Four ranks: the dense model at (1, 4) and (2, 2) with the
    prefetch off and on (on the CPU also two microbatches at (2, 2)),
    and ``moe_ep`` at (2, 2)."""
    rank, _, device = _join(device)
    out = {"rank": rank, "runs": {}}
    for mesh in ((1, 4), (2, 2)):
        out["runs"][mesh] = _pair(tree, config_kw, batches, mesh,
                                  device=device)
    if device.type == "cpu":
        out["accum"] = _pair(tree, config_kw, batches, (2, 2), accum=2)
        out["moe_ep"] = _pair(moe_tree, moe_kw, moe_batches, (2, 2),
                              "moe_ep", moe_ep=True)
    dist.destroy_process_group()
    return out

