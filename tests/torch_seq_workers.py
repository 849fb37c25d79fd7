"""Rank functions of ``tests/test_torch_ring_attention.py`` and
``tests/test_torch_seq.py``.

Each runs in a process that ``dlrover_tpu_torch.trainer.run.run_local``
spawns, so it lives at a module's top level and imports torch and the
port only (and ``tests/torch_recovery_workers.py``'s ``_join`` and
``tests/torch_fsdp_workers.py``'s ``gathered``). Each joins the gloo
process group on the CPU and returns numpy arrays and plain numbers.
"""

import functools

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import glm, llama
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import ring, ring_attention
from dlrover_tpu_torch.parallel.accelerate import accelerate
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.telemetry.attribution import count_step
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from torch_fsdp_workers import gathered
from torch_recovery_workers import _join

# the global-length mark of a [B, H, S, D] or [B, S] array's token dim
TOKEN_DIM = {4: 2, 2: 1}
# AdamW's eps in the one-step comparisons (tests/test_torch_seq.py)
STEP_EPS = 1e-3


def _np(t):
    return t.detach().cpu().numpy().copy()


def _block(a, my, n):
    """Seq rank ``my`` of ``n``'s contiguous block of ``a``'s tokens."""
    t = torch.as_tensor(np.ascontiguousarray(a))
    dim = TOKEN_DIM[t.dim()]
    s = t.shape[dim] // n
    return t.narrow(dim, my * s, s).contiguous()


def _ring_case(case, group, impl, overlap=True):
    """One case's local out and dq, dk, dv on this rank of ``group``
    (the global arrays in ``case``; ``w``: the output's cotangent)."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    q, k, v = (_block(case[x], my, n).requires_grad_() for x in "qkv")
    seg = case.get("seg")
    out = ring_attention.ring_attention_local(
        q, k, v, group, causal=case["causal"], impl=impl,
        block_k=case.get("block_k", 512),
        segment_ids=None if seg is None else _block(seg, my, n),
        prefix_len=(None if case.get("prefix") is None
                    else torch.as_tensor(case["prefix"])),
        overlap=overlap)
    (out * _block(case["w"], my, n)).sum().backward()
    return {"out": _np(out), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad)}


def ring_ranks(cases):
    """Every case at seq = 4 (the world) and seq = 2 (ranks {0, 1} and
    {2, 3}), with the flash kernels' plain versions and the blockwise
    attend; the overlapped schedule against the synchronous one bit for
    bit; ``ring_shift`` and its backward against the reverse shift; the
    shift's statistics."""
    rank, ranks, _ = _join()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    pair = pairs[rank // 2]
    out = {"rank": rank, "seq4": {}, "seq2": {}}
    for name, case in cases.items():
        for impl in ("flash", "blockwise"):
            out["seq4"][(name, impl)] = _ring_case(case, None, impl)
            out["seq2"][(name, impl)] = _ring_case(case, pair, impl)
    # the overlapped schedule against the synchronous one, bit for bit
    out["overlap_bitwise"] = {}
    for name, case in cases.items():
        for impl in ("flash", "blockwise"):
            a = _ring_case(case, None, impl, overlap=True)
            b = _ring_case(case, None, impl, overlap=False)
            out["overlap_bitwise"][(name, impl)] = all(
                np.array_equal(a[key], b[key]) for key in a)
    # ring_shift: forward from rank - 1, backward to rank - 1 (the reverse
    # shift of the cotangent), bit for bit
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(rank),
                    dtype=torch.float64).requires_grad_()
    ring.reset_stats()
    y = ring.ring_shift(x)
    g = torch.randn(3, 5, generator=torch.Generator().manual_seed(
        100 + rank), dtype=torch.float64)
    y.backward(g)
    want_y = torch.randn(3, 5, generator=torch.Generator().manual_seed(
        (rank - 1) % ranks), dtype=torch.float64)
    want_g = torch.randn(3, 5, generator=torch.Generator().manual_seed(
        100 + (rank + 1) % ranks), dtype=torch.float64)
    reverse = ring.shift(g, step=-1)
    out["shift"] = {
        "forward": torch.equal(y.detach(), want_y),
        "backward": torch.equal(x.grad, want_g),
        "reverse": torch.equal(x.grad, reverse),
        "stats": ring.stats()["ring_shift"],
        "pair": ring.shift((torch.arange(4, dtype=torch.int32) + 10 * rank,
                            torch.full((2,), float(rank))), pair),
    }
    dist.destroy_process_group()
    return {**out, "pair_out": tuple(_np(t) for t in out["shift"].pop(
        "pair"))}


def _adamw(lr, eps=1e-8):
    return functools.partial(torch.optim.AdamW, lr=lr, betas=(0.9, 0.999),
                             eps=eps, weight_decay=0.1)


def _model(kind, config_kw):
    """(family module, its config) of a run: "llama" or "glm"."""
    if kind == "llama":
        return llama, llama.llama_tiny(**config_kw)
    return glm, glm.glm_tiny(**config_kw)


def _result(kind, config_kw, tree, batch, mesh, lr, rule_set=None):
    family, config = _model(kind, config_kw)
    data, fsdp, seq = mesh
    return accelerate(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        family.make_loss_fn(config), _adamw(lr, STEP_EPS), batch,
        strategy=Strategy(mesh=MeshPlan(data=data, fsdp=fsdp, seq=seq),
                          rule_set=rule_set or kind),
        device="cpu")


def _one_step(kind, config_kw, tree, batch, mesh, lr):
    """One AdamW step at ``mesh`` (data, fsdp, seq): the reported loss,
    the gradient norm and the gathered parameters after the step."""
    result = _result(kind, config_kw, tree, batch, mesh, lr)
    state = result.init_fn(0)
    fa.reset_launch_counts()
    ring.reset_stats()
    state, metrics = result.train_step(state, result.shard_batch(batch))
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "state": gathered(result, state), "stats": ring.stats(),
            "launches": fa.launch_counts(),
            "sizes": dict(result.layout.sizes),
            "eval": float(result.eval_step(state, result.shard_batch(
                batch))["loss"])}


def _runs(runs, lr, ranks):
    """Each run of ``runs`` ({key: (kind, config_kw, tree, batch,
    mesh)}) whose mesh fits this world, one AdamW step each."""
    return {key: _one_step(kind, config_kw, tree, batch, mesh, lr)
            for key, (kind, config_kw, tree, batch, mesh) in runs.items()
            if int(np.prod(mesh)) == ranks}


def _groups(ranks):
    """This rank's process groups of MeshPlan(data=2, seq=2) over four
    ranks: each group's members by its axes; a second build's groups
    the first's."""
    mesh = MeshPlan(data=2, seq=2).build(ranks)
    out = {"sizes": mesh.sizes, "groups": {}}
    for axes in (("seq",), ("data",), ("data", "seq"), ("fsdp",)):
        group = mesh.group(axes)
        out["groups"][axes] = (None if group is None else
                               dist.get_process_group_ranks(group))
    again = MeshPlan(data=2, seq=2).build(ranks)
    out["reused"] = all(again.groups[k] is v for k, v in mesh.groups.items())
    return out


def _trainer(tree, config_kw, batch, strategy, lr, ckpt_dir=None):
    config = llama.llama_tiny(**config_kw)
    return ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(config), _adamw(lr), batch, strategy=strategy,
        ckpt_dir=ckpt_dir, device="cpu")


def _strategy(mesh):
    return Strategy(mesh=MeshPlan(data=mesh[0], fsdp=mesh[1], seq=mesh[2]),
                    rule_set="llama")


def _world_change(tree, config_kw, batches, lr):
    """(2, 1, 2) for one step, then ranks {0, 1} go on at (1, 1, 2)
    through ``live_reshard`` (2 and 3 leave) for the other batches;
    on the survivors a cold trainer for the new world from the same
    snapshot over the same batches."""
    rank = dist.get_rank()
    trainer = _trainer(tree, config_kw, batches[0], _strategy((2, 1, 2)),
                       lr)
    state = trainer.prepare()
    state, m = trainer.step(state, batches[0])
    out = {"rank": rank, "before": float(m["loss"]),
           "mesh_before": dict(trainer.accelerated.layout.sizes)}
    snap = trainer.snapshot(state, world_to=[0, 1])
    state = trainer.live_reshard(state, devices=[0, 1], snapshot=snap,
                                 reason="test")
    if state is None:
        out["left"] = not dist.is_initialized()
        return out
    result = trainer.accelerated
    out["mesh_after"] = dict(result.layout.sizes)
    out["accum_after"] = result.strategy.grad_accum_steps
    live = []
    for b in batches[1:]:
        state, m = trainer.step(state, b)
        live.append(float(m["loss"]))
    out.update(live=live, live_state=gathered(result, state))
    cold = _trainer(tree, config_kw, batches[0], result.strategy, lr)
    cstate = cold.restore_snapshot(cold.prepare(), snap)
    closses = []
    for b in batches[1:]:
        cstate, m = cold.step(cstate, b)
        closses.append(float(m["loss"]))
    out.update(cold=closses, cold_state=gathered(cold.accelerated, cstate))
    return out


def _checkpoint(tree, config_kw, batch, lr, ckpt_dir, at, to):
    """A checkpoint written at mesh ``at`` after one step, restored by a
    trainer at ``to``: the gathered state on both sides."""
    rank = dist.get_rank()
    trainer = _trainer(tree, config_kw, batch, _strategy(at), lr, ckpt_dir)
    state = trainer.prepare()
    state, _ = trainer.step(state, batch)
    trainer.save(state)
    trainer.finalize()
    out = {"rank": rank, "saved": gathered(trainer.accelerated, state),
           "mesh": dict(trainer.accelerated.layout.sizes)}
    other = _trainer(tree, config_kw, batch, _strategy(to), lr, ckpt_dir)
    restored = other.prepare()
    out["restored"] = gathered(other.accelerated, restored)
    out["step"] = restored.step
    other.finalize()
    return out


def _meta_count(config_kw, batch, kind="llama"):
    """The meta-device count of a seq = 2 rank's step: the kernels'
    FLOPs and calls, the exchanges' bytes by kind."""
    ranks = dist.get_world_size()
    family, config = _model(kind, config_kw)
    result = accelerate(
        family.make_init_fn(config), family.make_loss_fn(config),
        _adamw(1e-3), batch,
        strategy=Strategy(mesh=MeshPlan(data=1, seq=ranks), rule_set=kind),
        device="cpu")
    counter = count_step(result, example_batch=batch)
    return {"kernels": {k: dict(v) for k, v in counter.kernels.items()},
            "collective": dict(counter.collective_bytes)}


def two_ranks(runs, lr, tree, config_kw, batch, ckpt_dir, meta_kw,
              glm_batch):
    """The runs at (1, 1, 2), the checkpoint from (1, 1, 2) to (2, 1, 1)
    and the meta-device count of a seq = 2 rank's step, on two ranks."""
    rank, ranks, _ = _join()
    out = {"rank": rank, "runs": _runs(runs, lr, ranks)}
    out["checkpoint"] = _checkpoint(tree, config_kw, batch, lr, ckpt_dir,
                                    (1, 1, 2), (2, 1, 1))
    out["meta"] = _meta_count(meta_kw, batch)
    out["meta_glm"] = _meta_count(meta_kw, glm_batch, "glm")
    dist.destroy_process_group()
    return out


def four_ranks(runs, lr, tree, config_kw, batches, ckpt_dir):
    """The runs at (2, 1, 2) and (1, 2, 2), MeshPlan(data=2, seq=2)'s
    groups, a checkpoint from (1, 2, 2) (fsdp blocks with seq replicas)
    to (2, 2, 1), then the change of world (2, 1, 2) -> (1, 1, 2), on
    four ranks."""
    rank, ranks, _ = _join()
    out = {"rank": rank, "runs": _runs(runs, lr, ranks)}
    out["groups"] = _groups(ranks)
    out["checkpoint"] = _checkpoint(tree, config_kw, batches[0], lr,
                                    ckpt_dir, (1, 2, 2), (2, 2, 1))
    out["world_change"] = _world_change(tree, config_kw, batches, lr)
    if dist.is_initialized():
        dist.destroy_process_group()
    return out


def example_ranks(argv):
    """``dlrover_tpu_torch.examples.train_llama`` on this rank (the
    example joins the group from the worker environment): its final
    step, its losses and the mesh it trained on."""
    from dlrover_tpu_torch.examples import train_llama
    from dlrover_tpu_torch.trainer.executor import TrainHook

    seen = {"losses": []}

    class Spy(TrainHook):
        def begin(self, executor):
            seen["trainer"] = executor._trainer

        def after_step(self, step, metrics):
            seen["losses"].append(float(np.mean(np.asarray(
                metrics["loss"]))))

        def end(self, executor):
            seen["mesh"] = dict(seen.pop("trainer").accelerated.mesh.sizes)

    out = train_llama.main(argv, hooks=[Spy()])
    return {"step": out["step"], **seen}
