"""In-process recovery in the port (the live half of the reference's
fault tolerance): the cache of built steps, ``retune`` and ``prewarm``,
the executor's boundary requests, the failover monitor's routing, and a
change of world from four gloo ranks to two, dense and ``moe_ep``, held
bit for bit against a cold trainer restored from the same snapshot and
within 1e-4 relative against the JAX package's ``live_reshard`` from
four CPU devices to two.

Everything runs on the CPU in f32. The world changes run in spawned
processes (``trainer.run.run_local``, each bounded by its own timeout;
the rank functions are in ``tests/torch_recovery_workers.py``), one
spawn of four ranks per fixture.
"""

import time

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxTrainer
from dlrover_tpu.trainer.failover import (
    classify_recovery as jax_classify_recovery,
)
from dlrover_tpu_torch.checkpoint import CheckpointInterval
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.examples import train_llama as example
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.telemetry import EventKind, get_registry, names
from dlrover_tpu_torch.telemetry import events as events_mod
from dlrover_tpu_torch.trainer import elastic as elastic_mod
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook
from dlrover_tpu_torch.trainer.failover import (
    RecoveryDecision,
    TrainingFailover,
    classify_recovery,
)
from dlrover_tpu_torch.trainer.run import run_local

import torch_recovery_workers as workers

P, TIMEOUT, LR = 4, 240, 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


CFG = llama.llama_tiny()


def _batches(n, seed=0):
    gen = example.synthetic_batches(CFG.vocab_size, 2, 8, seed=seed)()
    return [next(gen) for _ in range(n)]


def _trainer(batch, **kwargs):
    return ElasticTrainer(llama.make_init_fn(CFG), llama.make_loss_fn(CFG),
                          example.adamw(), batch, device="cpu", **kwargs)


class Recorder(TrainHook):
    def __init__(self):
        self.losses = {}

    def after_step(self, step, metrics):
        assert step not in self.losses, f"step {step} materialized twice"
        self.losses[step] = float(metrics["loss"])


class At(TrainHook):
    """Calls ``fn(executor)`` once, just before step ``step``."""

    def __init__(self, step, fn):
        self.step, self.fn, self.executor = step, fn, None

    def begin(self, executor):
        self.executor = executor

    def before_step(self, step):
        if step == self.step and self.fn is not None:
            fn, self.fn = self.fn, None
            fn(self.executor)


def _run(batches, hooks=(), window=2, **trainer_kw):
    """TrainExecutor over one iterator of ``batches`` (it resumes where
    it stopped after each applied request)."""
    trainer = _trainer(batches[0], **trainer_kw)
    rec = Recorder()
    source = iter(batches)
    executor = TrainExecutor(
        trainer, train_iter_fn=lambda: source, hooks=[rec, *hooks],
        conf=Configuration({"train_steps": len(batches),
                            "log_every_steps": 0, "train_window": window,
                            "preemption_grace": False}))
    out = executor.train_and_evaluate()
    return out, trainer, executor, rec


def _same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params),
                                                 tree_leaves(b.params)))


@pytest.fixture(scope="module")
def sync_run():
    """The synchronous K = 1 reference: 12 steps, window 0."""
    batches = _batches(12)
    out, _, executor, rec = _run(batches, window=0)
    assert out["step"] == 12
    return batches, rec.losses, executor.state


# -- the cache of built steps, retune, prewarm -------------------------------


class TestProgramCache:
    def test_return_to_a_knob_set_builds_nothing(self):
        """K 1 -> 4 -> 1: the return is a cache hit (no build, the same
        built step), and the step trains on."""
        batches = _batches(3)
        trainer = _trainer(batches[0])
        state = trainer.prepare()
        first = trainer.accelerated
        state, _ = trainer.step(state, batches[0])
        assert trainer.compile_count == 1
        state = trainer.retune(state, steps_per_call=4)
        assert trainer.compile_count == 2
        assert trainer.accelerated.train_step_multi is not None
        hits = get_registry().get(names.PROGRAM_CACHE_HITS)
        hits = hits.value if hits else 0.0
        state = trainer.retune(state, steps_per_call=1)
        assert trainer.compile_count == 2
        assert trainer.accelerated is first
        assert get_registry().get(names.PROGRAM_CACHE_HITS).value == hits + 1
        assert trainer.last_reshard["recompiled"] == 0
        state, metrics = trainer.step(state, batches[1])
        assert state.step == 2 and bool(metrics["finite"])

    def test_live_reshard_records_its_time_and_events(self):
        """A same-world ``live_reshard``: the begin/done events (worlds,
        step, ``recompiled``), the counter and the histogram, and a new
        state at the snapshot's step; ``on_world_change`` emits none."""
        batches = _batches(2)
        trainer = _trainer(batches[0])
        state, _ = trainer.step(trainer.prepare(), batches[0])
        reg = get_registry()
        count = reg.get(names.LIVE_RESHARDS)
        count = count.value if count else 0.0
        events_mod._ring.clear()
        new = trainer.live_reshard(state, reason="test")
        kinds = [e for e in events_mod.recent_events()
                 if e["kind"].startswith("live_reshard")]
        assert [e["kind"] for e in kinds] == [
            EventKind.LIVE_RESHARD_BEGIN, EventKind.LIVE_RESHARD_DONE]
        assert kinds[0]["reason"] == "test"
        done = kinds[1]
        assert (done["world_from"], done["world_to"], done["step"],
                done["recompiled"]) == (1, 1, 1, 0)
        assert reg.get(names.LIVE_RESHARDS).value == count + 1
        assert reg.get(names.LIVE_RESHARD_TIME).count >= 1
        assert new is not state and new.step == 1 and state.params == {}
        events_mod._ring.clear()
        trainer.on_world_change(new)
        assert not [e for e in events_mod.recent_events()
                    if e["kind"].startswith("live_reshard")]

    def test_prewarm_builds_once_and_leaves_the_active_step(self):
        batches = _batches(2)
        trainer = _trainer(batches[0], dispatch_chunks=1)
        state = trainer.prepare()
        active, ctx = trainer.accelerated, get_context()
        assert trainer.prewarm(steps_per_call=4, dispatch_chunks=2,
                               moe_precision="fp8") is True
        count = trainer.compile_count
        assert count == 2
        assert trainer.prewarm(steps_per_call=4, dispatch_chunks=2,
                               moe_precision="fp8") is False
        assert trainer.compile_count == count
        assert trainer.accelerated is active
        assert (trainer.steps_per_call, trainer.dispatch_chunks,
                trainer.moe_precision) == (1, 1, "bf16")
        assert (ctx.dispatch_chunks, ctx.moe_precision) == (1, "bf16")
        # the throwaway step drew nothing from the trainer's rng stream
        # and left the state alone: the next step is the unprewarmed one
        state, metrics = trainer.step(state, batches[0])
        other = _trainer(batches[0], dispatch_chunks=1)
        ostate, ometrics = other.step(other.prepare(), batches[0])
        assert float(metrics["loss"]) == float(ometrics["loss"])
        assert _same_params(state, ostate)
        # the retune to the prewarmed knobs builds nothing
        state = trainer.retune(state, steps_per_call=4, dispatch_chunks=2,
                               moe_precision="fp8")
        assert trainer.compile_count == count
        assert (ctx.dispatch_chunks, ctx.moe_precision) == (2, "fp8")
        trainer.retune(state, dispatch_chunks=1, moe_precision="bf16",
                       steps_per_call=1)

    @pytest.mark.parametrize("where", ["build", "restore"])
    def test_failed_retune_puts_the_old_step_back(self, monkeypatch, where):
        """A retune that fails in the build, or in the restore after the
        old state was freed: the knobs, the built step and the state
        come back, and the error propagates."""
        batches = _batches(3)
        trainer = _trainer(batches[0])
        state = trainer.prepare()
        state, _ = trainer.step(state, batches[0])
        before = [p.detach().clone() for p in tree_leaves(state.params)]
        active = trainer.accelerated

        def broken(*args, **kwargs):
            raise RuntimeError("planted failure")

        if where == "build":
            monkeypatch.setattr(elastic_mod, "accelerate", broken)
        else:  # the first restore fails; the repair's succeeds
            restore = trainer._state_from_snapshot
            calls = []

            def once(snapshot):
                calls.append(1)
                return broken() if len(calls) == 1 else restore(snapshot)

            trainer._state_from_snapshot = once
        with pytest.raises(RuntimeError, match="planted failure"):
            trainer.retune(state, steps_per_call=4)
        if where == "restore":
            assert len(calls) == 2
        assert trainer.steps_per_call == 1
        assert trainer.accelerated is active
        assert all(torch.equal(a, b)
                   for a, b in zip(tree_leaves(state.params), before))
        state, metrics = trainer.step(state, batches[1])
        assert state.step == 2 and bool(metrics["finite"])

    def test_refusals_name_their_roadmap_items(self):
        batches = _batches(1)
        trainer = _trainer(batches[0])
        state = trainer.prepare()
        with pytest.raises(NotImplementedError, match="A15"):
            trainer.retune(state, mesh=MeshPlan(data=-1, tensor=2))
        # the seq axis is ported (A13): one rank cannot hold two seq
        # ranks, which the mesh's own arithmetic says, and the knobs stay
        with pytest.raises(ValueError, match="not divisible by fixed axes"):
            trainer.prewarm(mesh=MeshPlan(data=-1, seq=2))
        assert trainer._mesh_override is None
        # a world that does not exist yet has no group to build over
        with pytest.raises(ValueError, match="re-form the world first"):
            trainer.prewarm(devices=[0, 1])
        with pytest.raises(ValueError, match="not a subset"):
            trainer.snapshot(state, world_to=[0, 1])
        assert trainer.steps_per_call == 1 and trainer.compile_count == 1


class TestRetune:
    def test_retune_mid_run_keeps_every_bit(self, sync_run):
        """Four single steps, ``retune(steps_per_call=4)``, two fused
        calls: the losses and parameters of the synchronous run."""
        batches, want, want_state = sync_run
        trainer = _trainer(batches[0])
        state = trainer.prepare()
        losses = []
        for batch in batches[:4]:
            state, m = trainer.step(state, batch)
            losses.append(float(m["loss"]))
        state = trainer.retune(state, steps_per_call=4)
        for i in (4, 8):
            state, m = trainer.step_multi(state, batches[i:i + 4])
            losses += m["loss"].tolist()
        assert losses == [want[s] for s in range(1, 13)]
        assert state.step == 12 and _same_params(state, want_state)

    def test_executor_request_retune_at_a_boundary(self, sync_run):
        """``request_retune(steps_per_call=4, train_window=2)`` made
        before step 3 applies once the window drained: K = 4 from step
        5, the window 2, every step once and bit for bit."""
        batches, want, want_state = sync_run
        hook = At(3, lambda ex: ex.request_retune(steps_per_call=4,
                                                  train_window=2))
        out, trainer, executor, rec = _run(batches, hooks=[hook], window=1)
        assert out["step"] == 12
        assert trainer.steps_per_call == 4 and executor._train_window == 2
        assert rec.losses == want
        assert _same_params(executor.state, want_state)
        # K = 1, the prewarmed K = 4; the retune itself built nothing
        assert trainer.compile_count == 2


class TestExecutorRequests:
    def test_reshard_on_an_unchanged_world_is_skipped(self, sync_run):
        batches, want, _ = sync_run
        events_mod._ring.clear()
        hook = At(3, lambda ex: ex.request_live_reshard(None))
        out, trainer, _, rec = _run(batches[:6], hooks=[hook])
        assert out["step"] == 6 and sorted(rec.losses) == list(range(1, 7))
        assert trainer.compile_count == 1
        kinds = {e["kind"] for e in events_mod.recent_events()}
        assert EventKind.LIVE_RESHARD_BEGIN not in kinds

    def test_request_restart_rebuilds_at_the_boundary(self, sync_run):
        """``request_restart``: the window drains, ``on_world_change``
        restores the drained state into a new TrainState (a cache hit on
        the same world), no live-reshard events; every step once."""
        batches, want, want_state = sync_run
        events_mod._ring.clear()
        states = []
        hook = At(5, lambda ex: (states.append(ex.state),
                                 ex.request_restart()))
        out, trainer, executor, rec = _run(batches, hooks=[hook], window=3)
        assert out["step"] == 12 and rec.losses == want
        assert _same_params(executor.state, want_state)
        assert executor.state is not states[0]
        assert states[0].opt_state is None  # freed at the rebuild
        assert trainer.compile_count == 1
        assert trainer.last_reshard["world_to"] == 1
        kinds = {e["kind"] for e in events_mod.recent_events()}
        assert EventKind.LIVE_RESHARD_BEGIN not in kinds

    @pytest.mark.parametrize("offset", [0, 2])
    def test_nonfinite_at_an_in_window_offset_under_k(self, tmp_path,
                                                      offset, monkeypatch):
        """K = 2, window 4: a NaN ``offset`` steps deep in the window is
        seen late, rolls back through the checkpoint path (saves every
        2 steps) and the run goes on to a finite end."""
        monkeypatch.setenv("DLROVER_TPU_CKPT_HOST_STAGING", "0")
        base = llama.make_loss_fn(CFG)
        nan_step = 5 + offset
        calls = {"n": 0}

        def loss_fn(params, batch, rng):
            # the attribution capture runs the loss on the meta device
            # too: only the real steps count
            calls["n"] += batch["input_ids"].device.type != "meta"
            loss, aux = base(params, batch, rng)
            if calls["n"] == nan_step:
                loss = loss * float("nan")
            return loss, aux

        batches = _batches(12)
        trainer = ElasticTrainer(
            llama.make_init_fn(CFG), loss_fn, example.adamw(), batches[0],
            device="cpu", steps_per_call=2, ckpt_dir=str(tmp_path),
            ckpt_interval=CheckpointInterval(steps=2))
        source = iter(batches * 2)
        rec = Recorder()
        rec.after_step = lambda step, m: rec.losses.setdefault(
            step, []).append(float(m["loss"]))
        executor = TrainExecutor(
            trainer, train_iter_fn=lambda: source, hooks=[rec],
            conf=Configuration({"train_steps": 12, "log_every_steps": 0,
                                "check_finite_every_steps": 1,
                                "on_nonfinite": "rollback",
                                "train_window": 4,
                                "preemption_grace": False}))
        out = executor.train_and_evaluate()
        assert out["step"] == 12
        assert np.isnan(rec.losses[nan_step][0])
        assert all(np.isfinite(v[-1]) for v in rec.losses.values())
        assert executor._rollbacks == 1
        loss = trainer.accelerated.eval_step(
            executor.state, trainer.accelerated.shard_batch(batches[0]))
        assert np.isfinite(float(loss["loss"]))


# -- failover ------------------------------------------------------------------


class StubMaster:
    """What the failover monitor polls (the reference tests' stub)."""

    waiting = 0

    def query_ps_nodes(self):
        class _Nodes:
            nodes = []

        return _Nodes()

    def num_nodes_waiting(self):
        return self.waiting


class TestFailover:
    def test_decision_table_matches_the_reference(self):
        cases = [
            (EventKind.WORKER_FAILED, {}, RecoveryDecision.LIVE_RESHARD),
            (EventKind.SCALE_PLAN_APPLIED, {},
             RecoveryDecision.LIVE_RESHARD),
            (EventKind.WORKER_FAILED, {"self_affected": True},
             RecoveryDecision.PROCESS_RESTART),
            (EventKind.SCALE_PLAN_APPLIED, {"world_viable": False},
             RecoveryDecision.PROCESS_RESTART),
            (EventKind.WORKER_FAILED, {"host_healthy": False},
             RecoveryDecision.POD_RESTART),
            (EventKind.NONFINITE_STEP, {}, RecoveryDecision.PROCESS_RESTART),
            (EventKind.RDZV_JOIN, {"mttr_table": {
                "live_reshard": 9.0, "storage_restore": 3.0}},
             RecoveryDecision.PROCESS_RESTART),
            (EventKind.RDZV_JOIN, {"mttr_table": {
                "live_reshard": 1.0, "peer_rebuild": 3.0}},
             RecoveryDecision.LIVE_RESHARD),
        ]
        for kind, kw, want in cases:
            assert classify_recovery(kind, **kw) == want, (kind, kw)
            assert jax_classify_recovery(kind, **kw) == want

    def test_monitor_routes_a_survivable_change_to_reshard(self):
        master = StubMaster()
        fired = {"restart": 0, "reshard": 0}
        monitor = TrainingFailover(
            master,
            on_change=lambda: fired.__setitem__(
                "restart", fired["restart"] + 1),
            on_reshard=lambda: fired.__setitem__(
                "reshard", fired["reshard"] + 1),
            poll_interval=0.02)
        monitor.start()
        master.waiting = 2
        deadline = time.monotonic() + 10
        while not fired["reshard"] and time.monotonic() < deadline:
            time.sleep(0.02)
        monitor.stop()
        assert fired["reshard"] >= 1 and fired["restart"] == 0

    @pytest.mark.parametrize("live", [True, False])
    def test_executor_starts_the_monitor_with_a_master(self, live):
        """With a master client the executor's monitor turns a waiting
        node into ``request_live_reshard`` (``live_recovery`` on) or
        ``request_restart`` (off); the run finishes either way."""
        master = StubMaster()
        master.waiting = 1
        batches = _batches(4)
        trainer = _trainer(batches[0])
        executor = TrainExecutor(
            trainer, train_iter_fn=lambda: iter(batches),
            conf=Configuration({"train_steps": 4, "log_every_steps": 0,
                                "live_recovery": live,
                                "preemption_grace": False}),
            master_client=master)
        executor._failover._interval = 0.01
        executor._failover.start()
        deadline = time.monotonic() + 10
        while not (executor._reshard_requested
                   or executor._restart_requested) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        executor._failover.stop()
        assert executor._reshard_requested is live
        assert executor._restart_requested is not live
        assert executor.train_and_evaluate()["step"] == 4
        # the reshard is skipped (the world did not change); the restart
        # rebuilt through the cache
        assert trainer.compile_count == 1


# -- a change of world: four gloo ranks to two ---------------------------------


MOE_KW = dict(num_experts=8, moe_top_k=2, moe_dispatch="grouped_ep")
BEFORE = 3  # steps at four ranks; as many again at two


def _world_batches(config, n, seed):
    ids = np.random.RandomState(seed).randint(0, config.vocab_size,
                                              size=(n, 8, 17))
    return [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]


def _jax_live_reshard(jcfg, rule_set, batches, before):
    """The JAX package's trainer on four CPU devices, ``before`` steps,
    ``live_reshard`` onto two, the rest: its losses and initial tree."""
    trainer = JaxTrainer(
        jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
        optax.adam(LR), batches[0],
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=P, fsdp=1),
                             rule_set=rule_set),
        devices=jax.devices()[:P])
    state = trainer.prepare()
    tree = jax.device_get(state.params)
    losses = []
    for i, batch in enumerate(batches):
        if i == before:
            state = trainer.live_reshard(state, devices=jax.devices()[:2])
            assert trainer.accelerated.strategy.grad_accum_steps == 2
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    return tree, losses


@pytest.fixture(scope="module")
def moe_world():
    jcfg = jax_llama.llama_tiny(**MOE_KW)
    batches = _world_batches(jcfg, 2 * BEFORE, 0)
    tree, want = _jax_live_reshard(jcfg, "moe_ep", batches, BEFORE)
    got = run_local(workers.moe_reshard_ranks, P,
                    (tree, batches, MOE_KW, LR, BEFORE), timeout=TIMEOUT)
    return want, got


def _assert_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].tobytes() == b[key].tobytes(), key


class TestWorldChangeMoE:
    def test_ranks_two_and_three_leave_zero_and_one_go_on(self, moe_world):
        _, got = moe_world
        assert [r.get("left", False) for r in got] == [False, False, True,
                                                       True]
        for rank, r in enumerate(got[:2]):
            assert (r["rank_after"], r["world_after"]) == (rank, 2)
            assert r["step_after"] == BEFORE
            assert (r["accum_before"], r["accum_after"]) == (1, 2)
            assert r["reshard"]["world_from"] == P
            assert r["reshard"]["world_to"] == 2
            assert not r["kernels_loaded_again"]

    def test_live_path_equals_the_cold_path_bit_for_bit(self, moe_world):
        """The same snapshot restored into a trainer built for two ranks
        from scratch: every loss and every parameter and moment bit."""
        _, got = moe_world
        for r in got[:2]:
            assert r["live"] == r["cold"]
            _assert_bitwise(r["live_state"], r["cold_state"])

    def test_each_survivor_holds_its_slice_of_the_global_experts(
            self, moe_world):
        """Right after the change, survivor t's expert leaves (and their
        moments) are experts 4t..4t+3 of the four ranks' leaves before
        it, bit for bit; the replicated leaves are rank 0's."""
        _, got = moe_world
        expert = [k for k in got[0]["before"]
                  if "/experts/" in k and not k.endswith("/step")]
        assert len(expert) == 6  # up, down; param, exp_avg, exp_avg_sq
        for t, r in enumerate(got[:2]):
            for key, after in r["after"].items():
                if key in expert:
                    full = np.concatenate([g["before"][key] for g in got],
                                          axis=1)
                    want = full[:, 4 * t:4 * t + 4]
                else:
                    want = got[0]["before"][key]
                assert after.tobytes() == want.tobytes(), (t, key)

    def test_losses_match_the_jax_live_reshard(self, moe_world):
        """Every step before and after the change within 1e-4 relative
        of the JAX package's trainer resharded from four devices to
        two."""
        want, got = moe_world
        for r in got:
            np.testing.assert_allclose(r["losses"], want[:BEFORE],
                                       rtol=1e-4)
        for r in got[:2]:
            np.testing.assert_allclose(r["live"], want[BEFORE:], rtol=1e-4)


@pytest.fixture(scope="module")
def dense_world():
    jcfg = jax_llama.llama_tiny()
    batches = _world_batches(jcfg, 6, 1)
    # the executor's request before step 5 is applied after step 4
    tree, want = _jax_live_reshard(jcfg, "llama", batches, 4)
    got = run_local(workers.dense_executor_ranks, P,
                    (tree, batches, LR, 4, 2), timeout=TIMEOUT)
    return want, got


class TestWorldChangeDense:
    def test_executor_drains_reshards_and_finishes_every_step_once(
            self, dense_world):
        _, got = dense_world
        for r in got[2:]:
            assert r["result"] == {"step": 4, "left_world": True}
            assert sorted(r["seen"]) == [1, 2, 3, 4]
        for r in got[:2]:
            assert r["result"]["step"] == 6 and r["world_after"] == 2
            assert sorted(r["seen"]) == list(range(1, 7))
            assert r["snapshot_steps"] == [4]

    def test_live_path_equals_the_cold_path_bit_for_bit(self, dense_world):
        _, got = dense_world
        for r in got[:2]:
            assert [r["seen"][s] for s in (5, 6)] == r["cold"]
            _assert_bitwise(r["state"], r["cold_state"])

    def test_losses_match_the_jax_live_reshard(self, dense_world):
        want, got = dense_world
        for r in got:
            seen = [r["seen"][s] for s in sorted(r["seen"])]
            np.testing.assert_allclose(seen, want[:len(seen)], rtol=1e-4)
