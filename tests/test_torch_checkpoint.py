"""Checkpoint and restore in the port against the JAX package.

The manager, the host snapshot, the trainer's restore and save cadence
and the executor's rollback, final save and preemption drain, each case
mirroring one of the reference's own tests
(``tests/test_checkpoint_trainer.py``, ``tests/test_executor.py``), on
a small MLP and tiny Llama on the CPU. A checkpoint of the JAX package
(Orbax, through its own manager) is converted by ``interop`` and resumes
the port onto the reference's trajectory; an expert-parallel state
written at four gloo ranks loads at two and at one.

Within the port every comparison is bit for bit (same inputs, same
arithmetic). Against optax: Adam's moments and count exactly after the
conversion, and the losses of three further steps within the tolerance
of ``test_torch_train.py::TestAdamW::test_steps_match_optax`` (1e-7
absolute, 1e-6 relative).
"""

import functools
import glob
import os
import shutil
import signal
import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.checkpoint import CheckpointInterval as JaxInterval
from dlrover_tpu.checkpoint import ElasticCheckpointManager as JaxManager
from dlrover_tpu.checkpoint import abstract_like
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import mesh as jax_mesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxTrainer
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.checkpoint import (
    CheckpointInterval,
    ElasticCheckpointManager,
    HostSnapshot,
)
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.examples import train_llama as example
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import mesh
from dlrover_tpu_torch.parallel.accelerate import _named_leaves, accelerate
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.telemetry import get_registry, names
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import (
    NonFiniteLossError,
    TrainExecutor,
    TrainHook,
)
from dlrover_tpu_torch.trainer.run import run_local

import torch_ep_workers as workers


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    """f32 on one CPU thread; trainers stage no mirror into /dev/shm
    (the manager tests pass a staging directory of their own)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(get_context(), "ckpt_host_staging", False)
    yield
    torch.set_num_threads(threads)


def _mlp_init(gen):
    return {"w1": torch.randn(16, 32, generator=gen) * 0.1,
            "w2": torch.randn(32, 8, generator=gen) * 0.1}


def _mlp_loss(params, batch, rng):
    h = torch.tanh(batch["x"] @ params["w1"])
    loss = ((h @ params["w2"] - batch["y"]) ** 2).mean()
    if rng is not None:
        # a draw from the trainer's rng stream, as an MoE's jitter makes
        loss = loss * (1.0 + 1e-3 * torch.rand((), generator=rng))
    return loss, {}


def _batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 16)).astype(np.float32),
            "y": rng.normal(size=(n, 8)).astype(np.float32)}


ADAMW = functools.partial(torch.optim.AdamW, lr=1e-2, weight_decay=0.1)


def _build():
    return accelerate(_mlp_init, _mlp_loss, ADAMW, _batch(), device="cpu")


def _trained(result, steps=2):
    state = result.init_fn(0)
    for i in range(steps):
        result.train_step(state, result.shard_batch(_batch(seed=i)))
    return state


def _trainer(ckpt_dir="", loss_fn=_mlp_loss, interval=None):
    return ElasticTrainer(_mlp_init, loss_fn, ADAMW, _batch(),
                          ckpt_dir=ckpt_dir, ckpt_interval=interval,
                          device="cpu")


def _tensors(state):
    """name -> a copy of every parameter and optimizer slot tensor."""
    out = {}
    for path, p in _named_leaves(state.params):
        out[f"params/{path}"] = p.detach().clone()
        for key, v in state.opt_state.state.get(p, {}).items():
            out[f"opt/{path}/{key}"] = v.clone()
    return out


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name


class TestCheckpointInterval:
    @pytest.mark.parametrize("steps", [1, 2, 3, 10])
    def test_cadence_matches_the_reference(self, steps):
        ours, theirs = CheckpointInterval(steps=steps), JaxInterval(
            steps=steps)
        for step in range(1, 40):
            due = ours.should_save(step)
            assert due == theirs.should_save(step), step
            if due:
                ours.mark_saved(step)
                theirs.mark_saved(step)


class TestElasticCheckpoint:
    @pytest.mark.parametrize("async_save", [False, True])
    def test_save_restore_roundtrip(self, tmp_path, async_save):
        """Params, both moments, the optimizer's step and the meta come
        back bit for bit into another state."""
        res = _build()
        state = _trained(res)
        want = _tensors(state)
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=async_save)
        assert mgr.save(2, state, metadata={"k": 1}, force=True)
        mgr.wait()
        other = res.init_fn(7)
        out = mgr.restore(other)
        assert out["step"] == 2 and other.step == 2
        assert out["state"] is other and out["meta"]["k"] == 1
        assert out["source"] == "primary"
        _assert_same(_tensors(other), want)
        # the optimizer steps the restored tensors
        p = other.params["w1"]
        assert set(other.opt_state.state[p]) == {"step", "exp_avg",
                                                 "exp_avg_sq"}
        assert other.opt_state.state[p]["step"].device.type == "cpu"
        mgr.close()

    def test_async_save_then_step_restores_the_saved_step(self, tmp_path):
        """The step that follows an async save at once updates the live
        tensors in place; the checkpoint holds the saved step."""
        res = _build()
        state = _trained(res)
        want = _tensors(state)
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=True)
        assert mgr.save(2, state, force=True)
        for i in range(3):
            res.train_step(state, res.shard_batch(_batch(seed=10 + i)))
        mgr.wait()
        assert not torch.equal(state.params["w1"], want["params/w1"])
        other = res.init_fn(0)
        mgr.restore(other)
        _assert_same(_tensors(other), want)
        mgr.close()

    def test_restore_keeps_the_optimizer_on_the_live_tensors(self,
                                                             tmp_path):
        """A restore into a trained state fills its tensors in place:
        the optimizer's parameters and slots are the same objects, and a
        step after the restore equals a step from the saved state."""
        res = _build()
        state = _trained(res)
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        mgr.save(2, state, force=True)
        reference = res.init_fn(0)
        mgr.restore(reference)
        res.train_step(reference, res.shard_batch(_batch(seed=5)))
        ids = [id(p) for p in state.opt_state.param_groups[0]["params"]]
        slots = {id(v) for s in state.opt_state.state.values()
                 for v in s.values()}
        for i in range(3):
            res.train_step(state, res.shard_batch(_batch(seed=20 + i)))
        mgr.restore(state)
        assert [id(p) for p in state.opt_state.param_groups[0]["params"]] \
            == ids
        assert {id(v) for s in state.opt_state.state.values()
                for v in s.values()} == slots
        res.train_step(state, res.shard_batch(_batch(seed=5)))
        _assert_same(_tensors(state), _tensors(reference))
        mgr.close()

    def test_keyed_by_parameter_path(self, tmp_path):
        """A checkpoint loads into a state whose optimizer lists the
        parameters in another order."""
        res = _build()
        state = _trained(res)
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        mgr.save(2, state, force=True)
        other = res.init_fn(3)
        other.opt_state = ADAMW([other.params["w2"], other.params["w1"]])
        mgr.restore(other)
        _assert_same(_tensors(other), _tensors(state))
        mgr.close()

    def test_structure_mismatch_raises(self, tmp_path):
        res = _build()
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        mgr.save(2, _trained(res), force=True)
        other = accelerate(
            lambda gen: {"w1": torch.zeros(16, 16), "w2": torch.zeros(16, 8)},
            _mlp_loss, ADAMW, _batch(), device="cpu").init_fn(0)
        with pytest.raises(ValueError, match="w1"):
            mgr.restore(other, step=2)
        mgr.close()

    def test_max_to_keep_and_no_second_write(self, tmp_path):
        res = _build()
        state = _trained(res)
        mgr = ElasticCheckpointManager(str(tmp_path), max_to_keep=2,
                                       async_save=False)
        for step in (1, 2, 3):
            assert mgr.save(step, state, force=True)
        assert mgr.all_steps() == [2, 3]
        assert not mgr.save(3, state, force=True)  # already saved
        assert not mgr.save(2, state)  # at or below the newest
        mgr.close()

    def test_crash_mid_save_leaves_the_previous_step_newest(self,
                                                            tmp_path):
        """A step is visible only once renamed; a crash's leftover tmp
        dir is not a step, and the next manager reclaims it."""
        res = _build()
        state = _trained(res)
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        mgr.save(2, state, force=True)
        mgr.close()
        torn = tmp_path / ".tmp_3"
        torn.mkdir()
        (torn / "__0_0.distcp").write_bytes(b"partial")
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        assert mgr.latest_step() == 2 and not torn.exists()
        assert mgr.restore(res.init_fn(0))["step"] == 2
        mgr.close()

    def test_shard_checkpoint_rides_along(self, tmp_path):
        res = _build()
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        mgr.save(0, res.init_fn(0), shard_checkpoint='{"todo": [[0, 64]]}',
                 force=True)
        out = mgr.restore(res.init_fn(1))
        assert out["shard_checkpoint"] == '{"todo": [[0, 64]]}'
        mgr.close()

    def test_failed_async_save_raises_at_wait(self, tmp_path):
        res = _build()
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=True)
        state = _trained(res)

        def broken(*args):
            raise OSError("disk full")

        mgr._write = broken
        assert mgr.save(2, state, force=True)
        with pytest.raises(OSError, match="disk full"):
            mgr.wait()
        assert mgr.latest_step() is None
        mgr.close()

    def test_corrupt_newest_step_falls_back_and_is_quarantined(
            self, tmp_path):
        res = _build()
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        state = _trained(res, steps=1)
        mgr.save(1, state, force=True)
        want = _tensors(state)
        res.train_step(state, res.shard_batch(_batch(seed=3)))
        mgr.save(2, state, force=True)
        for path in glob.glob(str(tmp_path / "2" / "*.distcp")):
            with open(path, "r+b") as f:
                f.truncate(64)
        other = res.init_fn(0)
        out = mgr.restore(other)
        assert out["step"] == 1
        _assert_same(_tensors(other), want)
        assert mgr.latest_step() == 1
        assert glob.glob(str(tmp_path / "corrupt-2-*"))
        # an explicit step does not fall back
        mgr.save(2, state, force=True)
        for path in glob.glob(str(tmp_path / "2" / "*.distcp")):
            with open(path, "r+b") as f:
                f.truncate(64)
        with pytest.raises(Exception):
            mgr.restore(res.init_fn(0), step=2)
        mgr.close()

    def test_host_dram_staging_mirror_and_restore(self, tmp_path):
        """After the save commits the step is mirrored to the staging
        dir (only the newest kept), and restore prefers it even when
        the primary step dir is gone."""
        res = _build()
        state = _trained(res, steps=1)
        primary, staging = tmp_path / "primary", tmp_path / "shm"
        mgr = ElasticCheckpointManager(str(primary), staging_dir=str(staging))
        assert mgr.save(3, state, metadata={"k": 7}, force=True)
        mgr.wait()
        assert mgr.staged_step() == 3
        res.train_step(state, res.shard_batch(_batch(seed=4)))
        want = _tensors(state)
        assert mgr.save(5, state, force=True)
        mgr.wait()
        assert mgr.staged_step() == 5
        assert not os.path.isdir(str(staging / "3"))
        shutil.rmtree(str(primary / "5"))
        other = res.init_fn(0)
        out = mgr.restore(other, step=5)
        assert out["step"] == 5 and out["source"] == "staging"
        _assert_same(_tensors(other), want)
        mgr.close()

    def test_restore_from_staging_fast_path(self, tmp_path):
        res = _build()
        state = _trained(res)
        mgr = ElasticCheckpointManager(str(tmp_path / "primary"),
                                       staging_dir=str(tmp_path / "shm"))
        assert mgr.restore_from_staging(res.init_fn(0)) is None
        mgr.save(2, state, force=True)
        mgr.wait()
        other = res.init_fn(0)
        out = mgr.restore_from_staging(other)
        assert out["step"] == 2 and out["source"] == "staging"
        _assert_same(_tensors(other), _tensors(state))
        mgr.close()

    def test_stale_staging_from_previous_job_is_ignored(self, tmp_path):
        """A mirror left by a previous job at the same checkpoint path is
        never restored as the new job's weights."""
        res = _build()
        primary, staging = tmp_path / "primary", tmp_path / "shm"
        old_state = res.init_fn(0)
        m1 = ElasticCheckpointManager(str(primary), staging_dir=str(staging))
        assert m1.save(5, old_state, force=True)
        m1.wait()
        assert m1.staged_step() == 5
        m1.close()
        shutil.rmtree(str(primary))
        new_state = res.init_fn(42)
        m2 = ElasticCheckpointManager(str(primary), staging_dir=str(staging))
        assert m2.save(5, new_state, force=True)
        m2.wait()
        other = res.init_fn(1)
        m2.restore(other, step=5)
        assert torch.equal(other.params["w1"], new_state.params["w1"])
        assert not torch.equal(other.params["w1"], old_state.params["w1"])
        m2.close()

    def test_fresh_job_with_only_stale_staging_restores_nothing(
            self, tmp_path):
        res = _build()
        primary, staging = tmp_path / "primary", tmp_path / "shm"
        m1 = ElasticCheckpointManager(str(primary), staging_dir=str(staging))
        assert m1.save(7, res.init_fn(0), force=True)
        m1.wait()
        m1.close()
        shutil.rmtree(str(primary))
        m2 = ElasticCheckpointManager(str(primary), staging_dir=str(staging))
        assert m2.restore(res.init_fn(1)) is None
        m2.close()

    def test_wait_surfaces_mirror_timeout(self, tmp_path):
        """A mirror that never commits is reported by wait(), counted
        once, and only polled by later waits."""
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        before = get_registry().counter(names.CKPT_MIRROR_TIMEOUTS).value
        release = threading.Event()
        stuck = threading.Thread(target=release.wait, daemon=True,
                                 name="stuck-mirror")
        stuck.start()
        mgr._mirror_threads = [stuck]
        assert mgr.wait(mirror_timeout=0.05) is True
        assert mgr._mirror_threads == [stuck]
        t0 = time.monotonic()
        assert mgr.wait(mirror_timeout=60.0) is True
        assert time.monotonic() - t0 < 5.0
        assert get_registry().counter(
            names.CKPT_MIRROR_TIMEOUTS).value == before + 1
        release.set()
        stuck.join(timeout=5.0)
        assert not stuck.is_alive()
        assert mgr.wait(mirror_timeout=5.0) is False
        assert mgr._mirror_threads == []
        mgr.close()

    def test_superseded_step_mirror_stops_polling(self, tmp_path):
        mgr = ElasticCheckpointManager(
            str(tmp_path / "ckpt"), async_save=False,
            staging_dir=str(tmp_path / "shm"),
        )
        (tmp_path / "ckpt" / "5").mkdir()
        t0 = time.monotonic()
        mgr._wait_and_mirror(1, deadline_s=30.0)
        assert time.monotonic() - t0 < 5.0
        assert mgr.staged_step() != 1
        mgr.close()


class TestHostSnapshot:
    def test_snapshot_survives_a_step_and_restores(self):
        res = _build()
        state = _trained(res)
        want = _tensors(state)
        snap = HostSnapshot.take(state, note="x")
        assert snap.step == 2 and snap.meta == {"note": "x"}
        assert snap.nbytes() == sum(t.numel() * t.element_size()
                                    for t in want.values())
        res.train_step(state, res.shard_batch(_batch(seed=9)))
        _assert_same({k: v for k, v in snap.tree.items()}, want)
        stepped = _tensors(state)
        snap.restore(state)
        assert state.step == 2
        _assert_same(_tensors(state), want)
        # the optimizer steps the restored tensors: the same step again
        res.train_step(state, res.shard_batch(_batch(seed=9)))
        _assert_same(_tensors(state), stepped)

    def test_snapshot_of_a_fresh_state_empties_the_slots(self):
        res = _build()
        state = res.init_fn(0)
        snap = HostSnapshot.take(state)
        res.train_step(state, res.shard_batch(_batch()))
        snap.restore(state)
        assert state.step == 0 and not state.opt_state.state


class TestElasticTrainer:
    def test_train_and_resume(self, tmp_path):
        """A fresh trainer on the same ckpt_dir resumes: the state bit
        for bit, and the next steps equal the uninterrupted run's, the
        rng stream's draws included."""
        batches = [_batch()] * 8
        trainer = _trainer(str(tmp_path))
        state = trainer.prepare()
        losses = []
        for b in batches[:5]:
            state, metrics = trainer.step(state, b)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0]
        trainer.save(state)
        saved = _tensors(state)
        for b in batches[5:]:
            state, metrics = trainer.step(state, b)
            losses.append(float(metrics["loss"]))
        want = _tensors(state)
        trainer.finalize()

        trainer2 = _trainer(str(tmp_path))
        state2 = trainer2.prepare()
        assert state2.step == 5 and trainer2.latest_checkpoint_step() == 5
        _assert_same(_tensors(state2), saved)
        resumed = []
        for b in batches[5:]:
            state2, metrics = trainer2.step(state2, b)
            resumed.append(float(metrics["loss"]))
        assert resumed == losses[5:]
        _assert_same(_tensors(state2), want)
        trainer2.finalize()

    def test_meta_holds_strategy_rng_and_step(self, tmp_path):
        trainer = _trainer(str(tmp_path))
        state = trainer.prepare()
        state, _ = trainer.step(state, _batch())
        rng = trainer._rng.get_state()
        trainer.save(state)
        trainer.finalize()
        mgr = ElasticCheckpointManager(str(tmp_path), async_save=False)
        out = mgr.restore(_build().init_fn(0))
        meta = out["meta"]
        assert Strategy.from_json(meta["strategy"]) == \
            trainer.accelerated.strategy
        assert torch.equal(torch.tensor(meta["rng"], dtype=torch.uint8), rng)
        assert meta["host_step"] == 1
        mgr.close()

    def test_save_cadence_skips_a_nonfinite_state(self, tmp_path):
        calls = {"n": 0}

        def loss_fn(params, batch, rng):
            loss, aux = _mlp_loss(params, batch, rng)
            calls["n"] += 1
            return (loss * float("nan") if calls["n"] == 4 else loss), aux

        trainer = _trainer(str(tmp_path), loss_fn,
                           CheckpointInterval(steps=2))
        state = trainer.prepare()
        for i in range(4):
            state, _ = trainer.step(state, _batch(seed=i))
        assert trainer.latest_checkpoint_step() == 2
        trainer.finalize()

    def test_snapshot_meta_is_a_resume_point(self):
        """``restore_snapshot`` puts the state and the rng stream back:
        the next step is the same step again, bit for bit."""
        trainer = _trainer()
        state = trainer.prepare()
        state, _ = trainer.step(state, _batch())
        snap = trainer.snapshot(state)
        assert snap.meta["host_step"] == 1 and snap.step == 1
        assert torch.equal(torch.tensor(snap.meta["rng"], dtype=torch.uint8),
                           trainer._rng.get_state())
        state, first = trainer.step(state, _batch(seed=1))
        stepped = _tensors(state)
        trainer.restore_snapshot(state, snap)
        assert state.step == 1
        state, again = trainer.step(state, _batch(seed=1))
        assert float(again["loss"]) == float(first["loss"])
        _assert_same(_tensors(state), stepped)

    def test_no_checkpoint_dir_has_nothing_to_restore(self):
        trainer = _trainer()
        trainer.prepare()
        assert trainer.restore_state() is None
        assert trainer.latest_checkpoint_step() is None


class _Losses(TrainHook):
    def __init__(self):
        self.losses = {}

    def after_step(self, step, metrics):
        self.losses[step] = float(metrics["loss"])


def _planted_nan(at_calls):
    calls = {"n": 0}

    def loss_fn(params, batch, rng):
        loss, aux = _mlp_loss(params, batch, rng)
        # the attribution capture runs the loss on the meta device too:
        # only the real steps count
        calls["n"] += batch["x"].device.type != "meta"
        return (loss * float("nan") if calls["n"] in at_calls
                else loss), aux

    return loss_fn


class TestExecutor:
    def test_nonfinite_rollback_restores_and_continues(self, tmp_path):
        """A NaN at step 4 with a checkpoint at step 2: the executor
        restores step 2 onto the built trainer, the window is dropped,
        and the run ends finite at its step count, with the losses of
        an uninterrupted run from step 3 on (the rng stream included)."""
        batches = lambda: [_batch(seed=i) for i in range(6)]  # noqa: E731
        clean = _Losses()
        TrainExecutor(_trainer(str(tmp_path / "clean")), batches,
                      hooks=[clean], conf=Configuration({
                          "train_steps": 6})).train_and_evaluate()
        trainer = _trainer(str(tmp_path / "ckpt"), _planted_nan({4}),
                           CheckpointInterval(steps=2))
        before = get_registry().counter(names.NONFINITE_ROLLBACKS).value
        rec = _Losses()
        executor = TrainExecutor(trainer, batches, hooks=[rec],
                                 conf=Configuration({
                                     "train_steps": 6,
                                     "check_finite_every_steps": 1,
                                     "train_window": 2,
                                     "on_nonfinite": "rollback"}))
        out = executor.train_and_evaluate()
        assert out["step"] == 6 and executor.state.step == 6
        assert get_registry().counter(
            names.NONFINITE_ROLLBACKS).value == before + 1
        # after the rollback to step 2 the fresh iterator replays from
        # its first batch: steps 3-6 see batches 0-3
        assert np.isfinite(list(rec.losses.values())).all()
        assert ElasticCheckpointManager(
            str(tmp_path / "ckpt"), async_save=False).latest_step() == 6
        replay = _trainer(str(tmp_path / "replay"))
        state = replay.prepare()
        for i in (0, 1, 0, 1, 2, 3):
            state, metrics = replay.step(state, _batch(seed=i))
        _assert_same(_tensors(executor.state), _tensors(state))
        assert rec.losses[6] == float(metrics["loss"])
        assert clean.losses[1] == rec.losses[1]

    def test_nonfinite_persistent_rollback_budget_halts(self, tmp_path):
        executor = TrainExecutor(
            _trainer(str(tmp_path), _planted_nan(set(range(2, 100, 2))),
                     CheckpointInterval(steps=1)),
            lambda: [_batch()] * 8,
            conf=Configuration({"train_steps": 100,
                                "check_finite_every_steps": 1,
                                "on_nonfinite": "rollback",
                                "max_nonfinite_rollbacks": 2}))
        with pytest.raises(NonFiniteLossError, match="rollbacks"):
            executor.train_and_evaluate()

    def test_final_save_is_forced_and_skips_a_nonfinite_state(self,
                                                              tmp_path):
        trainer = _trainer(str(tmp_path / "a"))
        TrainExecutor(trainer, lambda: [_batch()] * 3, conf=Configuration(
            {"train_steps": 3})).train_and_evaluate()
        assert ElasticCheckpointManager(
            str(tmp_path / "a"), async_save=False).latest_step() == 3
        trainer = _trainer(str(tmp_path / "b"), _planted_nan({3}))
        TrainExecutor(trainer, lambda: [_batch()] * 3, conf=Configuration(
            {"train_steps": 3, "on_nonfinite": "ignore",
             "check_finite_every_steps": 0})).train_and_evaluate()
        assert ElasticCheckpointManager(
            str(tmp_path / "b"), async_save=False).latest_step() is None

    def test_preemption_drains_window_saves_materialized_step(
            self, tmp_path):
        """A preemption notice with steps in flight drains the window
        first: the emergency checkpoint lands at the last materialized
        step, and a resumed run's remaining losses equal the
        uninterrupted synchronous run's bit for bit."""
        stream = lambda: [_batch(seed=i % 7) for i in range(200)]  # noqa
        sync = _Losses()
        TrainExecutor(_trainer(), stream, hooks=[sync], conf=Configuration(
            {"train_steps": 20, "train_window": 0})).train_and_evaluate()

        class PreemptAt(TrainHook):
            def before_step(self, step):
                if step == 11:  # at dispatch: the window is not empty
                    executor._preempted = signal.SIGTERM

        trainer = _trainer(str(tmp_path))
        rec = _Losses()
        executor = TrainExecutor(trainer, stream, hooks=[rec, PreemptAt()],
                                 conf=Configuration({"train_steps": 20,
                                                     "train_window": 4}))
        before = get_registry().counter(names.PREEMPT_NOTICES).value
        out = executor.train_and_evaluate()
        assert out["preempted"] is True and out["mirror_timed_out"] is False
        killed = out["step"]
        assert killed == 11
        assert sorted(rec.losses) == list(range(1, killed + 1))
        assert get_registry().counter(
            names.PREEMPT_NOTICES).value == before + 1
        assert ElasticCheckpointManager(
            str(tmp_path), async_save=False).latest_step() == killed

        rec2 = _Losses()
        # the resumed run takes the stream from where the killed one was
        TrainExecutor(_trainer(str(tmp_path)),
                      lambda: stream()[killed:], hooks=[rec2],
                      conf=Configuration({"train_steps": 20})
                      ).train_and_evaluate()
        assert sorted(rec2.losses) == list(range(killed + 1, 21))
        for step in range(1, 21):
            got = rec.losses.get(step, rec2.losses.get(step))
            assert got == sync.losses[step], step

    def test_sigterm_sets_the_notice_and_rearms(self):
        """The installed handler turns SIGTERM into a notice and puts
        the previous disposition back."""
        executor = TrainExecutor(_trainer(), lambda: [])
        previous = signal.getsignal(signal.SIGTERM)
        executor.install_preemption_handler()
        handler = signal.getsignal(signal.SIGTERM)
        assert handler is not previous, "not installed on the main thread"
        try:
            signal.raise_signal(signal.SIGTERM)
        finally:
            executor._restore_signal_dispositions()
        assert executor._preempted == signal.SIGTERM
        assert signal.getsignal(signal.SIGTERM) is previous


class TestJaxParity:
    STEPS = 3

    def _reference(self, tmp_path):
        jcfg = jax_llama.llama_tiny()
        batches = example.synthetic_batches(jcfg.vocab_size, 4, 32)()
        batches = [next(batches) for _ in range(2 * self.STEPS)]
        jtrainer = JaxTrainer(
            jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
            optax.adamw(3e-4, weight_decay=0.1), batches[0],
            strategy=JaxStrategy(mesh=jax_mesh.single_device_plan(),
                                 rule_set="llama", remat_policy=""),
            devices=[jax.devices()[0]],
        )
        state = jtrainer.prepare()
        for b in batches[:self.STEPS]:
            state, _ = jtrainer.step(state, b)
        mgr = JaxManager(str(tmp_path / "orbax"), async_save=False,
                         staging_dir=str(tmp_path / "orbax_shm"))
        assert mgr.save(self.STEPS, state, force=True)
        mgr.wait()
        out = mgr.restore(abstract_like(state,
                                        jtrainer.accelerated.state_sharding))
        mgr.close()
        return jtrainer, out["state"], batches

    def test_orbax_checkpoint_resumes_in_the_port(self, tmp_path):
        jtrainer, jstate, batches = self._reference(tmp_path)
        host = jax.device_get(jstate)
        state = interop.train_state_from_numpy(host, example.adamw(),
                                               device="cpu")
        assert state.step == self.STEPS
        ours = interop.train_state_to_numpy(state)
        adam = host.opt_state[0]
        assert ours["count"] == int(adam.count) == self.STEPS
        for key, want in (("mu", adam.mu), ("nu", adam.nu),
                          ("params", host.params)):
            for (path, a), (_, b) in zip(
                    _named_leaves(ours[key]), _named_leaves(want)):
                np.testing.assert_array_equal(a, np.asarray(b), path)

        cfg, _ = example.preset_config("tiny")
        trainer = ElasticTrainer(
            lambda gen: None, llama.make_loss_fn(cfg), example.adamw(),
            batches[0], strategy=Strategy(mesh=mesh.single_device_plan(),
                                          rule_set="llama", remat_policy=""),
            device="cpu")
        state = trainer.prepare(state)
        want, got = [], []
        for b in batches[self.STEPS:]:
            jstate, jm = jtrainer.step(jstate, b)
            state, m = trainer.step(state, b)
            want.append(float(jm["loss"]))
            got.append(float(m["loss"]))
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
        for (path, a), (_, b) in zip(
                _named_leaves(interop.params_to_numpy(state.params)),
                _named_leaves(jax.device_get(jstate.params))):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-7,
                                       rtol=1e-6, err_msg=path)

    def test_port_state_round_trips_through_interop(self):
        res = _build()
        state = _trained(res)
        ours = interop.train_state_to_numpy(state)
        fake = type("Ref", (), {})()
        fake.step, fake.params = ours["step"], ours["params"]
        fake.opt_state = (type("Adam", (), {"count": np.int32(ours["count"]),
                                            "mu": ours["mu"],
                                            "nu": ours["nu"]})(), (), ())
        back = interop.train_state_from_numpy(fake, ADAMW, device="cpu")
        _assert_same(_tensors(back), _tensors(state))


class TestExpertParallel:
    KW = dict(num_experts=8, moe_top_k=2, moe_dispatch="grouped_ep")

    def test_moe_ep_checkpoint_loads_at_two_ranks_and_one(self, tmp_path,
                                                          monkeypatch):
        """Written by four gloo ranks (two experts each), the checkpoint
        holds the global expert leaves: two ranks and one restore them
        (each rank its block), moments too, and train on."""
        monkeypatch.setenv("DLROVER_TPU_CKPT_HOST_STAGING", "0")
        cfg = llama.llama_tiny(**self.KW)
        ids = np.random.RandomState(0).randint(0, cfg.vocab_size,
                                               size=(4, 17))
        batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
        ckpt = str(tmp_path)
        saved = run_local(workers.checkpoint_ranks, 4,
                          (ckpt, self.KW, batch, True), timeout=240)
        assert all(r["prepared"]["step"] == 0 and r["finite"]
                   for r in saved)

        for ranks in (2, 1):
            got = run_local(workers.checkpoint_ranks, ranks,
                            (ckpt, self.KW, batch, False), timeout=240)
            for r in got:
                assert r["prepared"]["step"] == 1 and r["finite"]
                np.testing.assert_array_equal(r["prepared"]["embed"],
                                              saved[0]["stepped"]["embed"])
            for key in ("up", "down", "up_exp_avg", "down_exp_avg"):
                np.testing.assert_array_equal(
                    np.concatenate([r["prepared"][key] for r in got],
                                   axis=1),
                    np.concatenate([r["stepped"][key] for r in saved],
                                   axis=1),
                    err_msg=f"{ranks} ranks: {key}")


class TestExample:
    def test_ckpt_dir_resumes(self, tmp_path):
        """``--ckpt_dir``: the run saves its last step, and a second run
        on the directory resumes there and trains the remaining steps."""
        argv = ["--preset", "tiny", "--batch", "2", "--seq", "16",
                "--device", "cpu", "--ckpt_dir", str(tmp_path)]
        first = _Losses()
        assert example.main(argv + ["--steps", "3"],
                            hooks=[first])["step"] == 3
        assert sorted(first.losses) == [1, 2, 3]
        second = _Losses()
        assert example.main(argv + ["--steps", "5"],
                            hooks=[second])["step"] == 5
        assert sorted(second.losses) == [4, 5]
        assert ElasticCheckpointManager(
            str(tmp_path), async_save=False).latest_step() == 5
