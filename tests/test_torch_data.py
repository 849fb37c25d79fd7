"""The port's data path against the JAX package's: the elastic sampler
(index streams equal, as a hypothesis property, and after a state taken
at 2 shards is loaded at 1), the loader (equal batches, a sharding
client's ``record_indices``, ``set_batch_size``, the padded last batch),
``DevicePreloader`` on the CPU (foreground and background, K-stacking,
``put_fn``, re-entry, a pump error, the ``global_rows`` check, its
instruments, ``close``), the executor's input wait (the reference's
semantics, ``tests/test_data_plane.py``), and a 2-rank gloo trajectory
fed by the port's loader against the reference's on a 2-device JAX CPU
mesh fed by its loader, with one and two microbatches a step.

Index streams and batches are integer work: equal, not close. The
trajectory is f32: losses within 1e-5 relative.
"""

import threading
import time

import jax
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer import data as ref
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel.accelerate import PlacedBatch, accelerate
from dlrover_tpu_torch.telemetry import EventKind, names as tm
from dlrover_tpu_torch.telemetry.events import recent_events
from dlrover_tpu_torch.telemetry.metrics import process_registry
from dlrover_tpu_torch.trainer import data as port
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor
from dlrover_tpu_torch.trainer.run import run_local

import torch_data_workers as workers

TIMEOUT = 300  # seconds the 2-rank runs may take


@pytest.fixture(autouse=True)
def _telemetry_on():
    ctx = get_context()
    prev = ctx.telemetry_enabled
    ctx.telemetry_enabled = True
    yield
    ctx.telemetry_enabled = prev


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want):
    """Equal trees of arrays (tensors, numpy or JAX arrays), bit for bit."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        return
    g, w = _host(got), _host(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


# -- the sampler -----------------------------------------------------------


def _samplers(size, shards, rank, shuffle, seed, drop_last):
    return [m.ElasticDistributedSampler(size, shards, rank, shuffle, seed,
                                        drop_last) for m in (port, ref)]


class TestSampler:
    @settings(max_examples=200, deadline=None)
    @given(data=st.data(), size=st.integers(0, 60),
           shards=st.integers(1, 6), shuffle=st.booleans(),
           seed=st.integers(0, 2**31), drop_last=st.booleans(),
           epoch=st.integers(0, 3))
    def test_index_streams_equal(self, data, size, shards, shuffle, seed,
                                 drop_last, epoch):
        rank = data.draw(st.integers(0, shards - 1))
        completed = data.draw(st.integers(0, size))
        ours, theirs = _samplers(size, shards, rank, shuffle, seed,
                                 drop_last)
        for s in (ours, theirs):
            s.set_epoch(epoch)
            s.completed_num = completed
        got, want = list(ours), list(theirs)
        assert got == want
        assert len(ours) == len(theirs)
        assert all(isinstance(i, int) for i in got)
        if not drop_last and size > completed:
            # every shard yields the same count, or the ranks fall out of
            # step near the epoch's end
            assert len(got) == -(-(size - completed) // shards)

    @pytest.mark.parametrize("shuffle", [False, True])
    @pytest.mark.parametrize("drop_last", [False, True])
    def test_state_taken_at_two_shards_loads_at_one(self, shuffle,
                                                    drop_last):
        """Both ranks of a 2-shard world consume 3 global batches of 4;
        the state one of them saves, loaded into a 1-shard sampler,
        resumes at the same index in both packages, and reshard moves a
        live sampler the same way."""
        outs = []
        for m in (port, ref):
            pair = [m.ElasticDistributedSampler(23, 2, r, shuffle, 5,
                                                drop_last) for r in (0, 1)]
            for _ in range(3):
                for s in pair:
                    s.record_batch(4)
            state = pair[1].state_dict()
            one = m.ElasticDistributedSampler(23, 1, 0, shuffle, 99,
                                              drop_last)
            one.load_state_dict(state)
            pair[0].reshard(1, 0)
            outs.append((state, list(one), len(one), list(pair[0])))
        assert outs[0] == outs[1]
        state, resumed, n, resharded = outs[0]
        assert state == {"epoch": 0, "completed_num": 12, "seed": 5}
        assert n == 11 and resumed == resharded

    def test_bad_shard_spec_raises(self):
        for args in ((10, 0, 0), (10, 2, 2), (10, 2, -1)):
            with pytest.raises(ValueError):
                port.ElasticDistributedSampler(*args)


# -- the loader ------------------------------------------------------------


def _dataset(n=23, seed=0):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(3).astype(np.float32),
             "ids": rs.randint(0, 100, size=(2, 2)).astype(np.int32),
             "row": np.int64(i)} for i in range(n)]


class _Client:
    """A sharding client's ``record_indices``: a seeded permutation."""

    def __init__(self, n, seed):
        self._order = np.random.RandomState(seed).permutation(n)

    def record_indices(self):
        for i in self._order:
            yield int(i)


class TestLoader:
    @pytest.mark.parametrize("batch", [1, 4, 5, 23, 30])
    @pytest.mark.parametrize("drop_last", [False, True])
    @pytest.mark.parametrize("source", ["sampler", "client"])
    def test_batches_equal(self, batch, drop_last, source):
        ds = _dataset()
        outs = []
        for m in (port, ref):
            kw = {}
            if source == "sampler":
                kw["sampler"] = m.ElasticDistributedSampler(
                    len(ds), 3, 1, shuffle=True, seed=4)
            else:
                kw["sharding_client"] = _Client(len(ds), 8)
            loader = m.ElasticDataLoader(ds, batch, drop_last=drop_last,
                                         **kw)
            outs.append((list(loader), len(loader)))
        (got, n), (want, want_n) = outs
        assert n == want_n and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        for g in got:
            assert g["x"].shape[0] == batch  # the padded last batch too

    def test_set_batch_size_at_a_boundary(self):
        ds = _dataset(40)
        outs = []
        for m in (port, ref):
            loader = m.ElasticDataLoader(ds, 4, drop_last=False)
            got = []
            for i, b in enumerate(loader):
                got.append(b)
                if i == 1:
                    loader.set_batch_size(3)
                if i == 4:
                    loader.set_batch_size(0)  # ignored
                    loader.set_batch_size(7)
            outs.append((got, loader.batch_size))
        assert outs[0][1] == outs[1][1] == 7
        assert [len(b["row"]) for b in outs[0][0]] == \
            [len(b["row"]) for b in outs[1][0]] == [4, 4, 3, 3, 3, 7, 7, 7, 7]
        for g, w in zip(outs[0][0], outs[1][0]):
            _same(g, w)

    def test_collate_keeps_structure(self):
        samples = [{"a": {"b": np.arange(2) + i}, "c": (i, np.ones(1) * i)}
                   for i in range(3)]
        out = port._default_collate(samples)
        _same(out["a"], ref._default_collate(samples)["a"])
        assert isinstance(out["c"], tuple)
        np.testing.assert_array_equal(out["c"][0], [0, 1, 2])


# -- DevicePreloader on the CPU ---------------------------------------------


def _batches(n, rows=4, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, 256, size=(rows, 9)).astype(
        np.int32), "x": rs.randn(rows, 3).astype(np.float32)}
        for _ in range(n)]


def _linear_result(rows=8):
    """A tiny accelerated model on the CPU whose global batch has
    ``rows`` rows."""

    def init_fn(gen):
        return {"w": torch.randn(3, 2, generator=gen)}

    def loss_fn(params, batch, rng):
        return (batch["x"] @ params["w"]).pow(2).mean(), {}

    example = {"input_ids": np.zeros((rows, 9), np.int32),
               "x": np.zeros((rows, 3), np.float32)}
    return accelerate(init_fn, loss_fn,
                      lambda p: torch.optim.SGD(p, lr=0.1), example,
                      device="cpu")


class TestDevicePreloader:
    @pytest.mark.parametrize("background", [False, True])
    @pytest.mark.parametrize("prefetch", [1, 2, 5])
    def test_batches_reach_the_device_in_order(self, background, prefetch):
        batches = _batches(7)
        pre = port.DevicePreloader(batches, prefetch=prefetch,
                                   background=background, device="cpu")
        got = list(pre)
        pre.close()
        want = list(ref.DevicePreloader(batches, prefetch=prefetch,
                                        background=background))
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert all(t.device.type == "cpu" for t in g.values())
            _same(g, w)
        assert pre.arena_slots() == 0  # no pinned arena off the card

    @pytest.mark.parametrize("k", [2, 3])
    def test_k_stacking_equals_the_reference(self, k):
        batches = _batches(7)
        got = list(port.DevicePreloader(batches, steps_per_call=k,
                                        device="cpu"))
        want = list(ref.DevicePreloader(batches, steps_per_call=k))
        # a trailing group short of K is dropped
        assert len(got) == len(want) == 7 // k
        for g, w in zip(got, want):
            assert g["x"].shape == (k, 4, 3)
            _same(g, w)

    def test_stacked_through_shard_batch(self):
        result = _linear_result(rows=4)
        got = list(port.DevicePreloader(_batches(4), sharding=result,
                                        steps_per_call=2))
        assert len(got) == 2
        for g, src in zip(got, (_batches(4)[:2], _batches(4)[2:])):
            assert isinstance(g, PlacedBatch) and g.stacked
            _same(g, port.stack_batches(src))
            # the trainer's shard_batch passes a placed batch through:
            # the same tensors, in a plain dict
            again = result.shard_batch(g, stacked=True)
            assert type(again) is dict
            assert all(again[k] is g[k] for k in g)

    def test_put_fn_equals_the_reference(self):
        for background in (False, True):
            got = list(port.DevicePreloader(iter(range(10)),
                                            put_fn=lambda x: x * 2,
                                            background=background))
            want = list(ref.DevicePreloader(iter(range(10)),
                                            put_fn=lambda x: x * 2,
                                            background=background))
            assert got == want == [x * 2 for x in range(10)]

    def test_reentry_resumes_mid_stream(self):
        """The executor calls iter() again after a rollback: the pump is
        shared, so the second pass resumes where the first stopped, in
        both packages."""
        outs = []
        for m in (port, ref):
            pre = m.DevicePreloader(iter(range(9)), put_fn=lambda x: x,
                                    background=True, prefetch=2)
            first = []
            for x in pre:
                first.append(x)
                if len(first) == 4:
                    break
            outs.append((first, list(pre)))
            if m is port:
                pre.close()
        assert outs[0] == outs[1] == ([0, 1, 2, 3], [4, 5, 6, 7, 8])

    def test_pump_error_is_raised_in_the_consumer(self):
        def boom():
            yield 1
            raise RuntimeError("producer died")

        it = iter(port.DevicePreloader(boom(), put_fn=lambda x: x,
                                       background=True))
        assert next(it) == 1
        with pytest.raises(RuntimeError, match="producer died"):
            list(it)

    def test_global_rows_check(self):
        """Each process feeds its own rows: 4 rows against a global batch
        of 8 on one process raise the contract error before placement;
        global_rows=0 skips the check, and placement itself then refuses
        the rows with its own message."""
        result = _linear_result(rows=8)
        bad = port.DevicePreloader(_batches(1, rows=4), sharding=result,
                                   global_rows=8)
        with pytest.raises(ValueError, match="PROCESS-LOCAL"):
            next(iter(bad))
        ok = list(port.DevicePreloader(_batches(1, rows=8), sharding=result,
                                       global_rows=8))
        _same(ok[0], _batches(1, rows=8)[0])
        skipped = port.DevicePreloader(_batches(1, rows=4), sharding=result)
        with pytest.raises(ValueError) as err:
            next(iter(skipped))
        assert "PROCESS-LOCAL" not in str(err.value)
        assert "shard_batch takes the global batch" in str(err.value)

    def test_asks_for_the_card_by_default(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
        for kw in ({}, {"device": "cuda"}, {"put_fn": None}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                port.DevicePreloader([], **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.DevicePreloader([], put_fn=lambda b: b, device="cuda")
        with pytest.raises(ValueError):
            port.DevicePreloader([], prefetch=0, device="cpu")
        with pytest.raises(ValueError):
            port.DevicePreloader([], steps_per_call=0, device="cpu")

    def test_background_refuses_exchanging_placement(self):
        """Over several ranks with two microbatches, placement gathers
        the process-local rows: a pump thread must not issue that
        exchange beside the step's."""
        import types

        sharding = types.SimpleNamespace(
            world=2, device="cpu",
            strategy=types.SimpleNamespace(grad_accum_steps=2))
        with pytest.raises(ValueError, match="pump thread"):
            port.DevicePreloader([], sharding=sharding, background=True)
        port.DevicePreloader([], sharding=sharding)  # foreground is fine
        sharding.strategy.grad_accum_steps = 1
        port.DevicePreloader([], sharding=sharding, background=True)

    def test_close_stops_an_abandoned_pump(self):
        pre = port.DevicePreloader(iter(range(1000)), put_fn=lambda x: x,
                                   background=True, prefetch=2)
        it = iter(pre)
        assert next(it) == 0
        pre.close(timeout=10)
        assert not pre._bg_thread.is_alive()

    def test_instruments(self):
        """The reference's data-plane tests on the port: the foreground
        producer wait and depth, and the consumer wait a slow producer
        causes in background mode."""
        process_registry().reset()
        pre = port.DevicePreloader([{"x": i} for i in range(8)],
                                   put_fn=lambda b: b)
        assert len(list(pre)) == 8
        reg = process_registry()
        assert reg.get(tm.DATA_PRODUCER_WAIT_TIME).count >= 7
        assert reg.get(tm.DATA_PREFETCH_QUEUE_DEPTH) is not None

        def slow_source():
            for i in range(4):
                time.sleep(0.02)
                yield {"x": i}

        pre = port.DevicePreloader(slow_source(), put_fn=lambda b: b,
                                   background=True)
        assert len(list(pre)) == 4
        h = process_registry().get(tm.DATA_CONSUMER_WAIT_TIME)
        assert h is not None and h.count >= 4
        assert h.sum > 0.04

    def test_pump_stress_keeps_every_batch(self, monkeypatch):
        """Two background preloaders and their consumers under a short
        switch interval: every batch arrives once, in order."""
        import sys

        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            outs = [None, None]

            def consume(i):
                pre = port.DevicePreloader(
                    ({"x": np.full(2, j)} for j in range(300)),
                    background=True, prefetch=3, device="cpu")
                outs[i] = [int(b["x"][0]) for b in pre]
                pre.close()

            threads = [threading.Thread(target=consume, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(prev)
        assert outs == [list(range(300))] * 2


# -- the executor's input wait ----------------------------------------------


def _trainer():
    def init_fn(gen):
        return {"w": torch.randn(4, 2, generator=gen),
                "b": torch.zeros(2)}

    def loss_fn(params, batch, rng):
        pred = batch["x"] @ params["w"] + params["b"]
        return ((pred - batch["y"]) ** 2).mean(), {}

    rs = np.random.RandomState(0)
    x = rs.randn(16, 4).astype(np.float32)
    batch = {"x": x, "y": x @ rs.randn(4, 2).astype(np.float32)}
    trainer = ElasticTrainer(init_fn, loss_fn,
                             lambda p: torch.optim.SGD(p, lr=0.1), batch,
                             device="cpu")
    return trainer, batch


def _run_executor(trainer, iter_fn, steps=12, window=2):
    executor = TrainExecutor(
        trainer, train_iter_fn=iter_fn,
        conf=Configuration({"train_steps": steps, "log_every_steps": 0,
                            "train_window": window,
                            "preemption_grace": False}))
    executor.train_and_evaluate()
    return executor


class TestExecutorInputWait:
    def test_gauge_absent_until_measured_then_tracks_starvation(self):
        process_registry().reset()
        trainer, batch = _trainer()

        def starved():
            for _ in range(12):
                time.sleep(0.03)
                yield batch

        # absent before any run: a scrape must not read a fake 0
        assert process_registry().get(tm.INPUT_WAIT_FRAC) is None
        executor = _run_executor(trainer, starved)
        g = process_registry().get(tm.INPUT_WAIT_FRAC)
        assert g is not None and g.value > 0.5, g.value
        assert process_registry().get(tm.INPUT_WAIT_TIME).count >= 12
        # the drain's fetch-free tail windows do not zero the gauge (the
        # > 0.5 above: the last materializations come back to back)
        te = [r for r in recent_events()
              if r["kind"] == EventKind.TRAIN_END]
        assert te and te[-1]["input_wait_s"] > 0.2
        assert executor.input_wait_seconds > 0.3

        # a fast source drops the fraction back toward 0
        executor = _run_executor(trainer, lambda: iter([batch] * 12))
        assert process_registry().get(tm.INPUT_WAIT_FRAC).value < 0.3
        assert executor.input_wait_seconds < 0.2

    def test_a_run_counts_its_own_wait(self):
        """Each run's train-end record and total start from 0; the
        histogram counts every fetch, the exhausting one excepted."""
        process_registry().reset()
        trainer, batch = _trainer()

        def slow(n):
            def gen():
                for _ in range(n):
                    time.sleep(0.01)
                    yield batch
            return gen

        executor = TrainExecutor(
            trainer, train_iter_fn=slow(4),
            conf=Configuration({"train_steps": 0, "log_every_steps": 0,
                                "preemption_grace": False}))
        executor.train_and_evaluate()
        first = executor.input_wait_seconds
        executor.train_and_evaluate()
        assert 0.03 < executor.input_wait_seconds < first + 0.2
        assert process_registry().get(tm.INPUT_WAIT_TIME).count == 8


# -- a 2-rank trajectory fed by the loader ----------------------------------


def _samples(vocab, n, seq, seed):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(n, seq + 1))
    return [{"input_ids": ids[i, :-1], "labels": ids[i, 1:],
             "row": np.int64(i)} for i in range(n)]


def _reference_run(jcfg, samples, steps, global_batch, accum, lr, seed):
    """The reference on a 2-device mesh: its loader, sharded as the two
    processes' samplers shard it, assembled into the global batch the way
    ``put_global_batch`` assembles process-local rows (process p's rows
    at [p R/2, (p+1) R/2))."""
    result = jax_accelerate(
        jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
        optax.adamw(lr, weight_decay=0.1),
        ref._default_collate(samples[:global_batch]),
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=2), rule_set="llama",
                             remat_policy="", grad_accum_steps=accum),
        devices=jax.devices()[:2])
    state = result.init_fn(jax.random.PRNGKey(0))
    tree = jax.device_get(state.params)
    loaders = [iter(ref.ElasticDataLoader(
        samples, global_batch // 2, sampler=ref.ElasticDistributedSampler(
            len(samples), 2, rank, shuffle=True, seed=seed,
            drop_last=True))) for rank in (0, 1)]
    losses, rows = [], []
    for i in range(steps):
        parts = [next(it) for it in loaders]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        rows.append(batch["row"].tolist())
        state, m = result.train_step(state, result.shard_batch(batch),
                                     jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
    return tree, losses, rows


@pytest.fixture(scope="module")
def trajectories():
    jcfg = jax_llama.llama_tiny()
    steps, global_batch, lr, seed = 3, 8, 1e-2, 11
    samples = _samples(jcfg.vocab_size, 40, 16, 3)
    out = {}
    for accum in (1, 2):
        tree, losses, rows = _reference_run(jcfg, samples, steps,
                                            global_batch, accum, lr, seed)
        got = run_local(workers.loader_ranks, 2,
                        (tree, samples, steps, global_batch, accum, lr,
                         seed), timeout=TIMEOUT)
        out[accum] = {"losses": losses, "rows": rows, "got": got}
    return out


class TestTrajectory:
    @pytest.mark.parametrize("accum", [1, 2])
    def test_losses_match_the_reference(self, trajectories, accum):
        """f32 on the CPU: 1e-5 relative (the ranks' and the mesh's
        reductions sum in their own orders)."""
        t = trajectories[accum]
        for r in t["got"]:
            np.testing.assert_allclose(r["losses"], t["losses"], rtol=1e-5)

    @pytest.mark.parametrize("accum", [1, 2])
    def test_loader_rows_are_the_reference_s(self, trajectories, accum):
        """Each rank's loader gives it the rows the reference's sampler
        gives that process, and the loss sees in microbatch i the block
        the reference's device r holds: the global batch reshaped to
        [accum, R/accum] (the reference's ``_accumulate_grads``), each
        microbatch split over the data axis."""
        t = trajectories[accum]
        for rank, r in enumerate(t["got"]):
            half = len(t["rows"][0]) // 2
            assert r["given"] == [g[rank * half:(rank + 1) * half]
                                  for g in t["rows"]]
            mb = len(t["rows"][0]) // accum
            part = mb // 2
            want = [g[i * mb + rank * part:i * mb + (rank + 1) * part]
                    for g in t["rows"] for i in range(accum)]
            assert r["seen"] == want
