"""The port's elastic serving (prewarm, retune, snapshot and live resize,
the executor's plan loop, the runtime report hook, the forensic request
view, the planner's decode term) against the JAX package's, on the CPU.

``llama_tiny`` in f32 with the reference's weights carried across by
``interop``, one device. The port's and the reference's executors run
the same schedules of requests and plans: their tokens are equal, and
so are the ``report_serve_config`` fields a recording client receives.
The closed-loop cases drive the port's worker against the reference's
real master over RPC. Tolerances: exact on tokens, pages, counters and
acks; rel 1e-12 on the planner's figures.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.agent.master_client import MasterClient
from dlrover_tpu.common import comm
from dlrover_tpu.master.local_master import start_local_master
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import planner as jax_planner
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.serving import cli as jax_cli
from dlrover_tpu.serving import engine as jax_engine
from dlrover_tpu.serving import kv_cache as jax_kv
from dlrover_tpu.serving import slo as jax_slo
from dlrover_tpu.telemetry import metrics as jax_metrics
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import planner
from dlrover_tpu_torch.serving import cli, engine, kv_cache, slo
from dlrover_tpu_torch.telemetry import EventKind, names as tm
from dlrover_tpu_torch.telemetry.events import clear_ring, recent_events
from dlrover_tpu_torch.telemetry.metrics import MetricsRegistry, get_registry

CPU = torch.device("cpu")
JAX_TINY = jax_llama.llama_tiny()
TINY = llama.llama_tiny()
# the reference's module engine (tests/test_serving.py)
GEOMETRY = dict(serve_slots=4, prefill_chunk=8, max_seq=48, page_size=8)
JOIN_S = 30.0  # the longest any test waits for a thread or the master


@pytest.fixture(autouse=True)
def _torch_settings():
    """One CPU thread: the suite's other workers run beside these."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jax_llama.init(jax.random.PRNGKey(0), JAX_TINY))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax_params, device="cpu")


def _ref_engine(jax_params, **kw):
    eng = jax_engine.ServeEngine(
        JAX_TINY, strategy=JaxStrategy(mesh=JaxMeshPlan(data=-1),
                                       rule_set="llama"),
        devices=jax.devices()[:1], **{**GEOMETRY, **kw})
    eng.prepare(jax.tree.map(jnp.asarray, jax_params))
    return eng


def _port_engine(params, **kw):
    eng = engine.ServeEngine(TINY, devices=[CPU], **{**GEOMETRY, **kw})
    eng.prepare(params)
    return eng


@pytest.fixture(scope="module")
def engines(jax_params, params):
    """(reference, port) engines at GEOMETRY; each test leaves their
    knobs as it found them."""
    return _ref_engine(jax_params), _port_engine(params)


def _prompt(n, seed):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(0, TINY.vocab_size, size=(n,))]


class Recorder:
    """A duck-typed router client with no queue of its own: it records
    completions, config reports and runtime reports."""

    def __init__(self):
        self.done, self.configs, self.runtime = [], [], []

    def serve_lease(self, max_requests):
        return []

    def serve_complete(self, **record):
        self.done.append(record)

    def report_serve_config(self, **fields):
        self.configs.append(fields)


def _tokens(records):
    return {r["request_id"]: r["tokens"] for r in records}


def _baseline(eng, jobs):
    eng.cache = eng.fresh_cache()
    ex = type_of(eng)(eng, serve_window=1)
    for rid, prompt, new in jobs:
        ex.submit(prompt, max_new_tokens=new, request_id=rid)
    return _tokens(ex.serve())


def type_of(eng):
    """The executor class of ``eng``'s package."""
    return (engine.ServeExecutor if isinstance(eng, engine.ServeEngine)
            else jax_engine.ServeExecutor)


def _twin(engines, jobs, schedule, **kw):
    """Run ``schedule(executor)`` in both packages on the same submitted
    ``jobs``; returns [(tokens, recorder, executor)] (reference, port)."""
    out = []
    for eng in engines:
        eng.cache = eng.fresh_cache()
        rec = Recorder()
        ex = type_of(eng)(eng, router_client=rec, serve_window=1,
                          plan_poll_secs=0, **kw)
        for rid, prompt, new in jobs:
            ex.submit(prompt, max_new_tokens=new, request_id=rid)
        schedule(ex)
        out.append((_tokens(ex.completed), rec, ex))
    return out


def _retune_now(ex, **knobs):
    """Apply a retune at once, at a drained boundary."""
    ex.request_retune(**knobs)
    ex._drain_window()
    ex._apply_retune()


# -- (a) migrate_slots_host ---------------------------------------------------


def _random_pool(jspec, seed):
    """A reference host pool with random pages, lengths and scales."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, a in jax.device_get(jax_kv.init_kv_cache(jspec)).items():
        a = np.asarray(a)
        if name == "length":
            out[name] = rng.integers(0, jspec.max_seq, a.shape).astype(a.dtype)
        elif a.dtype == np.int8:
            out[name] = rng.integers(-127, 128, a.shape).astype(np.int8)
        else:
            out[name] = rng.standard_normal(a.shape).astype(np.float32).astype(
                a.dtype)
    return out


class TestMigrateSlotsHost:
    @pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
    @pytest.mark.parametrize("new_slots,slot_map", [
        (8, {0: 0, 1: 1, 3: 2}), (2, {3: 0, 1: 1}), (4, {2: 3, 0: 1}),
        (6, {})])
    def test_bit_for_bit_against_the_reference(self, precision, new_slots,
                                               slot_map):
        old = dict(num_slots=4, max_seq=24, page_size=8, precision=precision)
        jold = jax_kv.KVCacheSpec.from_model(JAX_TINY, **old)
        jnew = jax_kv.KVCacheSpec.from_model(
            JAX_TINY, **{**old, "num_slots": new_slots})
        pold = kv_cache.KVCacheSpec.from_model(TINY, **old)
        pnew = pold.with_slots(new_slots)
        host = _random_pool(jold, seed=new_slots)
        want = jax_kv.migrate_slots_host(host, jold, jnew, slot_map)
        got = kv_cache.migrate_slots_host(
            interop.kv_cache_from_numpy(host, "cpu"), pold, pnew, slot_map)
        assert all(t.device == CPU for t in got.values())
        got = interop.kv_cache_to_numpy(got)
        assert got.keys() == want.keys()
        for name, w in want.items():
            w = np.asarray(w)
            if w.dtype.name == "bfloat16":
                w = w.astype(np.float32)
            assert got[name].dtype == w.dtype, name
            np.testing.assert_array_equal(got[name], w, err_msg=name)

    def test_refuses_a_change_of_depth_or_precision(self):
        base = kv_cache.KVCacheSpec.from_model(TINY, num_slots=2,
                                               max_seq=16, page_size=8)
        host = kv_cache.init_kv_cache(base)
        for other in (dataclasses.replace(base, pages_per_slot=3),
                      dataclasses.replace(base, precision="bf16")):
            with pytest.raises(ValueError, match="slot dim"):
                kv_cache.migrate_slots_host(host, base, other, {0: 0})
            jbase = jax_kv.KVCacheSpec(**dataclasses.asdict(base))
            jother = jax_kv.KVCacheSpec(**dataclasses.asdict(other))
            with pytest.raises(ValueError, match="slot dim"):
                jax_kv.migrate_slots_host(
                    interop.kv_cache_to_numpy(host), jbase, jother, {0: 0})


# -- (b) the executor's retunes, twin for twin ---------------------------------


class TestRetuneTwins:
    def test_retune_repacks_live_slots(self, engines):
        """A slot-width plan at a drained boundary repacks the live
        requests on the host: no request lost, tokens unchanged, the
        same acks."""
        jobs = [(f"b{i}", _prompt(5, 10 + i), 5) for i in range(3)]
        expect = _baseline(engines[1], jobs)

        def schedule(ex):
            ex.serve(max_steps=2, until_idle=False)
            ex.request_retune(serve_slots=8, plan_id="wide")
            ex.serve()

        (want, jrec, _), (got, rec, ex) = _twin(engines, jobs, schedule)
        assert got == want == expect
        assert [e.program.spec.num_slots for e in engines] == [8, 8]
        assert rec.configs == jrec.configs
        assert rec.configs[-1]["plan_id"] == "wide"
        assert rec.configs[-1]["serve_slots"] == 8
        assert rec.configs[-1]["apply_failed"] is False
        assert ex.slot_ledger()["resize_frozen"] > 0
        for e in engines:
            _retune_now(type_of(e)(e), serve_slots=4)
            assert e.program.spec.num_slots == 4

    def test_chunk_only_retune_leaves_live_slots_in_place(self, engines):
        jobs = [(f"c{i}", _prompt(5, 30 + i), 6) for i in range(3)]
        expect = _baseline(engines[1], jobs)

        def schedule(ex):
            ex.serve(max_steps=2, until_idle=False)
            assert any(ex._active_host)
            ex.request_retune(prefill_chunk=4, plan_id="chunk4")
            ex.serve()

        (want, jrec, _), (got, rec, _) = _twin(engines, jobs, schedule)
        assert got == want == expect
        assert rec.configs == jrec.configs
        port = engines[1]
        assert port.program.prefill_chunk == 4
        assert port.program.spec.num_slots == 4
        for e in engines:
            _retune_now(type_of(e)(e), prefill_chunk=8)
            assert e.program.prefill_chunk == 8

    def test_chunk_retune_mid_prefill_restarts_the_prompt(self, engines):
        jobs = [("mid", _prompt(20, 33), 4)]
        expect = _baseline(engines[1], jobs)
        cursors = []

        def schedule(ex):
            ex._ensure_prepared()
            ex._admit()
            ex._prefill_tick()  # one chunk of 8 in: cursor 8, inactive
            state = next(s for s in ex._slots if s is not None)
            assert 0 < state.cursor < len(state.prompt)
            ex.request_retune(prefill_chunk=16, plan_id="c16")
            ex._apply_retune()
            cursors.append(state.cursor)
            ex.serve()

        (want, jrec, _), (got, rec, _) = _twin(engines, jobs, schedule)
        assert cursors == [0, 0]
        assert got == want == expect
        assert rec.configs == jrec.configs
        for e in engines:
            _retune_now(type_of(e)(e), prefill_chunk=8)

    def test_unachievable_chunk_plan_negative_acks(self, engines):
        """A chunk that does not divide the pool depth (48) is
        negative-acked before anything changes."""
        def schedule(ex):
            ex._ensure_prepared()
            ex.request_retune(prefill_chunk=9, plan_id="bad-chunk")
            ex._apply_retune()

        (_, jrec, _), (_, rec, _) = _twin(engines, [], schedule)
        assert rec.configs == jrec.configs
        assert [a["apply_failed"] for a in rec.configs] == [True]
        assert rec.configs[0]["plan_id"] == "bad-chunk"
        assert [e.prefill_chunk for e in engines] == [8, 8]


# -- (c) the prefix pool across retunes ----------------------------------------


def _serve_locally(eng, jobs, tag):
    eng.cache = eng.fresh_cache()
    ex = type_of(eng)(eng, serve_window=1)
    for rid, prompt, new in jobs:
        ex.submit(prompt, max_new_tokens=new, request_id=f"{tag}-{rid}")
    return {r["request_id"].split("-", 1)[1]: r for r in ex.serve()}


def test_retune_carry_flush_rebuild(jax_params, params):
    """Slot-only retunes carry the pool and its index, a chunk change
    flushes the index (its counters survive), a pool-size change
    rebuilds it empty, and 0 turns it off: step for step as the
    reference's."""
    pair = [_ref_engine(jax_params, prefix_pool_pages=8),
            _port_engine(params, prefix_pool_pages=8)]
    p = _prompt(24, 90)
    views = []
    for eng in pair:
        view = []
        seed = _serve_locally(eng, [("seed", p, 2)], "s")
        view.append((seed["seed"]["tokens"], eng.prefix_index.used_pages))
        eng.retune(serve_slots=6, slot_map={})
        got, h = eng.prefix_match(p + _prompt(8, 91))
        view.append((got, list(h.pages), eng.program.spec.num_slots))
        eng.prefix_release(h)
        hits = eng.prefix_index.hits
        eng.retune(prefill_chunk=4)
        view.append((eng.prefix_index.used_pages, eng.prefix_index.hits,
                     hits))
        eng.prefix_release(h)  # idempotent after the flush
        eng.retune(prefix_pool_pages=4)
        view.append((eng.prefix_index.capacity, eng.prefix_index.used_pages,
                     int(eng.pool["k"].shape[1])))
        eng.retune(prefix_pool_pages=0)
        view.append((eng.prefix_enabled(), eng.prefix_match(p),
                     eng.compile_count))
        views.append(view)
    assert views[0] == views[1]
    assert views[1][1][0] == 24 and views[1][2][0] == 0
    assert views[1][3][:2] == (4, 0)


# -- (d) a failed retune --------------------------------------------------------


class TestFailedRetune:
    def test_engine_restores_knobs_and_program(self, engines):
        port = engines[1]
        program, knobs = port.program, port._knobs()
        cache = port.cache
        with pytest.raises(ValueError, match="does not fit"):
            port.retune(spec_draft_len=48)  # K + 1 rows past the pool
        assert port.program is program and port._knobs() == knobs
        assert port.cache is cache

    @pytest.mark.parametrize("fault", ["draft_too_long", "copy_fails",
                                       "prefix_pool_fails"])
    def test_executor_negative_acks_and_keeps_serving(self, engines, fault,
                                                      monkeypatch):
        """The executor negative-acks a plan whose retune fails and
        serves on at the previous config. A failed host copy of the
        pool (``copy_fails``, both packages) restores the active
        program as well as the knobs; a prefix pool that cannot be
        allocated after the wider slots' pool was placed
        (``prefix_pool_fails``, the port: the reference keeps the new
        pool) restores the slots' pool too; an over-long draft fails the
        port's build (the reference builds it lazily and is not run)."""
        jobs = [(f"f{i}", _prompt(6, 60 + i), 5) for i in range(3)]
        expect = _baseline(engines[1], jobs)

        def fail(*args, **kwargs):
            raise MemoryError("no room for the wider pool")

        if fault == "copy_fails":
            monkeypatch.setattr(engine, "migrate_slots_host", fail)
            monkeypatch.setattr(jax_engine, "migrate_slots_host", fail)
            plan = dict(serve_slots=8, plan_id="oom")
            pair = engines
        elif fault == "prefix_pool_fails":
            monkeypatch.setattr(engine.ServeEngine, "reset_prefix", fail)
            plan = dict(serve_slots=8, prefix_pool_pages=4,
                        plan_id="oom-prefix")
            pair = engines[1:]
        else:
            plan = dict(spec_draft_len=48, plan_id="long-k")
            pair = engines[1:]
        programs = [e.program for e in pair]

        def schedule(ex):
            ex.serve(max_steps=2, until_idle=False)
            ex.request_retune(**plan)
            ex.serve()

        runs = _twin(pair, jobs, schedule)
        for (got, rec, ex), eng, program in zip(runs, pair, programs):
            assert got == expect
            assert eng.program is program
            assert eng.cache["length"].shape[0] == 4 and eng.pool is None
            assert (eng.serve_slots, eng.prefill_chunk,
                    eng.prefix_pool_pages, eng.spec_draft_len) == (4, 8, 0, 0)
            acks = [a for a in rec.configs if a["plan_id"]]
            assert [(a["plan_id"], a["apply_failed"]) for a in acks] == [
                (plan["plan_id"], True)]
        if fault == "copy_fails":
            assert runs[0][1].configs == runs[1][1].configs


# -- (e) prewarm ----------------------------------------------------------------


def test_prewarm_then_retune_builds_nothing(engines):
    """A prewarm builds the candidate (once) without switching to it and
    runs its dummy steps; the retune that follows builds nothing, in
    both packages."""
    counts = []
    for eng in engines:
        program = eng.program
        before = eng.compile_count
        first = eng.prewarm(serve_slots=6, prefill_chunk=4)
        again = eng.prewarm(serve_slots=6, prefill_chunk=4)
        assert eng.program is program and eng.serve_slots == 4
        built = eng.retune(serve_slots=6, prefill_chunk=4, slot_map={})
        counts.append((first, again, eng.compile_count - before, built,
                       eng.program.spec.num_slots,
                       eng.program.prefill_chunk))
        eng.retune(serve_slots=4, prefill_chunk=8, slot_map={})
    assert counts[1] == (True, False, 1, 0, 6, 4)
    assert counts[0] == counts[1]


# -- (f) live resize ------------------------------------------------------------


class TestLiveResize:
    def test_mid_decode_continuations_bit_for_bit(self, engines):
        port = engines[1]
        jobs = [(f"r{i}", _prompt(5 + 3 * i, 70 + i), 6) for i in range(5)]
        expect = _baseline(port, jobs)
        clear_ring()
        resizes = get_registry().counter(tm.SERVE_RESIZES).value
        snap = port.snapshot()
        assert snap.meta == {"kind": "serving"}
        assert {name.split("/")[0] for name in snap.tree} == {"params",
                                                              "cache"}
        assert snap.nbytes() == sum(
            t.numel() * t.element_size() for t in snap.tree.values())
        built = []

        def schedule(ex):
            ex.serve(max_steps=3, until_idle=False)
            assert any(ex._active_host), "no request mid-decode"
            built.append(port.prewarm(devices=[CPU]))
            ex.request_resize([CPU], trace_id="inc-resize")
            ex.serve()

        [(got, rec, ex)] = _twin(engines[1:], jobs, schedule)
        assert got == expect
        assert built == [False]  # the device's program exists
        events = [e for e in recent_events()
                  if e["kind"] in (EventKind.SERVE_RESIZE_BEGIN,
                                   EventKind.SERVE_RESIZE_DONE)]
        assert [e["kind"] for e in events] == [EventKind.SERVE_RESIZE_BEGIN,
                                               EventKind.SERVE_RESIZE_DONE]
        assert all(e["trace_id"] == "inc-resize" for e in events)
        done = events[-1]
        assert (done["world_from"], done["world_to"],
                done["recompiled"]) == (1, 1, 0)
        assert done["reshard_seconds"] >= 0
        assert get_registry().counter(tm.SERVE_RESIZES).value == \
            resizes + 1
        # a resize's report follows it
        assert len(rec.configs) == 3 and rec.configs[-1]["world"] == 1

    def test_several_devices_raise_naming_a16c(self, engines):
        port = engines[1]
        with pytest.raises(NotImplementedError, match="A16c"):
            engine.ServeEngine(TINY, devices=[CPU, CPU])
        program = port.program
        for call in (lambda: port.live_resize([CPU, CPU]),
                     lambda: port.prewarm(devices=[CPU, CPU])):
            with pytest.raises(NotImplementedError, match="A16c"):
                call()
        assert port.program is program and port.params is not None
        with pytest.raises(NotImplementedError, match="A16c"):
            kv_cache.serve_shardings({"data": 2}, port.program.spec,
                                     llama.param_shapes(TINY))

    def test_pool_rides_the_resize_or_rebuilds_clean(self, params):
        """The prefix pool and its index carry across a resize; a
        snapshot taken with the pool off rebuilds it clean."""
        eng = _port_engine(params, prefix_pool_pages=8)
        p = _prompt(24, 80)
        _serve_locally(eng, [("seed", p, 2)], "s")
        pool_k = eng.pool["k"].clone()
        index = eng.prefix_index
        assert eng.live_resize([CPU]) == 0
        assert eng.prefix_index is index and index.used_pages == 3
        assert torch.equal(eng.pool["k"], pool_k)
        snap = eng.snapshot()
        snap.tree = {name: t for name, t in snap.tree.items()
                     if not name.startswith("prefix/")}
        eng.live_resize([CPU], snapshot=snap)
        assert eng.prefix_index is not index
        assert eng.prefix_index.used_pages == 0
        assert not eng.pool["k"].any()


# -- (g) against the reference's master over RPC -------------------------------


def _stop(master):
    stopper = threading.Thread(target=master.stop, daemon=True)
    stopper.start()
    stopper.join(JOIN_S)
    assert not stopper.is_alive(), "the master did not stop"


class TestOverTheReferenceMaster:
    def test_closed_loop_plan_is_polled_prewarmed_retuned_acked(
            self, params):
        """The master's optimizer prices the worker's config report and
        publishes a serve plan; the port's worker polls it, prewarms,
        retunes through the program cache and acks it."""
        master = start_local_master()
        try:
            sub = MasterClient(master.addr, node_id=99)
            sub.report_model_info(comm.ModelInfo(
                num_params=100_000, hidden_size=64, num_layers=2,
                seq_len=128))
            for i in range(12):
                sub.submit_serve_request(_prompt(5, 40 + i),
                                         max_new_tokens=6,
                                         request_id=f"e{i}")
            eng = _port_engine(params, serve_slots=4, prefill_chunk=4,
                               max_seq=32)
            ex = engine.ServeExecutor(
                eng, router_client=MasterClient(master.addr, node_id=0),
                serve_window=1, plan_poll_secs=0.01)
            done = ex.serve()
            assert len(done) == 12
            assert not any(r["error_code"] for r in done)
            assert eng.program.spec.num_slots > 4
            # the prewarm built the plan's program, the retune nothing
            assert eng.compile_count == 2
            chosen = [
                d for d in master.servicer.runtime_optimizer.decisions()
                if d["trigger"].startswith("serve:")
                and d["outcome"] == "chosen"]
            assert chosen and chosen[0]["applied"]
        finally:
            _stop(master)

    def test_live_resize_under_traffic_over_the_router(
            self, params, tmp_path, monkeypatch, capsys):
        """Two port workers over the reference's router; worker 0
        resizes live (onto its device) while it holds leases mid-decode.
        Zero dropped, zero expired leases, continuations equal to a
        pool-free baseline, and both packages' forensic views of the
        event log equal."""
        events_path = str(tmp_path / "events.jsonl")
        monkeypatch.setenv("DLROVER_TPU_EVENTS_FILE", events_path)
        shared = _prompt(16, 7)
        prompts = {f"r{i}": shared + _prompt(4, 20 + i) for i in range(10)}
        geometry = dict(prefill_chunk=4, max_seq=32)
        base = _port_engine(params, **geometry)
        expect = _baseline(base, [(rid, p, 6) for rid, p in
                                  prompts.items()])
        master = start_local_master()
        try:
            sub = MasterClient(master.addr, node_id=99)
            for rid, p in prompts.items():
                assert sub.submit_serve_request(
                    p, max_new_tokens=6, request_id=rid) == rid
            eng_a = _port_engine(params, prefix_pool_pages=8, **geometry)
            eng_b = _port_engine(params, prefix_pool_pages=8, **geometry)
            worker_a, worker_b = (
                engine.ServeExecutor(
                    eng, router_client=MasterClient(master.addr,
                                                    node_id=node),
                    serve_window=1, plan_poll_secs=0)
                for node, eng in ((0, eng_a), (1, eng_b)))
            worker_a.serve(max_steps=3, until_idle=False)
            assert any(worker_a._active_host), "no in-flight traffic"
            worker_b.serve()
            assert worker_b.completed
            assert eng_a.prewarm(devices=[CPU]) is False
            compiles = eng_a.compile_count
            worker_a.request_resize([CPU])
            worker_a.serve()
            assert eng_a.compile_count == compiles

            report = sub.get_serve_report()
            req = report["requests"]
            assert (req["submitted"], req["completed"], req["dropped"],
                    req["leases_expired"], req["queued"],
                    req["leased"]) == (10, 10, 0, 0, 0, 0), report
            assert set(report["nodes"]) == {"0", "1"}
            got = _tokens(worker_a.completed + worker_b.completed)
            assert got == expect
            live_prefix = report.get("prefix") or {}
            assert live_prefix.get("hits", 0) >= 1, report
        finally:
            _stop(master)
        capsys.readouterr()
        views = []
        for main in (jax_cli.main, cli.main):
            assert main(["requests", "--events", events_path,
                         "--json"]) == 0
            views.append(json.loads(capsys.readouterr().out))
        assert views[0] == views[1]
        forensic = views[1]
        assert forensic["requests"]["submitted"] == 10
        assert forensic["requests"]["completed"] == 10
        assert forensic["leases_expired"] == 0
        assert [(r["world_from"], r["world_to"], r["recompiled"])
                for r in forensic["resizes"]] == [(1, 1, 0)]
        assert forensic["prefix"]["hits"] == live_prefix["hits"]
        assert forensic["prefix"]["saved_prefill_tokens"] == \
            live_prefix["saved_prefill_tokens"]


# -- the CLI alone ----------------------------------------------------------------


def test_cli_live_views_wait_for_a12(tmp_path, capsys):
    for argv in (["serve", "--addr", "x:1"], ["serve", "slo"],
                 ["requests", "--addr", "x:1"]):
        with pytest.raises(NotImplementedError, match="A12"):
            cli.main(argv)
    assert cli.main([]) == 2
    assert cli.main(["requests"]) == 2
    empty = str(tmp_path / "none.jsonl")
    capsys.readouterr()
    assert cli.main(["requests", "--events", empty]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jax_cli.main(["requests", "--events", empty, "--json"]) == 0
    assert ours == json.loads(capsys.readouterr().out)


# -- (h) the runtime report hook --------------------------------------------------


class RuntimeRecorder(Recorder):
    def __init__(self, block: threading.Event = None, fail: bool = False):
        super().__init__()
        self._block, self._fail = block, fail

    def report_node_runtime(self, **fields):
        if self._block is not None:
            self._block.wait(JOIN_S)
        if self._fail:
            raise ConnectionError("master away")
        self.runtime.append(fields)


# timings differ between the packages; counts do not
TIMED = ("rss_mb", "step_time_counts")


def _counts_only(payload):
    return {k: v for k, v in payload.items() if k not in TIMED}


def _wait_for(pred):
    deadline = time.monotonic() + JOIN_S
    while not pred():
        assert time.monotonic() < deadline, "the sender never sent"
        time.sleep(0.005)


class TestRuntimeReportHook:
    def test_flush_payload_equals_the_reference_hook(self, engines):
        """A workload's last report (the flush at the loop's end): every
        count-valued field as the reference hook's."""
        jobs = [(f"h{i}", _prompt(4 + 5 * i, 50 + i), 4 + i)
                for i in range(5)]
        sent = []
        for eng, hook_cls, reg in (
                (engines[0], jax_slo.ServeRuntimeReportHook,
                 jax_metrics.MetricsRegistry()),
                (engines[1], slo.ServeRuntimeReportHook,
                 MetricsRegistry())):
            eng.cache = eng.fresh_cache()
            rec = RuntimeRecorder()
            hook = hook_cls(rec, every_steps=10_000, registry=reg,
                            min_interval_s=0)
            ex = type_of(eng)(eng, router_client=rec, serve_window=1,
                              plan_poll_secs=0, registry=reg,
                              report_hook=hook)
            for rid, prompt, new in jobs:
                ex.submit(prompt, max_new_tokens=new, request_id=rid)
            ex.serve()
            assert hook._sender is None  # joined by the flush
            sent.append(rec.runtime)
        assert len(sent[1]) == 1
        assert [_counts_only(p) for p in sent[1]] == [
            _counts_only(p) for p in sent[0]]
        payload = sent[1][0]
        assert payload["node_type"] == "serve"
        assert payload["serve_tokens_total"] == sum(n for *_, n in jobs)
        assert sum(payload["step_time_counts"]) == payload["steps_total"]
        assert payload["rss_mb"] > 0

    def test_cadence_and_floor_equal_the_reference(self, monkeypatch):
        """Every ``every_steps`` steps, floored by ``min_interval_s``.
        Both hooks start from ``_last_send = 0.0`` on ``time.monotonic``,
        which counts from boot: on a machine up for less than the floor
        they drop the first report too (the reference's behaviour, which
        the port copies). So both modules read one clock that starts far
        from zero here, and the cadence and the floor are checked on any
        machine."""
        class OffsetClock:
            """The ``time`` module with ``monotonic`` a day ahead."""

            def __getattr__(self, name):
                return getattr(time, name)

            @staticmethod
            def monotonic():
                return time.monotonic() + 86400.0

        for module in (jax_slo, slo):
            monkeypatch.setattr(module, "time", OffsetClock())
        steps_sent = []
        for hook_cls, reg_cls in (
                (jax_slo.ServeRuntimeReportHook,
                 jax_metrics.MetricsRegistry),
                (slo.ServeRuntimeReportHook, MetricsRegistry)):
            for floor in (0, 3600):
                reg, rec = reg_cls(), RuntimeRecorder()
                hook = hook_cls(rec, every_steps=3, registry=reg,
                                min_interval_s=floor)
                decode = reg.counter(tm.SERVE_DECODE_STEPS)
                for step in range(1, 11):
                    decode.inc()
                    hook.after_step(step, queue_len=step, slots=4)
                    # one report in flight at most: none is dropped
                    _wait_for(lambda: not hook._queue.qsize())
                hook.flush(slots=4)
                steps_sent.append([(p["step"], p["serve_queue_len"])
                                   for p in rec.runtime])
        assert steps_sent[:2] == steps_sent[2:]
        # 3, 6, 9 by the cadence, then the flush's 10; an hour's floor
        # lets the first through and the flush
        assert [s for s, _ in steps_sent[2]] == [3, 6, 9, 10]
        assert [s for s, _ in steps_sent[3]] == [3, 10]

    def test_no_empty_flush(self):
        reg, rec = MetricsRegistry(), RuntimeRecorder()
        hook = slo.ServeRuntimeReportHook(rec, every_steps=2, registry=reg,
                                          min_interval_s=0)
        hook.flush()
        assert rec.runtime == [] and hook._sender is None
        reg.counter(tm.SERVE_DECODE_STEPS).inc(2)
        hook.after_step(2)
        hook.flush()
        hook.flush()  # nothing landed since the last send
        assert [p["step"] for p in rec.runtime] == [2]

    def test_flush_join_is_bounded_on_a_dead_client(self, monkeypatch):
        monkeypatch.setattr(slo, "FLUSH_JOIN_S", 0.05)
        reg, block = MetricsRegistry(), threading.Event()
        failures = get_registry().counter(
            tm.NODE_RUNTIME_REPORT_FAILURES).value
        rec = RuntimeRecorder(block=block, fail=True)
        hook = slo.ServeRuntimeReportHook(rec, every_steps=1, registry=reg,
                                          min_interval_s=0)
        reg.counter(tm.SERVE_DECODE_STEPS).inc()
        hook.after_step(1)
        sender = hook._sender
        hook.flush()  # the sender is stuck in the client: flush returns
        assert hook._sender is None and sender.is_alive()
        block.set()
        sender.join(JOIN_S)
        assert not sender.is_alive()
        assert get_registry().counter(
            tm.NODE_RUNTIME_REPORT_FAILURES).value >= failures + 1

    def test_wired_for_a_client_that_reports(self, engines):
        rec = RuntimeRecorder()
        ex = engine.ServeExecutor(engines[1], router_client=rec)
        assert isinstance(ex._report_hook, slo.ServeRuntimeReportHook)
        assert engine.ServeExecutor(engines[1],
                                    router_client=Recorder())._report_hook \
            is None


# -- (i) the planner's decode term ------------------------------------------------


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=0), (a, b)


class TestDecodeTerm:
    @pytest.mark.parametrize("precision", ["f32", "bf16", "int8"])
    def test_equal_to_the_reference_over_a_grid(self, precision):
        jdev = jax_planner.DeviceSpec()
        dev = planner.DeviceSpec(**dataclasses.asdict(jdev))
        consts = dict(dispatch_s=jax_planner.HOST_DISPATCH_OVERHEAD_S,
                      max_efficiency=jax_planner.MAX_EFFICIENCY)
        n = 0
        for cfg, jcfg in ((TINY, JAX_TINY),
                          (llama.llama3_8b(num_layers=4),
                           jax_llama.llama3_8b(num_layers=4))):
            m = planner.model_spec_from_llama(cfg)
            jm = jax_planner.model_spec_from_llama(jcfg, global_batch=2)
            assert dataclasses.asdict(m) == {
                f.name: getattr(jm, f.name)
                for f in dataclasses.fields(planner.ModelSpec)}
            for slots, chunk, pool, k, rate, hit in (
                    (1, 8, 0, 0, -1.0, 0.0), (4, 16, 0, 4, 0.5, 0.0),
                    (8, 256, 128, 0, -1.0, 0.6), (16, 128, 8, 2, 1.0, 1.0),
                    (3, 300, 64, 4, -1.0, 0.25), (32, 64, 1, 8, 0.0, 0.9)):
                for devices, max_seq in ((1, 2048), (4, 48)):
                    got = planner.estimate_decode(
                        m, devices, slots, chunk, max_seq, precision,
                        prefix_pool_pages=pool, page_size=16,
                        prefix_hit_rate=hit, spec_draft_len=k,
                        spec_accept_rate=rate, device=dev, **consts)
                    want = jax_planner.estimate_decode(
                        jm, devices, slots, chunk, max_seq, precision,
                        prefix_pool_pages=pool, page_size=16,
                        prefix_hit_rate=hit, spec_draft_len=k,
                        spec_accept_rate=rate, device=jdev)
                    _close(got, want)
                    for fn, args in (
                            ("serve_cache_bytes", (slots, max_seq)),
                            ("serve_prefix_pool_bytes", (pool, 16)),
                            ("decode_kv_read_bytes", (slots, max_seq // 3))):
                        _close(getattr(planner, fn)(m, *args, precision),
                               getattr(jax_planner, fn)(jm, *args,
                                                        precision))
                    n += 1
        assert n == 24

    def test_defaults_are_the_cards(self):
        for layers in (32, 4):
            m = planner.model_spec_from_llama(
                llama.llama3_8b(num_layers=layers))
            est = planner.estimate_decode(m, 1, 8, 256, 2048)
            assert est["breakdown"]["dispatch_s"] == pytest.approx(
                planner.HOST_DISPATCH_PER_LAYER_S * layers, rel=1e-12)
        assert planner.HOST_DISPATCH_PER_LAYER_S * 4 != \
            jax_planner.HOST_DISPATCH_OVERHEAD_S
        assert est["breakdown"]["weight_read_s"] == pytest.approx(
            m.param_count * 2 / planner.DeviceSpec().hbm_bw, rel=1e-12)
        assert planner.DeviceSpec().hbm_bw == 3.35e12
        assert est["cache_bytes"] == kv_cache.KVCacheSpec.from_model(
            llama.llama3_8b(num_layers=4), num_slots=8, max_seq=2048,
            precision="f32").total_bytes()
