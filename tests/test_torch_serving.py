"""The port's serving tier against the JAX package's, on the CPU.

``llama_tiny`` in f32 with the reference's weights carried across by
``interop``. The same inputs go through both packages' KV-cache
geometry, int8 page format, rule tables, step functions (``decode_step``,
``verify_step``, ``prefill_chunk``, ``prefill_sequence``) on the same
cache state, and executors on the same submitted requests. Tolerances:
1e-5 on logits, 1e-6 of a cache leaf's largest magnitude on its
elements, exact on tokens, lengths and counters. Where the reference's logits put the top two tokens within
1e-4 of each other, a token test reports the position and does not
demand equality there. ``prefill_sequence`` is also held against the
port's own ``apply``: the last hidden row bit for bit, the first token
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops import quantize as jax_quantize
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.serving import engine as jax_engine
from dlrover_tpu.serving import kv_cache as jax_kv
from dlrover_tpu.telemetry import metrics as jax_metrics
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.ops import quantize
from dlrover_tpu_torch.serving import engine, kv_cache
from dlrover_tpu_torch.telemetry import EventKind, names as tm
from dlrover_tpu_torch.telemetry.events import clear_ring, recent_events
from dlrover_tpu_torch.telemetry.metrics import MetricsRegistry

LOGIT_TOL, CACHE_TOL, MARGIN = 1e-5, 1e-6, 1e-4
CPU = torch.device("cpu")
JAX_TINY = jax_llama.llama_tiny()
TINY = llama.llama_tiny()
PRECISIONS = ("f32", "bf16", "int8")
# the reference's step functions, jitted as its engine jits them (config
# and spec static): one trace per pool precision
REF = {name: jax.jit(getattr(jax_llama, name), static_argnums=static)
       for name, static in (("decode_step", (4, 5)), ("verify_step", (5, 6)),
                            ("prefill_chunk", (6, 7)),
                            ("prefill_sequence", (4, 5)))}


@pytest.fixture(autouse=True)
def _torch_settings():
    """f32 results are compared: no TF32; one CPU thread (the suite's
    other workers run beside these tests)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_num_threads(saved[1])


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jax_llama.init(jax.random.PRNGKey(0), JAX_TINY))


@pytest.fixture(scope="module")
def params(jax_params):
    return interop.params_from_numpy(jax_params, device="cpu")


def _prompt(n, seed):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(0, TINY.vocab_size, size=(n,))]


def _specs(precision, slots=2, max_seq=32, page=8):
    jspec = jax_kv.KVCacheSpec.from_model(
        JAX_TINY, num_slots=slots, max_seq=max_seq, page_size=page,
        precision=precision)
    spec = kv_cache.KVCacheSpec.from_model(
        TINY, num_slots=slots, max_seq=max_seq, page_size=page,
        precision=precision)
    return jspec, spec


def _np(cache):
    """A reference pool as numpy, bf16 pages widened to f32."""
    out = {}
    for name, a in jax.device_get(cache).items():
        a = np.asarray(a)
        out[name] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a
    return out


def _assert_cache(port_cache, ref_cache):
    got, want = interop.kv_cache_to_numpy(port_cache), _np(ref_cache)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        if name == "length":
            np.testing.assert_array_equal(got[name], want[name])
        else:
            # CACHE_TOL of the leaf's scale: the rows come out of f32
            # products whose summation order differs between XLA and
            # the port's BLAS (a few ulps at |x| ~ 1)
            scale = max(1.0, float(np.abs(want[name]).max()))
            np.testing.assert_allclose(got[name], want[name],
                                       atol=CACHE_TOL * scale, rtol=0,
                                       err_msg=name)


def _assert_tokens(got, want, ref_logits):
    """Tokens equal except where the reference's top-2 margin is under
    MARGIN (reported, not demanded)."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    logits = np.asarray(ref_logits).reshape(len(want), -1)
    top2 = np.sort(logits, axis=-1)[:, -2:]
    for i, (g, w) in enumerate(zip(got, want)):
        if top2[i, 1] - top2[i, 0] < MARGIN:
            print(f"position {i}: top-2 margin "
                  f"{top2[i, 1] - top2[i, 0]:.2e}, tokens {g} / {w}")
            continue
        assert g == w, (i, g, w)


def _ref_state(jax_params, jspec, seed=0):
    """A non-trivial reference pool: slot 0 prefilled with 11 tokens in
    two chunks, slot 1 with 5 (so decode writes rows 11 and 5)."""
    cache = jax_kv.init_kv_cache(jspec)
    jp = jax.tree.map(jnp.asarray, jax_params)
    for slot, n in ((0, 11), (1, 5)):
        toks = _prompt(n, seed + slot)
        for start in range(0, n, 8):
            chunk = toks[start:start + 8]
            padded = np.zeros((8,), np.int32)
            padded[:len(chunk)] = chunk
            cache, _ = REF["prefill_chunk"](
                jp, cache, jnp.asarray(padded), jnp.int32(slot),
                jnp.int32(start), jnp.int32(len(chunk)), JAX_TINY, jspec)
    return cache


# -- KV cache -----------------------------------------------------------------


class TestKVCache:
    @pytest.mark.parametrize("precision", PRECISIONS)
    @pytest.mark.parametrize("geometry", [(4, 30, 8, 0), (2, 48, 16, 6),
                                          (3, 128, 16, 2)])
    def test_spec_geometry_bytes_and_leaves_equal_the_reference(
            self, precision, geometry):
        slots, max_seq, page, pool = geometry
        kw = dict(num_slots=slots, max_seq=max_seq, page_size=page,
                  precision=precision, prefix_pool_pages=pool)
        theirs = jax_kv.KVCacheSpec.from_model(JAX_TINY, **kw)
        ours = kv_cache.KVCacheSpec.from_model(TINY, **kw)
        for attr in ("max_seq", "pages_per_slot", "quant_block",
                     "scale_blocks", "precision"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        for fn in ("bytes_per_slot", "prefix_page_bytes",
                   "prefix_pool_bytes", "total_bytes"):
            assert getattr(ours, fn)() == getattr(theirs, fn)(), fn
        for port_fn, ref_fn in ((kv_cache.init_kv_cache,
                                 jax_kv.init_kv_cache),
                                (kv_cache.init_prefix_pool,
                                 jax_kv.init_prefix_pool)):
            got = interop.kv_cache_to_numpy(port_fn(ours))
            want = _np(ref_fn(theirs))
            assert got.keys() == want.keys()
            for name in want:
                np.testing.assert_array_equal(got[name], want[name])

    @settings(max_examples=15, deadline=None)
    @given(lead=st.lists(st.integers(1, 4), min_size=1, max_size=3),
           blocks=st.integers(1, 4), block=st.sampled_from([1, 3, 8, 16]),
           scale=st.sampled_from([1e-30, 1e-3, 1.0, 300.0]),
           zero_block=st.booleans(), seed=st.integers(0, 2 ** 16))
    def test_int8_encode_decode_bitwise(self, lead, blocks, block, scale,
                                        zero_block, seed):
        d = blocks * block
        x = (np.random.RandomState(seed).randn(*lead, d) * scale).astype(
            np.float32)
        if zero_block:
            x[..., :block] = 0.0
        v, s = quantize.quantize_block_scaled_int8(torch.from_numpy(x),
                                                   block)
        jv, js = jax_quantize.quantize_block_scaled_int8(jnp.asarray(x),
                                                         block)
        assert v.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        back = quantize.dequantize_block_scaled_int8(v, s)
        jback = jax_quantize.dequantize_block_scaled_int8(jv, js)
        np.testing.assert_array_equal(back.numpy(), np.asarray(jback))
        assert int(v.abs().max()) <= 127

    @pytest.mark.parametrize("sizes", [
        {"data": 1, "fsdp": 1, "tensor": 1},
        {"data": 2, "fsdp": 2, "tensor": 2},
        {"data": 4, "fsdp": 1, "tensor": 2},
        {"data": 1, "fsdp": 8, "tensor": 1},
    ], ids=lambda s: "x".join(str(v) for v in s.values()))
    @pytest.mark.parametrize("base", ["llama", "fsdp", "moe"])
    def test_rule_specs_leaf_for_leaf(self, jax_params, sizes, base):
        sizes = {"pipe": 1, "seq": 1, **sizes}
        spec = kv_cache.KVCacheSpec.from_model(
            TINY, num_slots=4, max_seq=32, page_size=8, precision="int8",
            prefix_pool_pages=4)
        tree = {"params": jax_params,
                "cache": kv_cache.cache_shapes(spec),
                "prefix": kv_cache.cache_shapes(spec, 4)}
        theirs, ours = jax_kv.kv_cache_rules(base), kv_cache.kv_cache_rules(
            base)
        from dlrover_tpu_torch.parallel.sharding_rules import _named_shapes

        leaves = _named_shapes(tree)
        assert len(leaves) == 12 + 5 + 4
        for path, shape in leaves:
            assert ours.spec_for(path, shape, sizes) == theirs.spec_for(
                path, shape, sizes), path

    def test_serve_shardings_one_device_and_refuses_several(self):
        spec = kv_cache.KVCacheSpec.from_model(TINY, num_slots=2,
                                               prefix_pool_pages=2)
        one = kv_cache.serve_shardings(
            {"data": 1, "fsdp": 1, "tensor": 1}, spec,
            llama.param_shapes(TINY))
        assert set(one) == {"params", "cache", "prefix"}
        assert one["cache"]["k"] == (None,) * 5
        assert all(s == (None,) * len(s) for part in one.values()
                   for s in part.values())
        with pytest.raises(NotImplementedError, match="A16c"):
            kv_cache.serve_shardings({"data": 2}, spec,
                                     llama.param_shapes(TINY))

    def test_precision_resolution(self, monkeypatch):
        assert kv_cache.resolve_kv_precision("bf16") == "bf16"
        assert kv_cache.resolve_kv_precision("") == "f32"  # the knob
        with pytest.raises(ValueError):
            kv_cache.resolve_kv_precision("fp4")
        monkeypatch.setattr(kv_cache, "int8_kv_supported", lambda: False)
        assert kv_cache.resolve_kv_precision("int8") == "f32"

    def test_fit_prefill_chunk_on_the_reference_cases(self):
        for req, depth in ((32, 48), (8, 48), (500, 48), (256, 2048),
                           (7, 30), (1, 1)):
            assert engine._fit_prefill_chunk(req, depth) == \
                jax_engine._fit_prefill_chunk(req, depth)
        assert engine._fit_prefill_chunk(32, 48) == 24


# -- the step functions on the same cache state -------------------------------


class TestStepsAgainstReference:
    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_decode_step(self, jax_params, params, precision):
        jspec, spec = _specs(precision)
        ref = _ref_state(jax_params, jspec)
        cache = interop.kv_cache_from_numpy(jax.device_get(ref), "cpu")
        jp = jax.tree.map(jnp.asarray, jax_params)
        for step, (tokens, active) in enumerate((([7, 99], [True, True]),
                                                 ([3, 12], [True, False]))):
            jt, jl, ref = REF["decode_step"](
                jp, ref, jnp.asarray(tokens, jnp.int32), jnp.asarray(active),
                JAX_TINY, jspec)
            nt, lg, cache = llama.decode_step(
                params, cache, torch.tensor(tokens, dtype=torch.int32),
                torch.tensor(active), TINY, spec)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                       atol=LOGIT_TOL, rtol=0)
            assert nt.dtype == torch.int32
            _assert_tokens(nt.numpy(), jt, jl)
            _assert_cache(cache, ref)

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_verify_step(self, jax_params, params, precision):
        jspec, spec = _specs(precision)
        ref = _ref_state(jax_params, jspec, seed=4)
        cache = interop.kv_cache_from_numpy(jax.device_get(ref), "cpu")
        jp = jax.tree.map(jnp.asarray, jax_params)
        # slot 0's drafts are the reference's own greedy continuation
        # (accepted), slot 1's are not; slot 1 drafts two of three
        probe = REF["verify_step"](
            jp, jax.tree.map(jnp.copy, ref),
            jnp.asarray([[5, 0, 0, 0], [9, 0, 0, 0]], jnp.int32),
            jnp.asarray([True, True]), jnp.asarray([0, 0], jnp.int32),
            JAX_TINY, jspec)[0]
        g = int(probe[0, 0])
        tokens = np.asarray([[5, g, 1, 2], [9, 4, 4, 0]], np.int32)
        n_draft = np.asarray([3, 2], np.int32)
        for active in ([True, True], [False, True]):
            out = REF["verify_step"](
                jp, ref, jnp.asarray(tokens), jnp.asarray(active),
                jnp.asarray(n_draft), JAX_TINY, jspec)
            jg, ja, jn, ref = out
            greedy, acc, nxt, cache = llama.verify_step(
                params, cache, torch.from_numpy(tokens),
                torch.tensor(active), torch.from_numpy(n_draft), TINY,
                spec)
            np.testing.assert_array_equal(greedy.numpy(), np.asarray(jg))
            np.testing.assert_array_equal(acc.numpy(), np.asarray(ja))
            np.testing.assert_array_equal(nxt.numpy(), np.asarray(jn))
            _assert_cache(cache, ref)

    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_prefill_chunk(self, jax_params, params, precision):
        jspec, spec = _specs(precision)
        ref = _ref_state(jax_params, jspec, seed=8)
        cache = interop.kv_cache_from_numpy(jax.device_get(ref), "cpu")
        jp = jax.tree.map(jnp.asarray, jax_params)
        # slot 1's second chunk (rows 8..15, 5 valid) over its first
        toks = np.asarray(_prompt(8, 20), np.int32)
        toks[5:] = 0
        ref, jl = REF["prefill_chunk"](
            jp, ref, jnp.asarray(toks), jnp.int32(1), jnp.int32(8),
            jnp.int32(5), JAX_TINY, jspec)
        cache, lg = llama.prefill_chunk(params, cache, torch.from_numpy(toks),
                                        1, 8, 5, TINY, spec)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        _assert_cache(cache, ref)

    @pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
    @pytest.mark.parametrize("precision", PRECISIONS)
    def test_prefill_sequence(self, jax_params, params, precision, moe):
        jcfg, cfg = JAX_TINY, TINY
        jp, p = jax_params, params
        if moe:
            jcfg = jax_llama.llama_tiny(num_experts=4, moe_top_k=2)
            cfg = llama.llama_tiny(num_experts=4, moe_top_k=2)
            jp = jax.device_get(jax_llama.init(jax.random.PRNGKey(1), jcfg))
            p = interop.params_from_numpy(jp, device="cpu")
        jspec, spec = _specs(precision)
        ref = _ref_state(jax_params, jspec)
        cache = interop.kv_cache_from_numpy(jax.device_get(ref), "cpu")
        toks = np.asarray(_prompt(13, 30), np.int32)
        ref, jl = REF["prefill_sequence"](
            jax.tree.map(jnp.asarray, jp), ref, jnp.asarray(toks),
            jnp.int32(1), jcfg, jspec)
        cache, lg = llama.prefill_sequence(p, cache, torch.from_numpy(toks),
                                           1, cfg, spec)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL, rtol=0)
        _assert_cache(cache, ref)

    def test_dense_only_steps_refuse_experts(self, params):
        cfg = llama.llama_tiny(num_experts=4)
        spec = kv_cache.KVCacheSpec.from_model(cfg, num_slots=1)
        cache = kv_cache.init_kv_cache(spec)
        tok = torch.zeros((1,), dtype=torch.int32)
        with pytest.raises(NotImplementedError, match="MoE"):
            llama.decode_step(params, cache, tok, torch.ones(1, dtype=bool),
                              cfg, spec)
        with pytest.raises(NotImplementedError, match="MoE"):
            llama.prefill_chunk(params, cache, tok, 0, 0, 1, cfg, spec)
        with pytest.raises(NotImplementedError, match="MoE"):
            llama.verify_step(params, cache, tok[None],
                              torch.ones(1, dtype=bool), tok, cfg, spec)


class TestAgainstTheForward:
    def test_prefill_sequence_is_the_training_forward(self, params):
        """The last hidden row bit for bit ``apply_hidden``'s, the first
        token ``apply``'s argmax; the logits bit for bit unless the
        one-row head product differs from the whole row's, then within
        LOGIT_TOL."""
        toks = torch.tensor(_prompt(9, 3), dtype=torch.int32)
        spec = kv_cache.KVCacheSpec.from_model(TINY, num_slots=2,
                                               max_seq=16, page_size=8)
        cache, last, hidden = llama.prefill_sequence(
            params, kv_cache.init_kv_cache(spec), toks, 1, TINY, spec,
            return_hidden=True)
        with torch.no_grad():
            want_h, _ = llama.apply_hidden(params, toks[None].long(), TINY)
            want, _ = llama.apply(params, toks[None].long(), TINY)
        assert torch.equal(hidden, want_h[0, -1])
        assert int(last.argmax()) == int(want[0, -1].argmax())
        if not torch.equal(last, want[0, -1]):
            err = (last - want[0, -1]).abs().max().item()
            print(f"one-row head: max |logit difference| {err:.3e}")
            assert err < LOGIT_TOL
        assert int(cache["length"][1]) == 9

    @pytest.mark.parametrize("precision,tol", [("f32", LOGIT_TOL),
                                               ("int8", 0.25)])
    def test_prefill_plus_decode_within_tolerance_of_apply(
            self, params, precision, tol):
        """Chunked prefill then teacher-forced decode, per position,
        against the port's own one-shot forward (the int8 pool within
        the reference's documented 0.25)."""
        p_len, new = 10, 5
        seq = _prompt(p_len + new, 1)
        with torch.no_grad():
            want, _ = llama.apply(params, torch.tensor([seq]), TINY)
        want = want[0]
        spec = kv_cache.KVCacheSpec.from_model(
            TINY, num_slots=2, max_seq=32, page_size=8, precision=precision)
        cache = kv_cache.init_kv_cache(spec)
        for start in range(0, p_len, 4):
            chunk = seq[start:min(start + 4, p_len)]
            padded = torch.zeros((4,), dtype=torch.int32)
            padded[:len(chunk)] = torch.tensor(chunk)
            cache, last = llama.prefill_chunk(params, cache, padded, 0,
                                              start, len(chunk), TINY, spec)
        worst = (last - want[p_len - 1]).abs().max().item()
        active = torch.tensor([True, False])
        for j in range(new - 1):
            tokens = torch.tensor([seq[p_len + j], 0], dtype=torch.int32)
            _nt, logits, cache = llama.decode_step(params, cache, tokens,
                                                   active, TINY, spec)
            worst = max(worst,
                        (logits[0] - want[p_len + j]).abs().max().item())
        assert worst < tol, worst
        assert cache["length"].tolist() == [p_len + new - 1, 0]


# -- the executor -------------------------------------------------------------

# (request id, prompt length, max new tokens, seed): one prompt inside a
# chunk, three over several chunks, an oversized one that cannot fit
WORKLOAD = [("a", 5, 6, 40), ("b", 13, 4, 41), ("c", 20, 7, 42),
            ("huge", 6, 500, 43), ("d", 30, 3, 44), ("e", 3, 9, 45),
            ("f", 9, 5, 46)]


@pytest.fixture(scope="module")
def ref_engine(jax_params):
    eng = jax_engine.ServeEngine(
        JAX_TINY, strategy=JaxStrategy(mesh=JaxMeshPlan(data=-1),
                                       rule_set="llama"),
        serve_slots=4, prefill_chunk=8, max_seq=48, page_size=8,
        devices=jax.devices()[:1])
    eng.prepare(jax.tree.map(jnp.asarray, jax_params))
    return eng


@pytest.fixture(scope="module")
def port_engine(params):
    eng = engine.ServeEngine(TINY, serve_slots=4, prefill_chunk=8,
                             max_seq=48, page_size=8, devices=[CPU])
    eng.prepare(params)
    return eng


def _run(eng, executor_cls, registry, admission):
    eng.cache = eng.fresh_cache()
    ex = executor_cls(eng, admission=admission, serve_window=2,
                      registry=registry)
    for rid, n, new, seed in WORKLOAD:
        ex.submit(_prompt(n, seed), max_new_tokens=new, request_id=rid)
    return {r["request_id"]: r for r in ex.serve()}, ex


class TestExecutorAgainstReference:
    @pytest.mark.parametrize("admission", ["continuous", "static"])
    def test_tokens_and_counters_equal(self, ref_engine, port_engine,
                                       admission):
        clear_ring()
        jreg, reg = jax_metrics.MetricsRegistry(), MetricsRegistry()
        want, jex = _run(ref_engine, jax_engine.ServeExecutor, jreg,
                         admission)
        got, ex = _run(port_engine, engine.ServeExecutor, reg, admission)
        assert got.keys() == want.keys()
        for rid in want:
            assert got[rid]["tokens"] == want[rid]["tokens"], rid
            assert got[rid]["error_code"] == want[rid]["error_code"], rid
        assert got["huge"]["error_code"] == "SERVE_REQUEST_EVICTED"
        assert got["huge"]["tokens"] == []
        assert len(got["d"]["tokens"]) == 3
        assert ex.decode_steps == jex.decode_steps
        for name in (tm.SERVE_PREFILL_CHUNKS, tm.SERVE_ADMISSIONS,
                     tm.SERVE_DECODE_STEPS, tm.SERVE_TOKENS):
            assert reg.get(name).value == jreg.get(name).value, name
        # 1 + 2 + 3 + 4 + 1 + 2 chunks of 8
        assert reg.get(tm.SERVE_PREFILL_CHUNKS).value == 13
        evicted = [e for e in recent_events()
                   if e["kind"] == EventKind.SERVE_REQUEST_EVICTED]
        assert evicted and evicted[-1]["error_code"] == \
            "SERVE_REQUEST_EVICTED"
        ledger = ex.slot_ledger()
        classes = sum(v for k, v in ledger.items()
                      if k not in ("slot_seconds", "serve_wall_s"))
        assert classes == pytest.approx(ledger["slot_seconds"], abs=1e-5)
        assert port_engine.compile_count == 1

    def test_router_client_leases_and_completes(self, port_engine):
        class Client:
            def __init__(self):
                self.queue = [{"request_id": "x", "prompt": _prompt(7, 50),
                               "max_new_tokens": 4, "trace_id": "req-x"}]
                self.done, self.touched = [], 0

            def serve_lease(self, max_requests):
                out, self.queue = (self.queue[:max_requests],
                                   self.queue[max_requests:])
                return out

            def serve_complete(self, **record):
                self.done.append(record)

            def serve_touch(self):
                self.touched += 1

        port_engine.cache = port_engine.fresh_cache()
        client = Client()
        local = engine.ServeExecutor(port_engine, serve_window=1)
        local.submit(_prompt(7, 50), max_new_tokens=4, request_id="x")
        want = local.serve()[0]["tokens"]
        port_engine.cache = port_engine.fresh_cache()
        done = engine.ServeExecutor(port_engine, router_client=client,
                                    serve_window=1).serve()
        assert [r["request_id"] for r in done] == ["x"]
        assert client.done[0]["tokens"] == want and client.touched == 1
        assert "queue_wait_s" not in client.done[0]

    def test_engine_defaults_to_the_card_and_refuses_what_waits(
            self, params, jax_params):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                engine.ServeEngine(TINY)
        with pytest.raises(NotImplementedError, match="A16c"):
            engine.ServeEngine(TINY, devices=[CPU, CPU])
        eng = engine.ServeEngine(TINY, serve_slots=2, devices=[CPU])
        eng.prepare(params)
        # the elastic calls run on one device; several raise
        assert eng.prewarm(serve_slots=4) is True
        assert eng.retune(serve_slots=4) == 0
        assert eng.program.spec.num_slots == 4
        assert set(eng.snapshot().tree) >= {"cache/k", "cache/length"}
        assert eng.live_resize([CPU]) == 0
        with pytest.raises(NotImplementedError, match="A16c"):
            eng.live_resize([CPU, CPU])
        ex = engine.ServeExecutor(eng)
        ex.request_retune(serve_slots=2)
        ex.request_resize([CPU])
        ex.serve()
        assert eng.program.spec.num_slots == 2
        ex.request_resize([CPU, CPU])
        with pytest.raises(NotImplementedError, match="A16c"):
            ex.serve()
        # the serving copy holds its own memory in the compute dtype
        leaf = params["layers"]["q_proj"]["kernel"]
        served = eng.params["layers"]["q_proj"]["kernel"]
        assert served.dtype == TINY.compute_dtype
        assert served.data_ptr() != leaf.data_ptr()
        assert torch.equal(served, leaf)
        # a numpy tree (the reference's, device_get) places the same way
        eng.prepare(jax_params)
        assert torch.equal(eng.params["layers"]["q_proj"]["kernel"], leaf)


# -- promotion ----------------------------------------------------------------


class TestPromotion:
    def test_snapshot_and_checkpoint_promote_with_exact_logits(
            self, params, port_engine, tmp_path):
        """A trained state promoted through ``HostSnapshot`` and through
        a DCP checkpoint serves the first-token logits of a direct
        ``prefill_sequence`` on the trained weights, bit for bit."""
        from dlrover_tpu_torch.checkpoint import (
            ElasticCheckpointManager,
            HostSnapshot,
        )
        from dlrover_tpu_torch.models.common import tree_leaves, tree_map
        from dlrover_tpu_torch.parallel.accelerate import TrainState

        trained = tree_map(lambda t: (t + 0.01 * torch.randn(
            t.shape, generator=torch.Generator().manual_seed(t.numel()))
            ).requires_grad_(), params)
        opt = torch.optim.AdamW(tree_leaves(trained), lr=1e-3)
        state = TrainState(step=3, params=trained, opt_state=opt)
        seq = torch.tensor(_prompt(7, 5), dtype=torch.int32)
        spec = port_engine.program.spec

        def served(eng_params):
            _c, last = llama.prefill_sequence(
                eng_params, port_engine.fresh_cache(), seq, 0, TINY, spec)
            return last

        with torch.no_grad():
            want = served(tree_map(lambda t: t.detach().clone(), trained))
        try:
            port_engine.load_from_snapshot(HostSnapshot.take(state))
            assert torch.equal(served(port_engine.params), want)
            mgr = ElasticCheckpointManager(str(tmp_path / "ckpt"),
                                           async_save=False, staging_dir="")
            mgr.save(3, state, force=True)
            mgr.close()
            port_engine.load_from_snapshot(params)
            assert not torch.equal(served(port_engine.params), want)
            assert port_engine.load_from_checkpoint(
                str(tmp_path / "ckpt")) == 3
            assert torch.equal(served(port_engine.params), want)
            assert port_engine.load_from_checkpoint(
                str(tmp_path / "empty")) is None
        finally:
            port_engine.load_from_snapshot(params)


def test_interop_round_trips_a_reference_pool():
    jspec = jax_kv.KVCacheSpec.from_model(
        JAX_TINY, num_slots=2, max_seq=16, page_size=8, precision="bf16",
        prefix_pool_pages=2)
    ref = jax_kv.init_kv_cache(jspec)
    ref = dict(ref, k=ref["k"] + jnp.asarray(1.5, jnp.bfloat16),
               length=jnp.asarray([3, 9], jnp.int32))
    cache = interop.kv_cache_from_numpy(jax.device_get(ref), "cpu")
    assert cache["k"].dtype == torch.bfloat16
    assert cache["length"].dtype == torch.int32
    _assert_cache(cache, ref)
    pool = interop.prefix_pool_from_numpy(
        jax.device_get(jax_kv.init_prefix_pool(jspec)), "cpu")
    assert set(pool) == {"k", "v"}
    back = interop.prefix_pool_to_numpy(pool)
    assert back["k"].shape == (2, 2, 8, 2, 16)
    assert dataclasses.asdict(kv_cache.KVCacheSpec.from_model(
        TINY, num_slots=2, max_seq=16, page_size=8, precision="bf16",
        prefix_pool_pages=2)) == dataclasses.asdict(jspec)


def test_serve_names_knobs_and_kv_price_equal_the_reference():
    """The SERVE_* metric, event and span names, the serve knobs'
    defaults and ``kv_bytes_per_elem`` are the reference's."""
    from dlrover_tpu.common.config import Context as JaxContext
    from dlrover_tpu.parallel import planner as jax_planner
    from dlrover_tpu.telemetry import names as jax_names
    from dlrover_tpu_torch.common.config import Context
    from dlrover_tpu_torch.parallel import planner

    pairs = [(tm, jax_names)] + [(getattr(tm, c), getattr(jax_names, c))
                                 for c in ("EventKind", "SpanName")]
    count = 0
    for ours, theirs in pairs:
        for name in vars(ours):
            if name.startswith("SERVE_"):
                assert getattr(ours, name) == getattr(theirs, name), name
                count += 1
    assert count == 20 + 13 + 2
    knobs = {k: v for k, v in vars(Context()).items()
             if k.startswith("serve_")}
    assert len(knobs) == 7
    theirs = vars(JaxContext())
    assert knobs == {k: theirs[k] for k in knobs}
    for precision in ("f32", "bf16", "int8"):
        for channels in (0, 16, 128, 80):
            assert planner.kv_bytes_per_elem(precision, channels) == \
                jax_planner.kv_bytes_per_elem(precision, channels)
