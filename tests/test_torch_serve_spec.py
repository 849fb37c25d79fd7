"""Prefix reuse and speculative decode in the port's serving tier, on the
CPU.

The host structures (``NgramProposer``, ``PrefixIndex``) are held
against the JAX package's on the same random operation sequences. The
serving promises are held inside the port, bit for bit: the prefix pool
on gives the tokens and the admitted slots' pages of the pool off, at
every hit length; speculative decode gives the plain greedy stream under
forced acceptance patterns (always right, always wrong, alternating,
mixed draft lengths per slot), on the int8 pool, and composed with
prefix reuse; a verify step that raises falls back to one plain decode
step with the draft credit restored; the program is built once.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from dlrover_tpu.serving import prefix_index as jax_prefix_index
from dlrover_tpu.serving import spec_decode as jax_spec_decode
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.serving import engine, prefix_index, spec_decode

TINY = llama.llama_tiny()
CPU = torch.device("cpu")
GEOMETRY = dict(serve_slots=4, prefill_chunk=8, max_seq=48, page_size=8)


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def params():
    import jax

    from dlrover_tpu.models import llama as jax_llama

    return interop.params_from_numpy(jax.device_get(jax_llama.init(
        jax.random.PRNGKey(0), jax_llama.llama_tiny())), device="cpu")


def _engine(params, **kw):
    eng = engine.ServeEngine(TINY, devices=[CPU], **{**GEOMETRY, **kw})
    eng.prepare(params)
    return eng


@pytest.fixture(scope="module")
def plain(params):
    return _engine(params)


@pytest.fixture(scope="module")
def spec(params):
    return _engine(params, spec_draft_len=4)


def _prompt(n, seed):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(0, TINY.vocab_size, size=(n,))]


def _jobs(n=4, max_new=10, seed0=50, plen=6):
    return [(f"r{i}", _prompt(plen, seed0 + i), max_new) for i in range(n)]


def _serve(eng, jobs, proposer=None, fresh=True):
    if fresh:
        eng.cache = eng.fresh_cache()
    ex = engine.ServeExecutor(eng, serve_window=1, spec_proposer=proposer)
    for rid, prompt, max_new in jobs:
        ex.submit(prompt, max_new_tokens=max_new, request_id=rid)
    return {r["request_id"]: r for r in ex.serve()}, ex


# -- the host structures against the reference's ------------------------------


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 3), st.integers(0, 6)),
                    min_size=1, max_size=30),
       alphabet=st.integers(2, 5), max_ngram=st.integers(1, 4))
def test_ngram_proposer_matches_the_reference(ops, alphabet, max_ngram):
    """The same appends and proposals (history from a small alphabet, so
    n-grams recur) give the same drafts."""
    ours = spec_decode.NgramProposer(max_ngram=max_ngram)
    theirs = jax_spec_decode.NgramProposer(max_ngram=max_ngram)
    history = []
    for token, k in ops:
        history.append(token % alphabet)
        assert ours.propose(history, k) == theirs.propose(history, k)


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.tuples(st.sampled_from(["publish", "match",
                                                "release", "flush"]),
                              st.integers(0, 7), st.integers(1, 6),
                              st.integers(0, 5), st.integers(1, 2)),
                    min_size=1, max_size=25),
       capacity=st.integers(0, 6))
def test_prefix_index_matches_the_reference(ops, capacity):
    """The same publishes, pinned matches, releases and flushes over
    prompts sharing heads give the same pages, handles and counters."""
    page = 4
    heads = [_prompt(24, s) for s in range(3)]
    ours = prefix_index.PrefixIndex(page, capacity)
    theirs = jax_prefix_index.PrefixIndex(page, capacity)
    handles = []
    for op, which, pages, cap, align in ops:
        tokens = heads[which % 3][:pages * page] + [which] * (which % 3)
        if op == "publish":
            assert ours.publish(tokens) == theirs.publish(tokens)
        elif op == "match":
            a = ours.match(tokens, max_pages=cap or None, align_pages=align)
            b = theirs.match(tokens, max_pages=cap or None,
                             align_pages=align)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a.pages, a.tokens) == (b.pages, b.tokens)
                handles.append((a, b))
        elif op == "release" and handles:
            a, b = handles.pop(which % len(handles))
            ours.release(a)
            theirs.release(b)
        elif op == "flush":
            ours.flush()
            theirs.flush()
        assert ours.stats() == theirs.stats()
        assert ours.free_pages == theirs.free_pages


# -- prefix reuse -------------------------------------------------------------


def test_prefix_reuse_is_bitwise_at_every_hit_length(plain, params):
    """Queries sharing 8..40 tokens of a published 40-token prompt hit
    at every multiple of lcm(page, chunk) = 8 below their own length,
    and give the pool-off tokens and pages bit for bit."""
    pooled = _engine(params, prefix_pool_pages=12)
    seed_prompt = _prompt(40, 70)
    _serve(pooled, [("seed", seed_prompt, 2)])
    hits = []
    for shared in (8, 16, 24, 32, 40):
        query = seed_prompt[:shared] + _prompt(2, 100 + shared)
        want, _ = _serve(plain, [("q", query, 6)])
        want_cache = plain.cache
        got, _ = _serve(pooled, [("q", query, 6)])
        assert len(want["q"]["tokens"]) == 6
        assert got["q"]["tokens"] == want["q"]["tokens"], shared
        hits.append(got["q"]["prefix_hit_tokens"])
        rows = int(want_cache["length"][0])
        assert rows >= len(query) + 5
        for name in ("k", "v"):
            assert torch.equal(pooled.cache[name][:, 0, :rows],
                               want_cache[name][:, 0, :rows]), (shared, name)
    assert hits == [8, 16, 24, 32, 40]
    assert pooled.prefix_stats()["hits"] == 5
    assert pooled.compile_count == 1


# -- speculative decode -------------------------------------------------------


class _Oracle:
    """Drafts the true greedy continuation (from a plain serve): 100%
    acceptance."""

    def __init__(self, refs):
        self._refs = dict(refs)

    def _stream(self, history):
        for p, stream in self._refs.items():
            if len(history) >= len(p) and tuple(history[:len(p)]) == p:
                return stream, len(history) - len(p)
        return None, 0

    def propose(self, history, k):
        stream, done = self._stream(history)
        return [] if stream is None else list(stream[done:done + k])


class _Wrong(_Oracle):
    """The true next tokens plus one: 0% acceptance, full drafts."""

    def propose(self, history, k):
        return [(t + 1) % TINY.vocab_size
                for t in super().propose(history, k)]


class _Alternating(_Oracle):
    """Right on one verify step, wrong on the next."""

    def __init__(self, refs):
        super().__init__(refs)
        self._n = 0

    def propose(self, history, k):
        right = super().propose(history, k)
        self._n += 1
        return right if self._n % 2 else [(t + 1) % TINY.vocab_size
                                          for t in right]


class _Mixed(_Oracle):
    """Full drafts for some prompts, half for others, none for the rest
    (mixed draft lengths in one verify step)."""

    def __init__(self, refs, full, short):
        super().__init__(refs)
        self._full, self._short = tuple(full), tuple(short)

    def propose(self, history, k):
        stream, done = self._stream(history)
        if stream is None:
            return []
        head = tuple(history[:len(self._full)])
        if head == self._full:
            return list(stream[done:done + k])
        if tuple(history[:len(self._short)]) == self._short:
            return list(stream[done:done + max(1, k // 2)])
        return []


def _refs(expect, jobs):
    return {tuple(p): expect[rid] for rid, p, _ in jobs}


def test_forced_acceptance_patterns_are_plain_greedy(plain, spec):
    jobs = _jobs(4, max_new=10)
    expect = {rid: r["tokens"] for rid, r in _serve(plain, jobs)[0].items()}
    refs = _refs(expect, jobs)
    legs = {"ngram": None, "wrong": lambda: _Wrong(refs),
            "oracle": lambda: _Oracle(refs),
            "alternating": lambda: _Alternating(refs),
            "mixed": lambda: _Mixed(refs, jobs[0][1], jobs[1][1])}
    for name, factory in legs.items():
        got, ex = _serve(spec, jobs, proposer=factory)
        for rid, _, _ in jobs:
            assert got[rid]["tokens"] == expect[rid], (name, rid)
            d = got[rid]["spec_drafted_tokens"]
            a = got[rid]["spec_accepted_tokens"]
            assert 0 <= a <= d, (name, rid)
            if name == "oracle":
                assert d > 0 and a == d, (rid, d, a)
            if name == "wrong":
                assert d > 0 and a == 0, (rid, d, a)
        if name == "mixed":
            assert got["r0"]["spec_drafted_tokens"] \
                > got["r1"]["spec_drafted_tokens"] > 0
            assert got["r2"]["spec_drafted_tokens"] == 0
    assert spec.compile_count == 1


def test_int8_pool_spec_is_plain_greedy(params):
    jobs = _jobs(3, max_new=8, seed0=90)
    plain8 = _engine(params, kv_precision="int8", serve_slots=2)
    spec8 = _engine(params, kv_precision="int8", serve_slots=2,
                    spec_draft_len=3)
    expect = {rid: r["tokens"] for rid, r in _serve(plain8, jobs)[0].items()}
    refs = _refs(expect, jobs)
    for factory in (None, lambda: _Oracle(refs)):
        got, _ = _serve(spec8, jobs, proposer=factory)
        for rid, _, _ in jobs:
            assert got[rid]["tokens"] == expect[rid], rid


def test_prefix_reuse_composes_with_spec(plain, params):
    eng = _engine(params, prefix_pool_pages=8, spec_draft_len=4)
    seed_prompt = _prompt(24, 70)
    _serve(eng, [("seed", seed_prompt, 2)])
    want, _ = _serve(plain, [("q", seed_prompt, 6)])
    got, _ = _serve(eng, [("q", seed_prompt, 6)])
    assert got["q"]["prefix_hit_tokens"] == 16
    assert got["q"]["tokens"] == want["q"]["tokens"]


def test_failed_verify_falls_back_with_the_draft_credit_restored(plain,
                                                                  spec):
    """A verify call that raises commits nothing (``length`` is its last
    write), charges no draft, and the batch takes one plain decode step:
    the same stream."""
    jobs = _jobs(2, max_new=8, seed0=160)
    expect = {rid: r["tokens"] for rid, r in _serve(plain, jobs)[0].items()}
    refs = _refs(expect, jobs)
    spec.cache = spec.fresh_cache()
    program = spec.program
    orig, calls = program.verify, []

    def flaky(params, cache, *args):
        calls.append(1)
        if len(calls) == 1:
            # fail midway: rows written past the committed length
            cache["k"][:, :, -1] = 7.0
            raise RuntimeError("injected verify failure")
        return orig(params, cache, *args)

    program.verify = flaky
    try:
        got, ex = _serve(spec, jobs, proposer=lambda: _Oracle(refs),
                         fresh=False)
    finally:
        program.verify = orig
    for rid, _, _ in jobs:
        assert got[rid]["tokens"] == expect[rid], rid
    assert len(calls) >= 2
    drafted = sum(r["spec_drafted_tokens"] for r in got.values())
    accepted = sum(r["spec_accepted_tokens"] for r in got.values())
    assert drafted > 0 and accepted == drafted


def test_compile_count_pinned_over_32_steps(plain, spec):
    jobs = [("pin", _prompt(6, 200), 36)]
    expect, _ = _serve(plain, jobs)
    refs = {tuple(jobs[0][1]): expect["pin"]["tokens"]}
    compiles = (plain.compile_count, spec.compile_count)
    got, ex = _serve(spec, jobs, proposer=lambda: _Wrong(refs))
    assert got["pin"]["tokens"] == expect["pin"]["tokens"]
    assert ex.decode_steps >= 32
    got, ex = _serve(spec, jobs, proposer=lambda: _Oracle(refs))
    assert got["pin"]["tokens"] == expect["pin"]["tokens"]
    assert ex.decode_steps < 32
    _, ex = _serve(plain, jobs)
    assert ex.decode_steps >= 32
    assert (plain.compile_count, spec.compile_count) == compiles == (1, 1)
