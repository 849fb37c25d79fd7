"""The FSDP layer prefetch (ROADMAP A6b: ``parallel.layer_prefetch``,
``models.llama``'s layer source, ``ops.ring``'s asynchronous exchanges
and their staging) against the whole-tree FSDP step and against the JAX
package's ``fsdp_prefetch``.

The port's ranks are spawned gloo processes on the CPU (rank functions
in ``tests/torch_prefetch_workers.py``): two ranks at (data, fsdp) =
(1, 2) and four at (1, 4) and (2, 2), ``llama_tiny`` at 4 layers, three
SGD steps a run, the prefetch off and on from the same weights and
batches. Each spawn runs once per module, joined under its timeout.

Tolerances (f32 on the CPU):
  - (1, 2), prefetch on against off: losses, every block gradient and
    every block after the last step bit for bit (the layer's gradient is
    the same sum of two ranks' values, and a sum of two commutes), dense
    and under the fp8 and fp8_qdq wires; fp8 against fp8_qdq with the
    prefetch on bit for bit, as the reference pins;
  - four ranks and two microbatches: 1e-6 relative on the losses, 1e-6
    absolute on the blocks (the sums group differently);
  - ``moe_ep`` at (2, 2): 1e-4 relative, ``tests/test_torch_ep.py``'s;
  - one device: the port's ``apply`` with the prefetch on within 1e-5 of
    the reference's ``apply(fsdp_prefetch=True)`` (its own pin against
    its plain scan), and bit for bit the port's with it off.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_prefetch_workers as workers
from dlrover_tpu.common.config import get_context as jax_context
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import planner as jax_planner
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel import planner
from dlrover_tpu_torch.trainer.run import run_local

LAYERS, STEPS, TIMEOUT = 4, 3, 240
CONFIG_KW = {"num_layers": LAYERS}
MOE_KW = {"num_layers": LAYERS, "num_experts": 4, "moe_top_k": 2,
          "moe_dispatch": "grouped"}
EP_KW = {"num_layers": LAYERS, "num_experts": 8, "moe_top_k": 2,
         "moe_dispatch": "grouped_ep"}
PAIR_CASES = [("llama", "bf16"), ("llama", "fp8"), ("llama", "fp8_qdq"),
              (workers.SLICES, "bf16"), (workers.SLICES, "fp8"),
              (workers.SLICES, "fp8_qdq"), ("moe", "bf16")]


def _batches(vocab, seed, n=STEPS, rows=8, seq=16):
    ids = np.random.RandomState(seed).randint(0, vocab,
                                              size=(n, rows, seq + 1))
    return [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]


def _tree(**kw):
    return interop.params_to_numpy(llama.init(
        torch.Generator().manual_seed(0), llama.llama_tiny(**kw)))


@pytest.fixture(scope="module")
def pair():
    batches = _batches(256, 0)
    return run_local(workers.pair_ranks, 2,
                     (_tree(**CONFIG_KW), _tree(**MOE_KW), CONFIG_KW,
                      MOE_KW, batches), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def quad():
    batches = _batches(256, 1)
    return run_local(workers.quad_ranks, 4,
                     (_tree(**CONFIG_KW), _tree(**EP_KW), CONFIG_KW, EP_KW,
                      batches, _batches(256, 2)), timeout=TIMEOUT)


def _bitwise(off, on):
    assert on["losses"] == off["losses"]
    for step, (a, b) in enumerate(zip(off["grads"], on["grads"])):
        assert a.keys() == b.keys()
        for path in a:
            assert a[path].tobytes() == b[path].tobytes(), (step, path)
    for path, a in off["params"].items():
        assert on["params"][path].tobytes() == a.tobytes(), path


def _close(off, on, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(on["losses"], off["losses"], rtol=rtol)
    for path, a in off["params"].items():
        np.testing.assert_allclose(on["params"][path], a, rtol=0, atol=atol,
                                   err_msg=path)


# -- two ranks at (1, 2) ---------------------------------------------------------


class TestBitForBit:
    @pytest.mark.parametrize("case", PAIR_CASES,
                             ids=lambda c: f"{c[0]}-{c[1]}")
    def test_prefetch_equals_the_whole_tree_step(self, pair, case):
        """Three steps: the losses, each step's block gradients and the
        final blocks bit for bit, and the prefetch really ran (the
        layers came through the source, a layer at a time)."""
        for r in pair:
            off, on = r["runs"][case][False], r["runs"][case][True]
            _bitwise(off, on)
            assert on["held"]["fetches"] == STEPS * 2 * LAYERS
            assert off["held"]["fetches"] == 0

    @pytest.mark.parametrize("rule_set", ["llama", workers.SLICES])
    def test_fp8_equals_fp8_qdq_with_the_prefetch(self, pair, rule_set):
        """The reference's ``test_prefetch_path_holds_the_oracle_too``:
        under the prefetch only the wire forms travel, decoded at
        consumption, and fp8 stays bit for bit its oracle."""
        for r in pair:
            q = r["runs"][(rule_set, "fp8")][True]
            o = r["runs"][(rule_set, "fp8_qdq")][True]
            assert q["losses"] == o["losses"]
            for a, b in zip(q["grads"], o["grads"]):
                for path in a:
                    assert a[path].tobytes() == b[path].tobytes(), path
            assert q["stats"]["broadcast" if rule_set == "llama"
                              else "all_gather"]["bytes"] < \
                o["stats"]["broadcast" if rule_set == "llama"
                           else "all_gather"]["bytes"]

    def test_every_rank_reports_the_same_loss(self, pair):
        for case in PAIR_CASES:
            assert len({tuple(r["runs"][case][True]["losses"])
                        for r in pair}) == 1


class TestSchedule:
    def test_two_microbatches(self, pair):
        for r in pair:
            _close(r["accum"][False], r["accum"][True])
            assert r["accum"][True]["held"]["fetches"] == \
                STEPS * 2 * 2 * LAYERS

    def test_held_layers_are_at_most_two(self, pair):
        """Under ``dots_saveable`` (the config's default) and "full" at
        most two layers' gathered parameters live at once, the current
        and the prefetched, against all four for the whole-tree step;
        under "none" the matmuls keep every layer's weights for the
        backward, which gathers nothing again."""
        for r in pair:
            run = r["runs"][("llama", "bf16")]
            assert run[True]["held"]["held_high_water"] <= 2
            assert run[False]["held"]["held_high_water"] == LAYERS
            assert r["full"][True]["held"]["held_high_water"] <= 2
            assert r["none"][True]["held"]["held_high_water"] == LAYERS
            assert r["none"][True]["held"]["fetches"] == LAYERS
            for policy in ("full", "none"):
                _bitwise(r[policy][False], r[policy][True])

    def test_a_strategy_remat_policy_is_refused(self, pair):
        """The step's own checkpoint would run every layer's gather
        again in the backward: the prefetch takes the model's policy."""
        for r in pair:
            assert "takes the model's remat policy" in r["strategy_remat"]

    @pytest.mark.parametrize("caller", ["multi", "wsam"])
    def test_the_other_callers_of_the_backward(self, pair, caller):
        """``train_step_multi`` (two steps in one call) and WSAM's second
        forward and backward go through the source too: bit for bit the
        whole-tree step's losses and blocks."""
        for r in pair:
            off, on = r["callers"][False], r["callers"][True]
            assert on[caller] == off[caller]
            for path, a in off[f"{caller}_params"].items():
                assert on[f"{caller}_params"][path].tobytes() == \
                    a.tobytes(), path

    def test_evaluation_fetches_each_layer_once(self, pair):
        for r in pair:
            (off, off_stats), (on, on_stats) = (r["eval"][False],
                                                r["eval"][True])
            assert on == off
            assert on_stats["fetches"] == LAYERS
            assert off_stats["fetches"] == 0

    def test_the_context_knob_switches_at_the_next_step(self, pair):
        """One ``accelerate`` result, the config's prefetch left to the
        Context: off, on, off across three steps; the step after each
        flip runs the schedule the knob names."""
        for r in pair:
            off1, on, off2 = r["flip"]
            for off in (off1, off2):
                assert "broadcast" not in off["stats"]
                assert off["held"]["fetches"] == 0
            # seven layer kernels, each layer twice (gather, re-gather)
            assert on["stats"]["broadcast"]["calls"] == 2 * 7 * LAYERS
            assert on["held"]["fetches"] == 2 * LAYERS
            assert on["held"]["held_high_water"] <= 2


def _formula(run, precision="bf16"):
    """(gather-side bytes, calls; reduce-side bytes, calls) a step: the
    sharded leaves outside the layers gathered once, the layer stacks
    twice (the forward's gather and the backward's), a layer at a time;
    every sharded leaf's gradient reduced once. Under fp8 a wired stack
    (a layer's rank-3 kernels) moves ``fsdp_wire_bytes_per_elem`` an
    element in two exchanges (values and scales)."""
    per = planner.ModelSpec(param_count=0, num_layers=LAYERS,
                            hidden_size=64, param_bytes=4,
                            fsdp_precision="fp8").fsdp_wire_bytes_per_elem()
    gb = gc = rb = rc = 0
    for path, (_, shape) in run["sharded"].items():
        n = math.prod(shape)
        rb, rc = rb + 4 * n, rc + (LAYERS if path.startswith("layers/")
                                   else 1)
        if not path.startswith("layers/"):
            gb, gc = gb + 4 * n, gc + 1
        elif precision == "fp8" and len(shape) == 3:
            gb, gc = gb + 2 * n * per, gc + 2 * 2 * LAYERS
        else:
            gb, gc = gb + 2 * 4 * n, gc + 2 * LAYERS
    return gb, gc, rb, rc


def _sides(stats):
    def total(kinds, key):
        return sum(stats.get(k, {}).get(key, 0) for k in kinds)

    gather, reduce = ("all_gather", "broadcast"), ("reduce_scatter",
                                                   "reduce")
    return (total(gather, "bytes"), total(gather, "calls"),
            total(reduce, "bytes"), total(reduce, "calls"))


class TestExchanges:
    @pytest.mark.parametrize("case", [("llama", "bf16"), ("llama", "fp8"),
                                      (workers.SLICES, "bf16"),
                                      (workers.SLICES, "fp8"),
                                      ("moe", "bf16")],
                             ids=lambda c: f"{c[0]}-{c[1]}")
    def test_bytes_and_calls_follow_the_formula(self, pair, case):
        for r in pair:
            run = r["runs"][case][True]
            want = _formula(run, case[1])
            assert _sides(run["stats"]) == tuple(STEPS * x for x in want)
            # a layer's owner broadcasts under "llama"; slices gather
            kinds = set(run["stats"])
            assert ("broadcast" in kinds) == (case[0] != workers.SLICES)

    def test_the_whole_tree_step_moves_each_leaf_once(self, pair):
        for r in pair:
            run = r["runs"][("llama", "bf16")][False]
            gb, _, rb, _ = _sides(run["stats"])
            assert gb == rb == STEPS * sum(
                4 * math.prod(s) for _, s in run["sharded"].values())

    def test_counted_bytes_on_the_meta_device(self, pair):
        """``CostCounter`` on the meta device (``count_step``): the same
        bytes by kind as the formula, nothing run."""
        for r in pair:
            gb, _, rb, _ = _formula(r["runs"][("llama", "bf16")][True])
            c = r["counted"]
            assert c["all-gather"] + c["collective-broadcast"] == gb
            assert c["reduce-scatter"] + c["reduce"] == rb

    def test_exposed_waits_are_counted(self, pair):
        for r in pair:
            stats = r["runs"][("llama", "bf16")][True]["stats"]
            for kind in ("broadcast", "reduce"):
                assert 0.0 <= stats[kind]["wait_seconds"] <= \
                    stats[kind]["seconds"]


class TestStaging:
    def test_staged_exchanges_equal_the_unstaged(self, pair):
        """The gloo staging (through host buffers, as a CUDA tensor on
        gloo goes) forced on CPU tensors: three rounds of every exchange,
        synchronous and asynchronous, give the unstaged results."""
        for r in pair:
            assert r["staged"]


# -- four ranks ------------------------------------------------------------------


class TestFourRanks:
    @pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                             ids=lambda m: f"{m[0]}x{m[1]}")
    def test_prefetch_against_the_whole_tree_step(self, quad, mesh):
        for r in quad:
            off, on = r["runs"][mesh][False], r["runs"][mesh][True]
            _close(off, on)
            assert on["held"]["held_high_water"] <= 2
            assert on["held"]["fetches"] == STEPS * 2 * LAYERS

    def test_two_microbatches_at_two_by_two(self, quad):
        for r in quad:
            _close(r["accum"][False], r["accum"][True])

    def test_moe_ep_trajectory(self, quad):
        """The experts stay on their ranks, never gathered; the dense
        layer leaves come through the source, a layer at a time."""
        for r in quad:
            off, on = r["moe_ep"][False], r["moe_ep"][True]
            np.testing.assert_allclose(on["losses"], off["losses"],
                                       rtol=1e-4)
            assert on["held"]["fetches"] == STEPS * 2 * LAYERS
            dense = {p: s for p, s in on["sharded"].items()
                     if "experts" not in p}
            assert len(dense) < len(on["sharded"])
            want = _formula({"sharded": dense})
            assert _sides(on["stats"])[:2] == (STEPS * want[0],
                                               STEPS * want[1])


# -- the held-layer count --------------------------------------------------------


def test_held_count_under_threads():
    """Layers held and released from eight threads at once (tensors
    freed on whichever thread drops them, as the autograd engine's do):
    the count returns to where it started and its high-water mark
    never falls below what was held."""
    import sys
    import threading

    from dlrover_tpu_torch.parallel import layer_prefetch

    start = layer_prefetch.stats()["held"]
    errors = []

    def churn():
        try:
            for _ in range(200):
                t = [torch.zeros(4), torch.zeros(2)]
                layer_prefetch.hold(1, t)
                s = layer_prefetch.stats()
                assert s["held_high_water"] >= s["held"] >= start + 1
                del t
        except AssertionError as e:
            errors.append(e)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=churn) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert layer_prefetch.stats()["held"] == start


# -- one device ------------------------------------------------------------------


def _ids(vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, size=(2, 16))


@pytest.mark.parametrize("kw", [{}, {"fsdp_precision": "fp8"}],
                         ids=["bf16", "fp8"])
def test_one_device_apply_matches_the_reference_prefetch(kw):
    """Without a mesh the reference's prefetch gathers nothing (its
    constraint is the identity) and restructures its scan; the port's
    prefetch is the plain loop: within 1e-5 of the reference's
    ``apply(fsdp_prefetch=True)`` and bit for bit its own prefetch-off
    ``apply``."""
    jcfg = jax_llama.llama_tiny(num_layers=LAYERS, fsdp_prefetch=True, **kw)
    jparams = jax_llama.init(jax.random.PRNGKey(0), jcfg)
    ids = _ids(jcfg.vocab_size)
    want, _ = jax_llama.apply(jparams, jnp.asarray(ids), jcfg)
    params = interop.params_from_numpy(jax.device_get(jparams), "cpu")
    cfg = llama.llama_tiny(num_layers=LAYERS, fsdp_prefetch=True, **kw)
    on, _ = llama.apply(params, torch.from_numpy(ids), cfg)
    off, _ = llama.apply(params, torch.from_numpy(ids),
                         dataclasses.replace(cfg, fsdp_prefetch=False))
    np.testing.assert_allclose(on.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert on.numpy().tobytes() == off.numpy().tobytes()


@pytest.fixture
def contexts(monkeypatch):
    ours, theirs = get_context(), jax_context()
    for c in (ours, theirs):
        monkeypatch.setattr(c, "fsdp_prefetch", c.fsdp_prefetch)
    return ours, theirs


@pytest.mark.parametrize("knob", [False, True])
@pytest.mark.parametrize("config", [None, False, True])
def test_model_spec_reads_the_prefetch_as_the_reference(contexts, knob,
                                                        config):
    """``ModelSpec.fsdp_prefetch``: the config's value, else the
    Context's, as the reference's ``model_spec_from_llama``."""
    for c in contexts:
        c.fsdp_prefetch = knob
    got = planner.model_spec_from_llama(
        llama.llama_tiny(fsdp_prefetch=config))
    want = jax_planner.model_spec_from_llama(
        jax_llama.llama_tiny(fsdp_prefetch=config), global_batch=8)
    assert got.fsdp_prefetch is want.fsdp_prefetch
    assert got.fsdp_prefetch is (knob if config is None else config)
