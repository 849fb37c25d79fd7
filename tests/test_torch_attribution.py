"""The attribution plane of the port (ROADMAP A11) against the JAX
package: ``utils/prof``'s MFU formula, ``telemetry/attribution``'s
record, capture and trace parser, the wrappers' counted FLOPs and bytes,
the trainer's record cache, the executor's gauges, the Prometheus text
and the trace ids.

Tolerances, each stated where it is used:

* ``derived_mfu``, the trace buckets of the reference's fixture, the
  record's derived quantities and the metrics text: equal, exactly.
* Matmul FLOPs of a step of the tiny dense Llama (2 layers, remat off):
  within 1 % of the dot products in the reference's compiled step (its
  optimized HLO, each dot weighted by the trip counts of the loops
  around it: XLA's own cost model counts a loop body once). The port's
  attention runs in the flash kernels, so the reference's attention
  dots (those with batch dimensions) are left out.
* The whole count against XLA's ``flops`` at ONE layer (one trip of the
  scan over layers, which XLA counts once): measured 0.910, held in
  [0.85, 1.0]. The port counts no elementwise FLOPs (XLA counts one per
  element) and its flash kernels count the causal pairs, where the
  reference's CPU attention multiplies the full S x S scores.
* The flash kernels' reports: equal to the visible-pair formula,
  computed here with numpy, for the causal, segment-id and prefix-LM
  modes; the grouped kernels': 2 x rows x D x F over the rows given.
* The meta-device count equals the count of a real CPU step, FLOPs and
  bytes, exactly; the live state is bit for bit the same after it.
"""

import gzip
import os
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.analysis.graph_lint import _computations
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.telemetry import attribution as jax_attr
from dlrover_tpu.telemetry import metrics as jax_metrics
from dlrover_tpu.telemetry import trace_context as jax_trace
from dlrover_tpu.utils import prof as jax_prof
from dlrover_tpu_torch.checkpoint import CheckpointInterval
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.examples import train_llama as example
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import grouped_matmul as gm
from dlrover_tpu_torch.ops import quantize
from dlrover_tpu_torch.parallel import planner
from dlrover_tpu_torch.parallel.accelerate import accelerate
from dlrover_tpu_torch.telemetry import attribution as attr
from dlrover_tpu_torch.telemetry import names as tm
from dlrover_tpu_torch.telemetry import trace_context
from dlrover_tpu_torch.telemetry.events import (
    clear_ring,
    emit_event,
    recent_events,
)
from dlrover_tpu_torch.telemetry.metrics import (
    MetricsRegistry,
    process_registry,
)
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook
from dlrover_tpu_torch.trainer.run import run_local
from dlrover_tpu_torch.utils import prof

import torch_recovery_workers as workers

DATA = os.path.join(os.path.dirname(__file__), "testdata")
FIXTURE = os.path.join(DATA, "attribution_trace.json")
TORCH_FIXTURE = os.path.join(DATA, "torch_profiler_trace.json")
PEAK = 1e9  # a fixed MFU denominator on the CPU
B, S = 2, 64


@pytest.fixture(autouse=True)
def _attribution_context():
    """Pin the attribution knobs per test and restore them after."""
    ctx = get_context()
    saved = (ctx.telemetry_enabled, ctx.attribution_enabled,
             ctx.device_peak_flops, ctx.device_hbm_budget_bytes)
    ctx.telemetry_enabled = True
    ctx.attribution_enabled = True
    ctx.device_peak_flops = PEAK
    ctx.device_hbm_budget_bytes = 0.0
    yield ctx
    (ctx.telemetry_enabled, ctx.attribution_enabled,
     ctx.device_peak_flops, ctx.device_hbm_budget_bytes) = saved


def _batch(vocab=256, seed=0, rows=B, seq=S):
    ids = np.random.RandomState(seed).randint(0, vocab, (rows, seq + 1))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


def _result(layers=2, **kw):
    cfg = llama.llama_tiny(num_layers=layers, use_flash=True,
                           remat_policy="none", **kw)
    batch = _batch(cfg.vocab_size)
    return accelerate(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                      example.adamw(), batch, device="cpu"), batch


def _trainer(**kwargs):
    cfg = llama.llama_tiny(use_flash=True)
    batch = _batch(cfg.vocab_size)
    return ElasticTrainer(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                          example.adamw(), batch, device="cpu",
                          **kwargs), batch


def _state_bytes(state):
    out = {f"p{i}": t.detach().clone() for i, t in
           enumerate(tree_leaves(state.params))}
    for i, slots in enumerate(state.opt_state.state.values()):
        for key, v in slots.items():
            if isinstance(v, torch.Tensor):
                out[f"s{i}/{key}"] = v.detach().clone()
    return out


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key].reshape(-1).view(torch.uint8),
                           b[key].reshape(-1).view(torch.uint8)), key


# -- the one formula ------------------------------------------------------------


class TestFormulas:
    @settings(max_examples=60, deadline=None)
    @given(flops=st.floats(0, 1e18, allow_nan=False),
           step=st.floats(-1.0, 1e4, allow_nan=False),
           peak=st.floats(-1.0, 1e16, allow_nan=False))
    def test_derived_mfu_equals_the_reference(self, flops, step, peak):
        def outcome(fn):  # the value, or the error (a subnormal product)
            try:
                return fn(flops, step, peak)
            except ArithmeticError as err:
                return type(err)

        assert outcome(prof.derived_mfu) == outcome(jax_prof.derived_mfu)

    def test_profile_result_mfu_is_the_formula(self):
        pr = prof.ProfileResult(
            steps_per_sec=1000.0, step_time_ms=1.0, flops_per_step=100.0,
            achieved_flops_per_sec=1e5, param_count=1, peak_memory_bytes=0)
        assert pr.mfu(1e6) == prof.derived_mfu(100.0, 0.001, 1e6)

    def test_count_params_over_a_module_and_a_tree(self):
        lin = torch.nn.Linear(16, 8)
        assert prof.count_params(lin) == 16 * 8 + 8
        assert prof.param_bytes(lin) == (16 * 8 + 8) * 4
        tree = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
                "b": {"c": torch.zeros(5)}}
        assert prof.count_params(tree) == 17
        assert prof.param_bytes(tree) == 12 * 2 + 5 * 4

    def test_the_h100_spec(self):
        spec = planner.GPU_SPECS["h100-sxm"]
        assert (spec.flops_per_s, spec.hbm_bw, spec.ici_bw) == (
            989e12, 3.35e12, 4.5e11)
        assert planner.spec_for_name("NVIDIA H100 80GB HBM3") is spec
        assert planner.spec_for_name("Tesla T4") is None
        # the CPU's placeholder, as the reference falls back to v5e
        assert attr.resolve_device_spec("cpu") is planner.CPU_PLACEHOLDER
        assert attr.resolve_peak_flops() == PEAK  # the Context's wins


class TestProfilers:
    def test_dry_runner_counts_and_times_the_step(self, monkeypatch):
        monkeypatch.setenv("DLROVER_TPU_DRYRUN_WARMUP", "1")
        monkeypatch.setenv("DLROVER_TPU_DRYRUN_STEPS", "2")
        runner = prof.DryRunner()
        assert (runner.warmup, runner.steps) == (1, 2)
        res, batch = _result()
        state = res.init_fn(0)
        result = runner.profile(res.train_step, state,
                                res.shard_batch(batch),
                                torch.Generator().manual_seed(0))
        assert result.flops_per_step == attr.count_step(res, 1,
                                                        batch).flops
        assert result.param_count == prof.count_params(state.params)
        assert result.peak_memory_bytes == prof.compiled_peak_bytes() == 0
        assert state.step == 1 + 1 + 2  # warm-up, counted, timed
        assert result.mfu(PEAK) == prof.derived_mfu(
            result.flops_per_step, 1.0 / result.steps_per_sec, PEAK)

    def test_aprofiler_subtrees_and_the_loss_cost(self):
        cfg = llama.llama_tiny(use_flash=True)
        params = llama.init(torch.Generator().manual_seed(0), cfg)
        profiler = prof.AProfiler(params)
        subtrees = profiler.params_by_subtree()
        assert sum(subtrees.values()) == llama.param_count(cfg)
        assert subtrees["lm_head"] == 64 * 256
        assert profiler.params_by_subtree(depth=2)["layers/q_proj"] == \
            2 * 64 * 64
        batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
        info = profiler.summary(llama.make_loss_fn(cfg), batch)
        # the forward: 2 x the projections x tokens, and B1's causal pairs
        n_matmul = 2 * (64 * 64 * 2 + 64 * 32 * 2 + 3 * 64 * 128) + 64 * 256
        assert info["forward_flops"] == 2 * n_matmul * B * S + \
            2 * 4 * 4 * 16 * B * S * (S + 1) // 2
        assert info["param_count"] == llama.param_count(cfg)
        module = prof.AProfiler(torch.nn.Sequential(torch.nn.Linear(4, 3)))
        assert module.params_by_subtree() == {"0": 15}


# -- the trace parser -----------------------------------------------------------


REFERENCE_NAMES = ["fusion.123", "all-reduce.7", "fusion.456.dot",
                   "all-gather-start.2", "infeed.0", "some-unclassified-op",
                   "fusion.all-reduce.3", "fusion.99", "mystery",
                   "collective-permute-done", "copy.4", "custom-call.12",
                   "outfeed", "reduce-scatter.1", "send", "recv-done"]
CUDA_NAMES = {
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL": "collective",
    "ncclKernel_AllGather_RING_LL_Sum_int8_t": "collective",
    "Memcpy HtoD (Pinned -> Device)": "infeed",
    "Memcpy DtoH (Device -> Pageable)": "infeed",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n": "compute",
    "ampere_sgemm_128x64_tn": "compute",
    "cutlass::Kernel2<cutlass_80_wmma_tensorop>": "compute",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_TNN": "compute",
    "void flash_fwd_bf16_kernel<128, false, false>": "compute",
    "void flash_bwd_dkv_d64_kernel<true>": "compute",
    "void grouped_fwd_kernel<__nv_bfloat16>": "compute",
    "void at::native::multi_tensor_apply_kernel<...>": "compute",
}


class TestTraceParser:
    def test_the_reference_fixture_parses_identically(self):
        assert attr.parse_trace_path(FIXTURE) == \
            jax_attr.parse_trace_path(FIXTURE)
        buckets = attr.parse_trace_path(FIXTURE)
        assert buckets["busy_s"] == pytest.approx(0.045)
        assert buckets["measured_comm_frac"] == pytest.approx(15 / 47,
                                                              abs=1e-4)

    def test_gzip_and_directory_discovery(self, tmp_path):
        profile = tmp_path / "plugins" / "profile" / "run1"
        profile.mkdir(parents=True)
        gz = profile / "host.trace.json.gz"
        with gzip.open(gz, "wt") as fh:
            fh.write(open(FIXTURE).read())
        (profile / "rank0.pt.trace.json").write_text(open(FIXTURE).read())
        assert attr.find_trace_files(str(tmp_path)) == \
            jax_attr.find_trace_files(str(tmp_path))
        assert len(attr.find_trace_files(str(tmp_path))) == 2
        ours = attr.parse_trace_path(str(tmp_path))
        assert ours == jax_attr.parse_trace_path(str(tmp_path))
        assert ours["source_files"] == 2
        assert ours["collective_s"] == pytest.approx(0.030)

    @pytest.mark.parametrize("records", [
        [],
        [{"ph": "X", "pid": 1, "tid": 1, "ts": 0, "dur": 1_000_000,
          "name": "all-reduce.1"},
         {"ph": "X", "pid": 1, "tid": 99, "ts": 0, "dur": 1_000_000,
          "name": "TraceMe host step"}],
        [{"ph": "X", "pid": 1, "tid": 1, "ts": "bad", "dur": 5,
          "name": "fusion"},
         {"ph": "X", "pid": 1, "tid": 1, "ts": 10, "dur": 0, "name": "dot"},
         {"ph": "B", "pid": 1, "tid": 1, "ts": 3, "name": "fusion"},
         {"ph": "X", "pid": 2, "tid": 1, "ts": 7, "dur": 4,
          "name": "infeed"}],
    ], ids=["empty", "host_lane", "malformed"])
    def test_events_without_device_cats_parse_as_the_reference(self,
                                                              records):
        assert attr.parse_trace_events(records) == \
            jax_attr.parse_trace_events(records)

    def test_a_torch_profiler_trace_counts_device_lanes_only(self):
        """Device events only (cat kernel / gpu_memcpy / gpu_memset):
        the host lanes' nested events and the GPU user annotation are
        left out, and a kernel whose name holds '#' ("{lambda()#3}", as
        torch's copy kernels do) is device time like any other. Known
        totals of the fixture, in ms: stream 7 runs 20 + 5 + 2 + 1 + 3 +
        2 = 33 (the busiest lane), stream 20 the 10 ms all-reduce;
        device wall 1 -> 50 ms."""
        buckets = attr.parse_trace_path(TORCH_FIXTURE)
        assert buckets == {
            "events": 7, "wall_s": 0.049, "busy_s": 0.033,
            "idle_s": 0.016, "collective_s": 0.01, "compute_s": 0.027,
            "infeed_s": 0.002, "other_s": 0.004,
            "measured_comm_frac": round(10 / 39, 4)}
        # the reference's rule on the same file takes a host thread for
        # the busiest lane: what the device rule exists to avoid
        theirs = jax_attr.parse_trace_path(TORCH_FIXTURE)
        assert theirs["busy_s"] > theirs["wall_s"] > buckets["wall_s"]

    def test_groups_top_kernels_and_gaps_from_the_same_parse(self):
        records = attr.load_trace(TORCH_FIXTURE)
        view = attr.kernel_breakdown(records, steps=1)
        assert view["busy_ms"] == pytest.approx(43.0)
        assert view["groups_ms"] == pytest.approx({
            "matmul": 20.0, "flash attention (B1-B3)": 5.0,
            "copies between host and device": 2.0,
            attr.OTHER_GROUP: 16.0})
        hashed = [name for name in view["by_name"] if "#" in name]
        assert len(hashed) == 1 and view["by_name"][hashed[0]] == \
            pytest.approx([2.0, 1.0])
        assert view["top"][0][2].startswith("sm90_xmma_gemm")
        assert view["top"][0][:2] == pytest.approx((20.0, 1.0))
        halved = attr.kernel_breakdown(records, steps=2)
        assert halved["busy_ms"] == pytest.approx(21.5)
        gaps = attr.device_gaps(records, steps=1)
        assert gaps["span_ms_per_step"] == pytest.approx(49.0)
        assert gaps["per_step"]["over 1 ms"] == pytest.approx(
            {"count": 3, "ms": 6.0})
        assert gaps["per_step"]["under 20 us"]["count"] == 0
        assert gaps["largest"][0][0] == pytest.approx(3.0)
        assert attr.device_gaps([]) == {}

    def test_categorize_reference_names_as_the_reference(self):
        for name in REFERENCE_NAMES:
            assert attr.categorize_op(name) == jax_attr.categorize_op(name)

    @pytest.mark.parametrize("name", sorted(CUDA_NAMES))
    def test_categorize_cuda_names(self, name):
        assert attr.categorize_op(name) == CUDA_NAMES[name]

    def test_kernel_groups_are_one_table(self):
        assert attr.kernel_group("void flash_bwd_dq_bf16_kernel") == \
            "flash attention (B1-B3)"
        assert attr.kernel_group("grouped_dw_f32_kernel") == \
            "grouped matmul (B4-B6)"
        assert attr.kernel_group("multi_tensor_apply_kernel") == "optimizer"
        assert attr.kernel_group("elementwise") == attr.OTHER_GROUP


# -- the record -----------------------------------------------------------------


RECORD_FIELDS = dict(
    flops_per_step=1.5e12, bytes_accessed_per_step=3e11,
    peak_hbm_bytes=12 * 2**30, collective_bytes={"all-reduce": 1e9},
    predicted_comm_s={"all-reduce": 0.002}, predicted_comm_total_s=0.002,
    predicted_compute_s=1.5e12 / 989e12, peak_flops_per_s=989e12,
    hbm_budget_bytes=80e9, n_devices=4, steps_per_call=2,
    capture_seconds=0.25)


class TestRecord:
    def test_to_dict_has_the_reference_keys(self):
        ours = attr.AttributionRecord().to_dict()
        assert list(ours) == list(jax_attr.AttributionRecord().to_dict())

    @pytest.mark.parametrize("step_s", [0.0, 1e-4, 1e-3, 0.0152, 1.0])
    def test_derived_quantities_equal_the_reference(self, step_s):
        ours = attr.AttributionRecord(**RECORD_FIELDS)
        theirs = jax_attr.AttributionRecord(**RECORD_FIELDS)
        assert ours.mfu(step_s) == theirs.mfu(step_s)
        assert ours.exposed_comm_fraction(step_s) == \
            theirs.exposed_comm_fraction(step_s)
        assert ours.hbm_headroom_bytes() == theirs.hbm_headroom_bytes()
        assert ours.arithmetic_intensity == theirs.arithmetic_intensity
        mine, ref = ours.to_dict(), theirs.to_dict()
        mine.pop("source"), ref.pop("source")
        assert mine == ref
        assert attr.AttributionRecord().hbm_headroom_bytes() is None


# -- counting -------------------------------------------------------------------


def _hlo_dot_flops(text, batched):
    """FLOPs of the dots of an optimized HLO module, each weighted by
    the trip counts of the loops around it (``calls=`` and ``body=``
    edges); ``batched``: the dots with batch dimensions (True) or the
    others (False)."""
    comps = _computations(text)
    parents = {}
    trip_re = re.compile(r'known_trip_count\\?":\{\\?"n\\?":\\?"(\d+)')
    for name, body in comps.items():
        for line in body.splitlines():
            for ref in re.findall(
                    r"(?:body|condition|calls|to_apply)=(%[\w.\-]+)", line):
                trip = trip_re.search(line)
                n = int(trip.group(1)) if trip and f"body={ref}" in line \
                    else 1
                parents.setdefault(ref, []).append((name, n))
    memo = {}

    def mult(name, seen=()):
        if name not in memo:
            memo[name] = (1 if name not in parents or name in seen else
                          sum(n * mult(p, seen + (name,))
                              for p, n in parents[name]))
        return memo[name]

    define = re.compile(r"^\s*(?:ROOT )?(%[\w.\-]+) = \w+\[([\d,]*)\]")
    total = 0
    for name, body in comps.items():
        shapes = {}
        for line in body.splitlines():
            m = define.match(line)
            if m:
                shapes[m.group(1)] = [int(x) for x in m.group(2).split(",")
                                      if x]
        for line in body.splitlines():
            dot = re.search(r" dot\((%[\w.\-]+), (%[\w.\-]+)\)", line)
            if not dot or ("lhs_batch_dims" in line) != batched:
                continue
            out = shapes[define.match(line).group(1)]
            lhs = shapes[dot.group(1)]
            contract = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", line)
            k = int(np.prod([lhs[int(i)] for i in
                             contract.group(1).split(",") if i]))
            total += 2 * int(np.prod(out)) * k * mult(name)
    return total


def _jax_step(layers):
    jcfg = jax_llama.llama_tiny(num_layers=layers, remat_policy="none")
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}
    res = jax_accelerate(
        jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
        optax.adamw(3e-4), batch,
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=1)),
        devices=jax.devices()[:1])
    return res, batch


class TestCountAgainstTheReference:
    def test_matmul_flops_within_one_percent_of_xla(self):
        res, batch = _result(layers=2)
        counted = attr.count_step(res, 1, batch)
        jres, jbatch = _jax_step(2)
        state = jax.eval_shape(jres.init_fn, jax.random.PRNGKey(0))
        abstract = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), jbatch)
        compiled = jres.train_step.lower(
            state, abstract, jax.ShapeDtypeStruct((2,), jnp.uint32)).compile()
        xla = _hlo_dot_flops(compiled.as_text(), batched=False)
        assert counted.matmul_flops == pytest.approx(xla, rel=0.01)
        # and both are the projections' 6 x N_matmul x tokens
        n_matmul = 2 * (64 * 64 * 2 + 64 * 32 * 2 + 3 * 64 * 128) + 64 * 256
        assert counted.matmul_flops == 6 * n_matmul * B * S

    def test_whole_count_within_the_stated_band_of_xla(self):
        res, batch = _result(layers=1)
        counted = attr.count_step(res, 1, batch)
        jres, jbatch = _jax_step(1)
        ref = jax_attr.capture_attribution(jres, example_batch=jbatch,
                                           emit=False)
        ratio = counted.flops / ref.flops_per_step
        assert 0.85 <= ratio <= 1.0, ratio  # measured 0.910

    def test_the_meta_count_equals_a_real_cpu_step(self):
        res, batch = _result()
        meta = attr.count_step(res, 1, batch)
        state = res.init_fn(0)
        gen = torch.Generator().manual_seed(0)
        sharded = res.shard_batch(batch)
        state, _ = res.train_step(state, sharded, gen)
        with prof.CostCounter() as real:
            res.train_step(state, sharded, gen)
        assert real.flops == meta.flops and real.bytes == meta.bytes
        assert real.kernels == meta.kernels
        assert real.by_op == meta.by_op
        # the kernels' share is their formula alone: nothing of their
        # plain versions (which multiply the full S x S scores) counted
        per_layer = 18 * 4 * 16 * B * (S * (S + 1) // 2)
        assert sum(v["flops"] for v in meta.kernels.values()) == 2 * per_layer

    def test_a_capture_leaves_the_live_state_bit_for_bit(self):
        trainer, batch = _trainer()
        state = trainer.prepare()
        state, _ = trainer.step(state, batch)
        before = _state_bytes(state)
        rng = trainer._rng.get_state().clone()
        record = trainer.attribution()
        assert record is not None and record.flops_per_step > 0
        _assert_same(before, _state_bytes(state))
        assert torch.equal(rng, trainer._rng.get_state())

    def test_multi_step_record_is_per_step(self):
        res1, batch = _result()
        cfg = llama.llama_tiny(use_flash=True, remat_policy="none")
        res4 = accelerate(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                          example.adamw(), batch, device="cpu",
                          steps_per_call=4)
        r1 = attr.capture_attribution(res1, 1, batch, emit=False)
        r4 = attr.capture_attribution(res4, 4, batch, emit=False)
        assert r4.steps_per_call == 4
        # the FLOPs are K steps' exactly; the bytes add the metrics'
        # stacking only
        assert r4.flops_per_step == r1.flops_per_step
        assert r4.bytes_accessed_per_step == pytest.approx(
            r1.bytes_accessed_per_step, rel=1e-3)

    def test_capture_emits_the_reference_fields(self):
        clear_ring()
        res, batch = _result()
        record = attr.capture_attribution(res, 1, batch)
        event = [e for e in recent_events()
                 if e["kind"] == tm.EventKind.ATTRIBUTION_CAPTURED][-1]
        assert event["flops_per_step"] == record.flops_per_step
        assert set(event) >= {
            "flops_per_step", "bytes_accessed_per_step",
            "arithmetic_intensity", "peak_hbm_mb", "predicted_comm_total_s",
            "predicted_compute_s", "peak_flops_per_s", "n_devices",
            "steps_per_call", "source", "capture_seconds"}
        assert record.peak_flops_per_s == PEAK
        assert record.predicted_compute_s == record.flops_per_step / PEAK
        assert record.peak_hbm_bytes == 0  # no card
        assert record.n_devices == 1 and record.collective_bytes == {}

    def test_a_planner_model_spec_is_refused(self):
        res, batch = _result()
        with pytest.raises(NotImplementedError, match="A15"):
            attr.capture_attribution(res, 1, batch, model_spec=object())


# -- the wrappers' reports ------------------------------------------------------


def _pairs_numpy(s, causal, seg=None, prefix=None):
    """Visible (q, k) pairs a row, by brute force."""
    i = np.arange(s)[:, None]
    j = np.arange(s)[None, :]
    keep = (j <= i) if causal else np.ones((s, s), bool)
    if prefix is not None:
        keep = keep | (j < prefix)
    if seg is not None:
        keep = keep & (seg[:, None] == seg[None, :])
    return int(keep.sum())


def _qkv(b=2, h=4, hkv=2, s=96, d=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, s, d, generator=gen)
    k = torch.randn(b, hkv, s, d, generator=gen)
    v = torch.randn(b, hkv, s, d, generator=gen)
    return q, k, v


MODES = ["causal", "noncausal", "segment", "prefix"]


def _mode_kwargs(mode, b, s):
    rng = np.random.RandomState(3)
    if mode == "segment":
        seg = np.sort(rng.randint(0, 4, (b, s)), axis=1).astype(np.int32)
        seg[:, -5:] = -1  # a pad tail
        t = torch.as_tensor(seg)
        return {"seg_q": t, "seg_k": t}, {"seg": seg}
    if mode == "prefix":
        p = np.array([17, 0][:b], np.int32)
        return {"prefix_len": torch.as_tensor(p)}, {"prefix": p}
    return {}, {}


class TestKernelReports:
    @pytest.mark.parametrize("mode", MODES)
    def test_flash_flops_are_the_visible_pair_formula(self, mode):
        q, k, v = _qkv()
        b, h, s, d = q.shape
        causal = mode != "noncausal"
        kw, np_kw = _mode_kwargs(mode, b, s)
        pairs = sum(_pairs_numpy(
            s, causal, np_kw["seg"][r] if "seg" in np_kw else None,
            np_kw["prefix"][r] if "prefix" in np_kw else None)
            for r in range(b))
        suffix = {"segment": "_seg", "prefix": "_pfx"}.get(mode, "")
        with prof.CostCounter() as count:
            out, lse = fa.flash_fwd(q, k, v, causal, 0.25, **kw)
            delta = (out * out).sum(-1)
            fa.flash_bwd_dkv(q, k, v, out, lse, delta, causal, 0.25, **kw)
            fa.flash_bwd_dq(q, k, v, out, lse, delta, causal, 0.25, **kw)
        for name, per_pair in (("flash_fwd", 4), ("flash_bwd_dkv", 8),
                               ("flash_bwd_dq", 6)):
            got = count.kernels[name + suffix]
            assert got["flops"] == per_pair * h * d * pairs
            assert got["calls"] == 1
        # the plain versions ran uncounted: only the delta's two ops
        assert set(count.by_op) == {"aten.mul", "aten.sum"}

    def test_flash_bytes_are_inputs_once_and_outputs_once(self):
        q, k, v = _qkv(s=64)
        qb, kb, rows = q.numel() * 4, k.numel() * 4, 2 * 4 * 64 * 4
        with prof.CostCounter() as count:
            out, lse = fa.flash_fwd(q, k, v, True, 0.25)
            fa.flash_bwd_dkv(q, k, v, out, lse, lse, True, 0.25)
            fa.flash_bwd_dq(q, k, v, out, lse, lse, True, 0.25)
        assert count.kernels["flash_fwd"]["bytes"] == 2 * qb + 2 * kb + rows
        assert count.kernels["flash_bwd_dkv"]["bytes"] == \
            2 * qb + 4 * kb + 2 * rows
        assert count.kernels["flash_bwd_dq"]["bytes"] == \
            3 * qb + 2 * kb + 2 * rows

    def test_dense_shapes_give_the_bound_columns_ops(self):
        """PERF.md's Bound column: B1 137.5 GFLOP, B2 274.9, B3 206.2 at
        q [1,32,4096,128], k/v [1,8,4096,128], causal (meta tensors:
        nothing allocated)."""
        q = torch.empty(1, 32, 4096, 128, device="meta",
                        dtype=torch.bfloat16)
        k = torch.empty(1, 8, 4096, 128, device="meta", dtype=torch.bfloat16)
        want = {"flash_fwd": 137.5, "flash_bwd_dkv": 274.9,
                "flash_bwd_dq": 206.2}
        for name, gflop in want.items():
            flops, _ = fa.flash_work(name, q, k, True)
            assert round(flops / 1e9, 1) == gflop

    @pytest.mark.parametrize("mode", ["segment", "prefix"])
    def test_meta_flash_counts_through_the_batch_hint(self, mode):
        q, k, v = _qkv()
        b, _, s, _ = q.shape
        kw, _ = _mode_kwargs(mode, b, s)
        with prof.CostCounter() as real:
            fa.flash_fwd(q, k, v, True, 0.25, **kw)
        meta_kw = {n: t.to("meta") for n, t in kw.items()}
        qm, km, vm = (t.to("meta") for t in (q, k, v))
        batch = ({"segment_ids": kw["seg_q"]} if mode == "segment" else
                 {"prefix_len": kw["prefix_len"],
                  "input_ids": np.zeros((b, s), np.int64)})
        with prof.CostCounter() as meta:
            meta.pair_hints.update(attr.pair_hints(batch))
            out, lse = fa.flash_fwd(qm, km, vm, True, 0.25, **meta_kw)
        assert out.device.type == "meta" and lse.shape == (b, 4, s)
        assert meta.kernels == real.kernels
        # without the hint the causal pairs stand in (an upper bound)
        with prof.CostCounter() as bare:
            fa.flash_fwd(qm, km, vm, True, 0.25, **meta_kw)
        name = "flash_fwd" + ("_seg" if mode == "segment" else "_pfx")
        assert bare.kernels[name]["flops"] == 4 * 4 * 16 * b * s * (s + 1) / 2

    def test_grouped_reports_over_the_rows_given(self):
        e, d, f, rows = 3, 16, 24, 256
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(rows, d, generator=gen)
        w = torch.randn(e, d, f, generator=gen)
        dy = torch.randn(rows, f, generator=gen)
        te = torch.tensor([0, 1], dtype=torch.int32)
        live = torch.tensor([200], dtype=torch.int32)
        values, scales = quantize.quantize_block_scaled(x, 8)
        with prof.CostCounter() as count:
            gm.grouped_matmul_fwd(x, w, te, 128, live_rows=live)
            gm.grouped_matmul_fwd(dy, w, te, 128, transpose_w=True)
            gm.grouped_matmul_dw(x, dy, te, e, 128)
            gm.grouped_matmul_fwd_quant(values, scales, w, te, 128, live)
        flops = 2.0 * rows * d * f
        assert count.kernels["grouped_matmul_fwd"] == {
            "flops": 2 * flops, "calls": 2,
            "bytes": (x.numel() + w.numel() + rows * f) * 4 + 8 + 4
            + (dy.numel() + w.numel() + rows * d) * 4 + 8}
        assert count.kernels["grouped_matmul_dw"] == {
            "flops": flops, "calls": 1,
            "bytes": (x.numel() + dy.numel() + e * d * f) * 4 + 8}
        assert count.kernels["grouped_matmul_fwd_quant"] == {
            "flops": flops, "calls": 1,
            "bytes": values.numel() + scales.numel() * 4 + w.numel() * 4
            + rows * f * 4 + 8 + 4}
        assert count.by_op == {}  # the plain versions ran uncounted
        for fn, args in ((gm.grouped_matmul_fwd, (x, w, te, 128)),
                         (gm.grouped_matmul_dw, (x, dy, te, e, 128))):
            out = fn(*(t.to("meta") if isinstance(t, torch.Tensor) else t
                       for t in args))
            assert out.device.type == "meta"
        assert gm.launch_counts() == {name: 0 for name in gm.WRAPPERS}

    def test_moe_capture_counts_the_grouped_rows(self):
        cfg = llama.llama_tiny(use_flash=True, remat_policy="none",
                               num_experts=8, moe_top_k=2,
                               moe_dispatch="grouped")
        batch = _batch(cfg.vocab_size, seq=16)
        res = accelerate(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                         example.adamw(), batch, device="cpu")
        count = attr.count_step(res, 1, batch)
        t, k, bt, e = B * 16, 2, 128, 8
        rows = -(-t * k // bt) * bt + e * bt  # the layout's static bound
        d, f = cfg.hidden_size, cfg.intermediate_size
        layers = cfg.num_layers
        assert count.kernels["grouped_matmul_fwd"]["calls"] == 4 * layers
        assert count.kernels["grouped_matmul_fwd"]["flops"] == \
            4 * layers * 2 * rows * d * f
        assert count.kernels["grouped_matmul_dw"]["flops"] == \
            2 * layers * 2 * rows * d * f


# -- several ranks --------------------------------------------------------------


EP_KW = dict(num_experts=4, moe_top_k=2, moe_dispatch="grouped_ep")


@pytest.fixture(scope="module")
def ep_counts():
    jcfg = jax_llama.llama_tiny(**EP_KW)
    tree = jax.device_get(jax_llama.init(jax.random.PRNGKey(0), jcfg))
    batch = _batch(jcfg.vocab_size, rows=4, seq=8)
    return run_local(workers.moe_ep_attribution_ranks, 2,
                     (tree, batch, EP_KW, 1e-2), timeout=240)


class TestExpertParallel:
    def test_meta_count_equals_the_real_step_on_each_rank(self, ep_counts):
        for r in ep_counts:
            assert r["meta_flops"] == r["real_flops"]
            assert r["meta_bytes"] == r["real_bytes"]
            assert r["meta"]["kernels"] == r["real"]["kernels"]

    def test_grouped_flops_over_the_rows_each_call_was_given(self,
                                                             ep_counts):
        for r in ep_counts:
            want = {}
            for name, rows, d, f in r["rows"]:
                want[name] = want.get(name, 0.0) + 2.0 * rows * d * f
            got = {n: v["flops"] for n, v in r["meta"]["kernels"].items()
                   if n.startswith("grouped")}
            assert got == want and got

    def test_exchange_bytes_by_kind_are_what_the_ring_moved(self,
                                                            ep_counts):
        for r in ep_counts:
            coll = r["meta"]["collective_bytes"]
            assert coll["all-to-all"] == r["stats"]["all_to_all"]["bytes"]
            assert coll["all-reduce"] == r["stats"]["all_reduce"]["bytes"]
            assert "collective-permute" not in coll  # one chunk: no ring


# -- the trainer and the executor -----------------------------------------------


class TestTrainerRecord:
    def test_cached_by_program_key(self):
        trainer, _ = _trainer()
        trainer.prepare()
        first = trainer.attribution()
        assert first is not None
        assert trainer.attribution() is first

    def test_dropped_when_its_step_leaves_the_cache(self):
        trainer, _ = _trainer()
        state = trainer.prepare()
        first_key = trainer._active_key()
        trainer.attribution()
        trainer._program_cache_cap = 1
        state = trainer.retune(state, steps_per_call=2)
        assert first_key not in trainer._programs
        assert first_key not in trainer._attr_records
        record = trainer.attribution()
        assert record.steps_per_call == 2
        assert list(trainer._attr_records) == [trainer._active_key()]

    def test_off_means_none(self, _attribution_context):
        trainer, _ = _trainer()
        trainer.prepare()
        _attribution_context.attribution_enabled = False
        assert trainer.attribution() is None
        _attribution_context.attribution_enabled = True
        _attribution_context.telemetry_enabled = False
        assert trainer.attribution() is None

    def test_a_failed_capture_is_probed_once(self, monkeypatch):
        trainer, _ = _trainer()
        trainer.prepare()
        calls = []

        def broken(*args, **kwargs):
            calls.append(1)
            raise RuntimeError("no meta kernel")

        monkeypatch.setattr(attr, "capture_attribution", broken)
        assert trainer.attribution() is None
        assert trainer.attribution() is None
        assert len(calls) == 1


class _Steps(TrainHook):
    def __init__(self):
        self.seen = []

    def after_step(self, step, metrics):
        self.seen.append(step)


def _run(trainer, batch, steps=6, hooks=(), **conf):
    executor = TrainExecutor(
        trainer, train_iter_fn=lambda: [batch] * steps, hooks=list(hooks),
        conf=Configuration({"train_steps": steps, "log_every_steps": 0,
                            "train_window": 2, "preemption_grace": False,
                            **conf}))
    executor.train_and_evaluate()
    return executor


class TestExecutorGauges:
    def test_gauges_exported_and_mfu_is_the_formula(self, monkeypatch):
        process_registry().reset()
        clear_ring()
        trainer, batch = _trainer()
        observed = []
        original = TrainExecutor._observe_attribution

        def spy(self, per_step):
            original(self, per_step)
            observed.append(per_step)

        monkeypatch.setattr(TrainExecutor, "_observe_attribution", spy)
        _run(trainer, batch)
        reg = process_registry()
        record = trainer.attribution()
        # the last measured step's time through the one formula
        assert reg.get(tm.ATTR_MFU).value == pytest.approx(
            prof.derived_mfu(record.flops_per_step, observed[-1], PEAK),
            rel=1e-12)
        assert reg.get(tm.ATTR_EXPOSED_COMM_FRAC).value == pytest.approx(
            record.exposed_comm_fraction(observed[-1]), rel=1e-12)
        assert reg.get(tm.ATTR_FLOPS_PER_STEP).value == \
            record.flops_per_step
        assert reg.get(tm.ATTR_ARITH_INTENSITY).value == \
            record.arithmetic_intensity
        assert reg.get(tm.ATTR_PEAK_HBM_MB).value == 0.0
        # the CPU has no device memory to report: absent, not 0
        assert reg.get(tm.ATTR_HBM_HEADROOM_MB) is None
        text = reg.render_prometheus()
        for name in (tm.ATTR_MFU, tm.ATTR_EXPOSED_COMM_FRAC,
                     tm.ATTR_FLOPS_PER_STEP, tm.ATTR_ARITH_INTENSITY,
                     tm.ATTR_PEAK_HBM_MB, tm.ATTR_COMM_PREDICTED_S):
            assert name in text
        captured = [e for e in recent_events()
                    if e["kind"] == tm.EventKind.ATTRIBUTION_CAPTURED]
        assert len(captured) == 1  # once per built step

    def test_no_fake_zero_before_the_first_measured_step(self):
        process_registry().reset()
        trainer, batch = _trainer()
        executor = TrainExecutor(
            trainer, train_iter_fn=lambda: [batch],
            conf=Configuration({"train_steps": 1,
                                "preemption_grace": False}))
        executor.state = trainer.prepare()
        executor._fetch_attribution()
        reg = process_registry()
        assert reg.get(tm.ATTR_FLOPS_PER_STEP) is not None
        assert reg.get(tm.ATTR_MFU) is None
        assert reg.get(tm.ATTR_EXPOSED_COMM_FRAC) is None

    def test_attribution_off_means_absent_not_zero(self,
                                                   _attribution_context):
        process_registry().reset()
        _attribution_context.attribution_enabled = False
        trainer, batch = _trainer()
        _run(trainer, batch, steps=4)
        for name in (tm.ATTR_MFU, tm.ATTR_FLOPS_PER_STEP,
                     tm.ATTR_EXPOSED_COMM_FRAC, tm.ATTR_PEAK_HBM_MB):
            assert process_registry().get(name) is None

    def test_the_capture_stall_stays_out_of_the_next_step(self,
                                                          monkeypatch):
        """The capture moves the executor's clock by 1000 s (a fake
        clock, so the host's load cannot blur it): no measured step may
        hold it."""
        from dlrover_tpu_torch.trainer import executor as executor_mod

        trainer, batch = _trainer()
        slow = trainer.attribution
        offset = [0.0]
        clock = types.SimpleNamespace(
            monotonic=lambda: time.monotonic() + offset[0])
        monkeypatch.setattr(executor_mod, "time", clock)

        def stalled():
            offset[0] += 1000.0
            return slow()

        monkeypatch.setattr(trainer, "attribution", stalled)
        observed = []
        original = TrainExecutor._observe_attribution
        monkeypatch.setattr(
            TrainExecutor, "_observe_attribution",
            lambda self, s: (observed.append(s), original(self, s)))
        _run(trainer, batch, steps=4)
        assert offset[0] == 1000.0  # captured once
        assert len(observed) == 4 and max(observed) < 1000.0

    def test_retune_to_k4_gives_a_record_per_step(self):
        clear_ring()
        trainer, batch = _trainer()
        box = []

        class Retune(TrainHook):
            def before_step(self, step):
                if step == 3:
                    box[0].request_retune(steps_per_call=4)

        executor = TrainExecutor(
            trainer, train_iter_fn=lambda: [batch] * 10, hooks=[Retune()],
            conf=Configuration({"train_steps": 10, "log_every_steps": 0,
                                "train_window": 2,
                                "preemption_grace": False}))
        box.append(executor)
        executor.train_and_evaluate()
        captured = [e for e in recent_events()
                    if e["kind"] == tm.EventKind.ATTRIBUTION_CAPTURED]
        assert [e["steps_per_call"] for e in captured] == [1, 4]
        assert captured[1]["flops_per_step"] == captured[0]["flops_per_step"]
        assert executor._attr_record.steps_per_call == 4


@pytest.fixture(scope="module")
def reshard_world():
    cfg = llama.llama_tiny()
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (6, 8, 17))
    batches = [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]
    return run_local(workers.attribution_reshard_ranks, 4,
                     (batches, 1e-2, 4, 2), timeout=240)


class TestLiveReshard:
    def test_a_new_record_is_captured_for_the_new_world(self,
                                                        reshard_world):
        for r in reshard_world[2:]:
            assert r["result"]["left_world"]
            assert [e["n_devices"] for e in r["captured"]] == [4]
        for r in reshard_world[:2]:
            assert r["result"]["step"] == 6
            assert [e["n_devices"] for e in r["captured"]] == [4, 2]
            assert r["record"]["n_devices"] == 2 and r["cached"] == 1

    def test_the_gradient_all_reduce_is_counted(self, reshard_world):
        for r in reshard_world[:2]:
            moved = r["record"]["collective_bytes"]["all-reduce"]
            # every gradient, the norm's shard term and the loss (f32)
            assert moved == r["param_bytes"] + 8
            assert r["record"]["predicted_comm_s"]["all-reduce"] == \
                round(moved / planner.CPU_PLACEHOLDER.ici_bw, 6)
        # two ranks run two microbatches each: the same work a rank
        four = reshard_world[0]["captured"][0]["flops_per_step"]
        two = reshard_world[0]["captured"][1]["flops_per_step"]
        assert two == pytest.approx(2 * four, rel=1e-6)


# -- Prometheus text and trace ids ----------------------------------------------


def _fill(reg):
    reg.counter(tm.TRAIN_STEPS, help="optimizer steps materialized").inc(7)
    reg.gauge(tm.ATTR_MFU, help="live MFU").set(0.4125)
    reg.gauge(tm.ATTR_FLOPS_PER_STEP).set(1.5e12)
    g = reg.gauge(tm.ATTR_HBM_HEADROOM_MB, help="free MB")
    g.set(10.0)
    g.inc(2.5)
    g.dec(0.5)
    h = reg.histogram(tm.STEP_TIME, help="per-step wall time")
    for v in (0.0004, 0.02, 0.2, 3.0, 100.0):
        h.observe(v)


def test_metrics_text_equals_the_reference_registry():
    ours, theirs = MetricsRegistry(), jax_metrics.MetricsRegistry()
    _fill(ours)
    _fill(theirs)
    assert ours.render_prometheus() == theirs.render_prometheus()
    assert ours.get(tm.ATTR_HBM_HEADROOM_MB).value == 12.0
    assert MetricsRegistry().render_prometheus() == ""


class TestTraceIds:
    def test_scopes_nest_and_restore_as_the_reference(self, monkeypatch):
        monkeypatch.delenv(trace_context.TRACE_ID_ENV, raising=False)
        assert trace_context.TRACE_ID_ENV == jax_trace.TRACE_ID_ENV
        assert trace_context.current_trace_id() == ""
        with trace_context.trace_scope("inc-outer") as outer:
            assert outer == "inc-outer"
            with trace_context.trace_scope() as inner:
                assert inner.startswith("inc-") and len(inner) == 20
                assert trace_context.current_trace_id() == inner
            assert trace_context.current_trace_id() == "inc-outer"
        assert trace_context.current_trace_id() == ""
        monkeypatch.setenv(trace_context.TRACE_ID_ENV, "inc-env")
        assert trace_context.current_trace_id() == "inc-env"
        assert jax_trace.current_trace_id() == "inc-env"
        token = trace_context.set_trace_id("inc-set")
        assert trace_context.current_trace_id() == "inc-set"
        trace_context.reset_trace_id(token)
        assert trace_context.current_trace_id() == "inc-env"

    def test_emit_event_stamps_the_ambient_id(self, monkeypatch):
        monkeypatch.delenv(trace_context.TRACE_ID_ENV, raising=False)
        with trace_context.trace_scope("inc-0123456789abcdef"):
            inside = emit_event("probe", detail=1)
        outside = emit_event("probe")
        assert inside["trace_id"] == "inc-0123456789abcdef"
        assert "trace_id" not in outside

    def test_a_rollback_runs_under_one_incident(self, tmp_path):
        clear_ring()
        calls = {"n": 0}
        base = llama.make_loss_fn(llama.llama_tiny(use_flash=True))

        def loss_fn(params, batch, rng):
            calls["n"] += batch["input_ids"].device.type != "meta"
            loss, aux = base(params, batch, rng)
            return (loss * float("nan") if calls["n"] == 4 else loss), aux

        cfg = llama.llama_tiny(use_flash=True)
        batch = _batch(cfg.vocab_size)
        trainer = ElasticTrainer(
            llama.make_init_fn(cfg), loss_fn, example.adamw(), batch,
            device="cpu", ckpt_dir=str(tmp_path),
            ckpt_interval=CheckpointInterval(steps=2))
        _run(trainer, batch, steps=6, check_finite_every_steps=1,
             on_nonfinite="rollback")
        events = {e["kind"]: e for e in recent_events()}
        failed = events[tm.EventKind.NONFINITE_STEP]
        restored = events[tm.EventKind.ROLLBACK_RESTORED]
        assert failed["trace_id"].startswith("inc-")
        assert restored["trace_id"] == failed["trace_id"]
        assert "trace_id" not in events[tm.EventKind.TRAIN_END]
