"""The precision wires of the port (ROADMAP A14) against the JAX
package's (``tests/test_fsdp_wire.py``), on the CPU.

  * the fp8 FSDP wire equals its "fp8_qdq" reference bit for bit, loss
    and every gradient; each is within the dense parity tests' f32
    tolerance (2e-5) of the reference's ``value_and_grad`` under the
    same precision on the same weights (``interop``); bf16 against fp8
    within the reference's 5e-3 relative; the wired leaves are the
    reference's, key for key;
  * the knobs resolve as the reference's (config, Context, the probe);
    ``fsdp_prefetch`` the config's, else the Context's, at each call;
  * ``error_feedback_qdq`` equals the reference's bit for bit, and the
    errors telescope;
  * eight SGD steps of ``accelerate`` under ``grad_precision="fp8"``
    within 1e-4 relative of the reference's, within 1e-3 of bf16 and
    tighter than "fp8_nofb"; the residual mirrors the parameters;
  * the residual survives a DCP checkpoint, a HostSnapshot, a retune, a
    ``live_reshard`` from 4 to 2 gloo ranks and an Orbax checkpoint of
    the reference through ``interop``;
  * on 2 gloo ranks at fsdp = 2 the fp8 wire's loss and gradients equal
    the one-device run's within f32 tolerance, and the all-gathers move
    ``fsdp_wire_bytes_per_elem`` bytes a wired element; WSAM and the
    gradient wire there equal their one-device runs;
  * a prewarmed ``retune(fsdp_precision=...)`` builds nothing; the
    executor routes an fsdp plan to it and acks negatively a plan the
    fp8 probe would degrade.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_wire_workers as workers
from dlrover_tpu.checkpoint import ElasticCheckpointManager as JaxManager
from dlrover_tpu.checkpoint import abstract_like
from dlrover_tpu.common import comm
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops import quantize as jax_quantize
from dlrover_tpu.parallel import mesh as jax_mesh
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.planner import ModelSpec as JaxModelSpec
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxTrainer
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import quantize
from dlrover_tpu_torch.optimizers import wsam
from dlrover_tpu_torch.parallel import accelerate as accelerate_mod
from dlrover_tpu_torch.parallel import planner
from dlrover_tpu_torch.parallel.accelerate import (
    _named_leaves,
    accelerate,
    resolve_grad_precision,
)
from dlrover_tpu_torch.parallel.mesh import MeshPlan, single_device_plan
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer import elastic as elastic_mod
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import (
    OptimizerPlanHook,
    TrainExecutor,
    TrainHook,
)
from dlrover_tpu_torch.trainer.run import run_local

# the dense parity tests' f32 tolerance (tests/test_torch_model.py)
TOL = 2e-5
# the reference's bound on the fp8 wire's loss against bf16's
DRIFT = 5e-3
TIMEOUT = 240


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread: the embedding's backward sums repeated rows in a
    thread-dependent order, and the bitwise pins need one order."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def ctx(monkeypatch):
    """The port's Context, its wire knobs restored after the test."""
    c = get_context()
    for knob in ("fsdp_precision", "grad_precision", "fsdp_prefetch",
                 "moe_precision", "dispatch_chunks"):
        monkeypatch.setattr(c, knob, getattr(c, knob))
    return c


def _cfgs(**over):
    over.setdefault("num_layers", 4)
    return jax_llama.llama_tiny(**over), llama.llama_tiny(**over)


def _probe_batch(vocab, seq, rows=4, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(rows, seq + 1))
    return {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}


_TREES = {}


def _tree(num_layers=4, **over):
    """The reference's initial weights (numpy), cached by config."""
    key = (num_layers, tuple(sorted(over.items())))
    if key not in _TREES:
        jcfg = jax_llama.llama_tiny(num_layers=num_layers, **over)
        _TREES[key] = jax.device_get(
            jax_llama.init(jax.random.PRNGKey(0), jcfg))
    return _TREES[key]


_LG = {}


def _jax_loss_and_grads(precision):
    key = ("jax", precision)
    if key not in _LG:
        jcfg, _ = _cfgs(fsdp_precision=precision)
        batch = jax.tree.map(jnp.asarray, _probe_batch(256, 128))
        loss_fn = jax_llama.make_loss_fn(jcfg)
        val_grad = jax.jit(jax.value_and_grad(
            lambda p, b: loss_fn(p, b, jax.random.PRNGKey(1))[0]))
        loss, grads = val_grad(jax.tree.map(jnp.asarray, _tree()), batch)
        _LG[key] = (np.asarray(loss), dict(
            (p, np.asarray(g)) for p, g in _named_leaves(
                jax.device_get(grads))))
    return _LG[key]


def _port_loss_and_grads(precision):
    key = ("port", precision)
    if key not in _LG:
        _, cfg = _cfgs(fsdp_precision=precision)
        params = interop.params_from_numpy(_tree(), "cpu")
        named = _named_leaves(params)
        for _, t in named:
            t.requires_grad_()
        batch = {k: torch.as_tensor(v)
                 for k, v in _probe_batch(256, 128).items()}
        loss, _ = llama.make_loss_fn(cfg)(params, batch, None)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        _LG[key] = (loss.detach().numpy(), {
            p: g.numpy() for (p, _), g in zip(named, grads)})
    return _LG[key]


# -- the dequant-exact reference: fp8 == fp8_qdq, forward and backward -------


class TestFsdpWireOracle:
    def test_fp8_matches_qdq_oracle_bitwise_fwd_and_bwd(self):
        l_q, g_q = _port_loss_and_grads("fp8")
        l_r, g_r = _port_loss_and_grads("fp8_qdq")
        assert l_q.tobytes() == l_r.tobytes()
        assert g_q.keys() == g_r.keys()
        for path in g_q:
            assert g_q[path].tobytes() == g_r[path].tobytes(), path

    @pytest.mark.parametrize("precision", ["fp8", "fp8_qdq", "bf16"])
    def test_matches_the_reference(self, precision):
        """Loss and every gradient within the f32 tolerance of the JAX
        package's ``value_and_grad`` under the same wire."""
        l_p, g_p = _port_loss_and_grads(precision)
        l_j, g_j = _jax_loss_and_grads(precision)
        np.testing.assert_allclose(l_p, l_j, rtol=TOL)
        assert g_p.keys() == g_j.keys()
        for path in g_p:
            np.testing.assert_allclose(g_p[path], g_j[path], atol=TOL,
                                       rtol=TOL, err_msg=path)

    def test_fp8_drifts_from_bf16_but_boundedly(self):
        l_b, g_b = _port_loss_and_grads("bf16")
        l_q, g_q = _port_loss_and_grads("fp8")
        assert l_b.tobytes() != l_q.tobytes()
        assert abs(float(l_b) - float(l_q)) / abs(float(l_b)) < DRIFT
        assert all(np.isfinite(g).all() for g in g_q.values())

    @pytest.mark.parametrize("over", [
        {}, {"num_experts": 4, "moe_dispatch": "gather"}],
        ids=["dense", "moe"])
    def test_only_rank3_kernels_ride_the_wire(self, over):
        """The wired leaves are the reference's ``_quantize_layer_stack``
        keys exactly: the rank-3 float layer stacks (the router among
        them), no norm scale, no rank-4 expert tensor; their e4m3 values
        and scales bit for bit the reference's."""
        tree = _tree(**over)
        want = jax_llama._quantize_layer_stack(
            jax.tree.map(jnp.asarray, tree["layers"]), "fp8")
        got = llama._quantize_layer_stack(
            interop.params_from_numpy(tree, "cpu")["layers"], "fp8")
        assert set(got) == set(want)
        assert not any("norm" in k or "experts" in k for k in got)
        if over:
            assert "router/kernel" in got
        for path, form in got.items():
            v = np.asarray(want[path]["v"]).view(np.uint8)
            assert form["v"].view(torch.uint8).numpy().tobytes() == \
                v.tobytes(), path
            assert form["s"].numpy().tobytes() == \
                np.asarray(want[path]["s"]).tobytes(), path


# -- the knobs -----------------------------------------------------------------


class TestFsdpKnobResolution:
    def test_config_wins_then_context_then_default(self, ctx):
        _, cfg = _cfgs()
        ctx.fsdp_precision = "fp8"
        assert llama.resolve_fsdp_precision(cfg) == "fp8"
        assert llama.resolve_fsdp_precision(
            dataclasses.replace(cfg, fsdp_precision="bf16")) == "bf16"
        ctx.fsdp_precision = "bf16"
        assert llama.resolve_fsdp_precision(cfg) == "bf16"

    def test_the_context_knob_reaches_the_forward(self, ctx):
        """A config that leaves the wire empty runs the Context's: the
        loss of the fp8 config."""
        ctx.fsdp_precision = "fp8"
        l_ctx, _ = _port_loss_and_grads("")
        l_q, _ = _port_loss_and_grads("fp8")
        _LG.pop(("port", ""))
        assert l_ctx.tobytes() == l_q.tobytes()

    def test_unknown_precision_raises(self):
        _, cfg = _cfgs(fsdp_precision="int4")
        with pytest.raises(ValueError, match="FSDP wire precision"):
            llama.resolve_fsdp_precision(cfg)

    def test_probe_failure_degrades_to_bf16(self, monkeypatch):
        monkeypatch.setattr(llama, "fp8_wire_supported", lambda d=None: False)
        _, cfg = _cfgs(fsdp_precision="fp8")
        assert llama.resolve_fsdp_precision(cfg) == "bf16"

    def test_model_spec_resolves_the_context_knob(self, ctx):
        ctx.fsdp_precision = "fp8"
        _, cfg = _cfgs()
        assert planner.model_spec_from_llama(cfg).fsdp_precision == "fp8"
        spec = planner.model_spec_from_llama(
            dataclasses.replace(cfg, fsdp_precision="bf16"))
        assert spec.fsdp_precision == "bf16"
        assert spec.param_bytes == 4

    @pytest.mark.parametrize("precision", ["bf16", "fp8", "fp8_qdq"])
    @pytest.mark.parametrize("hidden", [4096, 64, 200])
    def test_wire_bytes_equal_the_reference_formula(self, precision,
                                                    hidden):
        kw = dict(param_count=1000, num_layers=2, hidden_size=hidden,
                  param_bytes=4, fsdp_precision=precision)
        got = planner.ModelSpec(**kw).fsdp_wire_bytes_per_elem()
        want = JaxModelSpec(seq_len=128, global_batch=8,
                            **kw).fsdp_wire_bytes_per_elem()
        assert got == want
        if precision == "fp8" and hidden % 32 == 0:
            assert got == 1.0 + 4.0 / 32

    def test_grad_precision_resolution(self, ctx, monkeypatch):
        ctx.grad_precision = "fp8"
        assert resolve_grad_precision() == "fp8"
        assert resolve_grad_precision("bf16") == "bf16"
        with pytest.raises(ValueError, match="grad precision"):
            resolve_grad_precision("int4")
        monkeypatch.setattr(accelerate_mod, "fp8_wire_supported",
                            lambda d=None: False)
        assert resolve_grad_precision("fp8") == "bf16"

    def test_prefetch_resolves_config_then_context(self, ctx, monkeypatch):
        """``resolve_fsdp_prefetch``: the config's value wins, else the
        Context's, both read at the call (as the reference's
        ``_prefetch_enabled``); the loss function's ``FsdpWire`` reads
        it at each call too, so a changed knob takes the next step."""
        from dlrover_tpu.common.config import get_context as jax_context

        theirs = jax_context()
        monkeypatch.setattr(theirs, "fsdp_prefetch", theirs.fsdp_prefetch)
        _, cfg = _cfgs()
        wire = llama.make_loss_fn(cfg).fsdp_wire
        for knob in (False, True):
            ctx.fsdp_prefetch = theirs.fsdp_prefetch = knob
            assert llama.resolve_fsdp_prefetch(cfg) is knob
            assert wire.prefetch() is knob
            jcfg, _ = _cfgs()
            assert jax_llama._prefetch_enabled(jcfg) is knob
            for over in (False, True):
                assert llama.resolve_fsdp_prefetch(dataclasses.replace(
                    cfg, fsdp_prefetch=over)) is over
                assert jax_llama._prefetch_enabled(dataclasses.replace(
                    jcfg, fsdp_prefetch=over)) is over
        # one layer has nothing to prefetch
        assert not llama.make_loss_fn(dataclasses.replace(
            cfg, num_layers=1)).fsdp_wire.prefetch()


# -- error feedback: the telescoping contract ----------------------------------


class TestErrorFeedbackTelescoping:
    @pytest.mark.parametrize("feedback", [True, False])
    def test_equals_the_reference_bitwise(self, feedback):
        rs = np.random.RandomState(5)
        g = rs.randn(6, 96).astype(np.float32) * 1e-2
        r = rs.randn(6, 96).astype(np.float32) * 1e-4
        gq, nr = quantize.error_feedback_qdq(
            torch.from_numpy(g), torch.from_numpy(r), feedback=feedback)
        jgq, jnr = jax_quantize.error_feedback_qdq(
            jnp.asarray(g), jnp.asarray(r), feedback=feedback)
        assert gq.numpy().tobytes() == np.asarray(jgq).tobytes()
        assert nr.numpy().tobytes() == np.asarray(jnr).tobytes()

    def test_residual_is_exactly_the_quantization_error(self):
        g = torch.from_numpy(
            np.random.RandomState(0).randn(8, 64).astype(np.float32))
        gq, nr = quantize.error_feedback_qdq(g, torch.zeros_like(g))
        np.testing.assert_array_equal((gq + nr).numpy(), g.numpy())

    def test_cumulative_error_telescopes_vs_accumulating(self):
        """sum(applied) = sum(raw) - final residual: the error stays one
        quantization error, where without feedback it grows linearly."""
        g = torch.from_numpy(np.random.RandomState(1).randn(4, 64).astype(
            np.float32) * 1e-2)
        per_step_err = float((quantize.qdq(g) - g).abs().max())
        assert per_step_err > 0
        steps = 64
        r = torch.zeros_like(g)
        applied_fb = torch.zeros_like(g)
        applied_nofb = torch.zeros_like(g)
        for _ in range(steps):
            gq, r = quantize.error_feedback_qdq(g, r)
            applied_fb += gq
            gq_n, _ = quantize.error_feedback_qdq(g, torch.zeros_like(g),
                                                  feedback=False)
            applied_nofb += gq_n
        raw_sum = g.numpy() * steps
        err_fb = np.abs(applied_fb.numpy() - raw_sum).max()
        err_nofb = np.abs(applied_nofb.numpy() - raw_sum).max()
        np.testing.assert_allclose(err_fb, r.abs().max().item(), rtol=1e-2)
        assert err_fb <= 4 * per_step_err
        assert err_nofb > 8 * err_fb

    def test_no_feedback_mode_drops_the_error(self):
        g = torch.from_numpy(
            np.random.RandomState(2).randn(2, 32).astype(np.float32))
        gq, nr = quantize.error_feedback_qdq(g, torch.full_like(g, 0.5),
                                             feedback=False)
        assert float(nr.abs().max()) == 0.0
        gq_ref, _ = quantize.error_feedback_qdq(g, torch.zeros_like(g))
        np.testing.assert_array_equal(gq.numpy(), gq_ref.numpy())


# -- the gradient wire in accelerate -------------------------------------------

# the reference's learning rate (tests/test_fsdp_wire.py)
GW_STEPS, GW_LR = 8, 1e-3


def _gw_batch():
    return _probe_batch(256, 128, rows=4, seed=3)


def _jax_grad_wire(gp):
    jcfg = jax_llama.llama_tiny(num_layers=2)
    tree = _tree(num_layers=2)
    batch = jax.tree.map(jnp.asarray, _gw_batch())
    result = jax_accelerate(
        lambda rng: jax.tree.map(jnp.asarray, tree),
        jax_llama.make_loss_fn(jcfg), optax.sgd(GW_LR), batch,
        strategy=JaxStrategy(mesh=jax_mesh.MeshPlan(data=1),
                             rule_set="llama"),
        devices=jax.devices()[:1], grad_precision=gp)
    state = result.init_fn(jax.random.PRNGKey(0))
    sharded = result.shard_batch(batch)
    losses = []
    for _ in range(GW_STEPS):
        state, m = result.train_step(state, sharded, jax.random.PRNGKey(7))
        losses.append(float(m["loss"]))
    return np.array(losses)


def _port_accelerate(gp, steps_per_call=1, num_layers=2):
    cfg = llama.llama_tiny(num_layers=num_layers)
    tree = _tree(num_layers=num_layers)
    return accelerate(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(cfg), functools.partial(torch.optim.SGD,
                                                   lr=GW_LR),
        _gw_batch(), strategy=Strategy(mesh=MeshPlan(data=1),
                                       rule_set="llama"),
        device="cpu", grad_precision=gp, steps_per_call=steps_per_call)


def _port_grad_wire(gp):
    result = _port_accelerate(gp)
    state = result.init_fn(0)
    placed = result.shard_batch(_gw_batch())
    losses = []
    for _ in range(GW_STEPS):
        state, m = result.train_step(state, placed)
        losses.append(float(m["loss"]))
    return np.array(losses), state


@pytest.fixture(scope="module")
def grad_wire_runs():
    return {gp: _port_grad_wire(gp) for gp in ("bf16", "fp8", "fp8_nofb")}


class TestGradWireModelLevel:
    def test_losses_match_the_reference(self, grad_wire_runs):
        np.testing.assert_allclose(grad_wire_runs["fp8"][0],
                                   _jax_grad_wire("fp8"), rtol=1e-4)

    def test_trajectory_bounded_and_tighter_than_no_feedback(
            self, grad_wire_runs):
        l_bf, state_b = grad_wire_runs["bf16"]
        l_fp8, state = grad_wire_runs["fp8"]
        l_nofb, _ = grad_wire_runs["fp8_nofb"]
        dev_fb = np.abs(l_fp8 - l_bf).max()
        dev_nofb = np.abs(l_nofb - l_bf).max()
        assert dev_fb < 1e-3, (dev_fb, dev_nofb)
        assert dev_fb < dev_nofb, (dev_fb, dev_nofb)

    def test_residual_mirrors_the_parameters(self, grad_wire_runs):
        _, state_b = grad_wire_runs["bf16"]
        _, state = grad_wire_runs["fp8"]
        assert state_b.wire_residual is None
        res = _named_leaves(state.wire_residual)
        params = _named_leaves(state.params)
        assert [(p, tuple(t.shape), t.dtype) for p, t in res] == [
            (p, tuple(t.shape), t.dtype) for p, t in params]
        assert not any(t.requires_grad for _, t in res)
        assert sum(float(t.abs().sum()) for _, t in res) > 0

    def test_multi_step_is_k_single_steps_bit_for_bit(self):
        """``train_step_multi`` under the gradient wire: K = 4 steps in
        one call equal four calls, losses, parameters and residual."""
        single = _port_accelerate("fp8")
        multi = _port_accelerate("fp8", steps_per_call=4)
        a, b = single.init_fn(0), multi.init_fn(0)
        batch = _gw_batch()
        placed = single.shard_batch(batch)
        want = []
        for _ in range(4):
            a, m = single.train_step(a, placed)
            want.append(float(m["loss"]))
        stacked = multi.shard_batch(
            {k: np.stack([v] * 4) for k, v in batch.items()}, stacked=True)
        b, m = multi.train_step_multi(b, stacked)
        assert m["loss"].tolist() == want
        for tree_a, tree_b in ((a.params, b.params),
                               (a.wire_residual, b.wire_residual)):
            for x, y in zip(tree_leaves(tree_a), tree_leaves(tree_b)):
                assert torch.equal(x, y)


# -- the residual rides the state machinery ------------------------------------


def _trainer(gp="fp8", **kw):
    cfg = llama.llama_tiny(num_layers=2)
    tree = _tree(num_layers=2)
    batch = _probe_batch(256, 16, rows=8)
    trainer = ElasticTrainer(
        lambda gen: interop.params_from_numpy(tree, "cpu"),
        llama.make_loss_fn(cfg), functools.partial(torch.optim.AdamW,
                                                   lr=1e-3),
        batch, strategy=Strategy(mesh=single_device_plan(),
                                 rule_set="llama"),
        device="cpu", grad_precision=gp, **kw)
    return trainer, batch


def _residual(state):
    return {p: t.detach().clone() for p, t in
            _named_leaves(state.wire_residual)}


def _same(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


class TestResidualRidesStateMachinery:
    def test_checkpoint_save_restore_preserves_the_residual(self, tmp_path):
        trainer, batch = _trainer(ckpt_dir=str(tmp_path))
        state = trainer.prepare()
        for _ in range(3):
            state, _ = trainer.step(state, batch)
        trainer.save(state, force=True)
        trainer.finalize()
        before = _residual(state)
        assert sum(float(t.abs().sum()) for t in before.values()) > 0
        trainer2, _ = _trainer(ckpt_dir=str(tmp_path))
        restored = trainer2.prepare()
        assert restored.step == state.step
        assert _same(_residual(restored), before)
        trainer2.finalize()
        # a state without the wire does not take a wire's checkpoint
        trainer3, _ = _trainer(gp="bf16", ckpt_dir=str(tmp_path))
        with pytest.raises(ValueError, match="residual"):
            trainer3.prepare()
        trainer3.finalize()

    def test_snapshot_and_retune_carry_the_residual(self):
        trainer, batch = _trainer()
        state = trainer.prepare()
        for _ in range(2):
            state, _ = trainer.step(state, batch)
        snap = trainer.snapshot(state)
        assert any(k.startswith("wire_residual/") for k in snap.tree)
        before = _residual(state)
        state, _ = trainer.step(state, batch)
        assert not _same(_residual(state), before)
        trainer.restore_snapshot(state, snap)
        assert _same(_residual(state), before)
        # a retune rebuilds the state from a snapshot: the residual too
        state = trainer.retune(state, steps_per_call=2)
        assert _same(_residual(state), before)

    @pytest.fixture(scope="class")
    def reshard_world(self):
        cfg_kw = {"num_layers": 2}
        batches = [_probe_batch(256, 16, rows=8, seed=s) for s in range(3)]
        return run_local(workers.residual_reshard_ranks, 4,
                         (_tree(num_layers=2), cfg_kw, batches, 1e-3),
                         timeout=TIMEOUT)

    def test_live_reshard_4_to_2_reshards_the_residual(self, reshard_world):
        got = reshard_world
        assert [r.get("left", False) for r in got] == [False, False,
                                                       True, True]
        for r in got[:2]:
            assert r["mesh_before"] == {"data": 2, "fsdp": 2}
            assert r["mesh_after"] == {"data": 1, "fsdp": 2}
            before = {k: v for k, v in r["before"].items()
                      if k.startswith("wire_residual/")}
            after = {k: v for k, v in r["after"].items()
                     if k.startswith("wire_residual/")}
            assert before and before.keys() == after.keys()
            assert sum(float(np.abs(v).sum()) for v in before.values()) > 0
            for k in before:
                assert before[k].tobytes() == after[k].tobytes(), k
            assert r["finite"]
            assert any(r["residual_after_step"][k].tobytes()
                       != after[k].tobytes() for k in after)

    def test_orbax_checkpoint_resumes_in_the_port(self, tmp_path):
        """A reference run under the fp8 gradient wire, saved by its
        Orbax manager and converted by ``interop``, resumes in the port:
        the residual bit for bit, the next steps' losses within 1e-6."""
        jcfg = jax_llama.llama_tiny(num_layers=2)
        batches = [_probe_batch(256, 16, rows=8, seed=s) for s in range(6)]
        jtrainer = JaxTrainer(
            jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
            optax.adamw(3e-4, weight_decay=0.1), batches[0],
            strategy=JaxStrategy(mesh=jax_mesh.single_device_plan(),
                                 rule_set="llama", remat_policy=""),
            devices=[jax.devices()[0]], grad_precision="fp8")
        jstate = jtrainer.prepare()
        for b in batches[:3]:
            jstate, _ = jtrainer.step(jstate, b)
        mgr = JaxManager(str(tmp_path / "orbax"), async_save=False,
                         staging_dir=str(tmp_path / "orbax_shm"))
        assert mgr.save(3, jstate, force=True)
        mgr.wait()
        jstate = mgr.restore(abstract_like(
            jstate, jtrainer.accelerated.state_sharding))["state"]
        mgr.close()
        host = jax.device_get(jstate)
        state = interop.train_state_from_numpy(
            host, functools.partial(torch.optim.AdamW, lr=3e-4,
                                    weight_decay=0.1), device="cpu")
        ours = interop.train_state_to_numpy(state)
        want = _named_leaves(host.wire_residual)
        assert sum(float(np.abs(np.asarray(v)).sum()) for _, v in want) > 0
        for (p, a), (q, b) in zip(_named_leaves(ours["wire_residual"]),
                                  want):
            assert p == q and a.tobytes() == np.asarray(b).tobytes(), p
        _, cfg = _cfgs(num_layers=2)
        trainer = ElasticTrainer(
            lambda gen: None, llama.make_loss_fn(cfg),
            functools.partial(torch.optim.AdamW, lr=3e-4, weight_decay=0.1),
            batches[0], strategy=Strategy(mesh=single_device_plan(),
                                          rule_set="llama", remat_policy=""),
            device="cpu", grad_precision="fp8")
        state = trainer.prepare(state)
        got, want_l = [], []
        for b in batches[3:]:
            jstate, jm = jtrainer.step(jstate, b)
            state, m = trainer.step(state, b)
            want_l.append(float(jm["loss"]))
            got.append(float(m["loss"]))
        np.testing.assert_allclose(got, want_l, atol=1e-7, rtol=1e-6)


# -- two ranks at fsdp = 2 ------------------------------------------------------


@pytest.fixture(scope="module")
def fsdp_world():
    batch = _probe_batch(256, 128)
    batches = [_gw_batch(), _probe_batch(256, 128, seed=4),
               _probe_batch(256, 128, seed=5)]
    got = run_local(workers.fp8_wire_ranks, 2,
                    (_tree(), {"num_layers": 4, "fsdp_precision": "fp8"},
                     batch, batches, GW_LR), timeout=TIMEOUT)
    return got, batches


def _one_device(optimizer, batches, **kw):
    _, cfg = _cfgs()
    result = accelerate(lambda gen: interop.params_from_numpy(_tree(), "cpu"),
                        llama.make_loss_fn(cfg), optimizer, batches[0],
                        strategy=Strategy(mesh=MeshPlan(data=1),
                                          rule_set="llama"),
                        device="cpu", **kw)
    state = result.init_fn(0)
    losses = []
    for b in batches:
        state, m = result.train_step(state, result.shard_batch(b))
        losses.append(float(m["loss"]))
    return losses, state


class TestTwoRanksFp8:
    def test_loss_and_gradients_equal_the_one_device_run(self, fsdp_world):
        got, _ = fsdp_world
        l_one, g_one = _port_loss_and_grads("fp8")
        for r in got:
            np.testing.assert_allclose(r["loss"], l_one, rtol=TOL)
            assert r["grads"].keys() == g_one.keys()
            for path in g_one:
                np.testing.assert_allclose(r["grads"][path], g_one[path],
                                           atol=TOL, rtol=TOL, err_msg=path)
            # optimizers.global_norm over the blocks with accelerate's
            # norm groups is the step's global norm
            np.testing.assert_allclose(r["block_norm"], r["grad_norm"],
                                       rtol=1e-6)

    def test_gather_bytes_equal_the_planner_formula(self, fsdp_world):
        got, _ = fsdp_world
        per = planner.ModelSpec(param_count=0, num_layers=4, hidden_size=64,
                                param_bytes=4, fsdp_precision="fp8"
                                ).fsdp_wire_bytes_per_elem()
        assert per == 1.125
        for r in got:
            wired = [p for p in r["sharded"] if p.startswith("layers/")
                     and len(r["shapes"][p]) == 3]
            other = [p for p in r["sharded"] if p not in wired]
            assert wired and other
            for p in wired:
                assert r["split_dims"][p] != len(r["shapes"][p]) - 1
            want = (sum(np.prod(r["shapes"][p]) for p in wired) * per
                    + sum(np.prod(r["shapes"][p]) for p in other) * 4)
            stats = r["stats"]["all_gather"]
            assert stats["bytes"] == want
            assert stats["calls"] == 2 * len(wired) + len(other)

    def test_wsam_and_the_gradient_wire_equal_one_device(self, fsdp_world):
        got, batches = fsdp_world
        want_wsam, _ = _one_device(
            wsam(functools.partial(torch.optim.SGD, lr=GW_LR),
                 learning_rate=GW_LR, max_norm=1.0), batches)
        want_gw, state = _one_device(
            functools.partial(torch.optim.SGD, lr=GW_LR), batches,
            grad_precision="fp8")
        res = {f"wire_residual/{p}": t.numpy() for p, t in
               _named_leaves(state.wire_residual)}
        for r in got:
            np.testing.assert_allclose(r["wsam"], want_wsam, rtol=1e-5)
            np.testing.assert_allclose(r["grad_wire"], want_gw, rtol=1e-5)
            # the residual, global: the f32 sums of the two runs group
            # differently, and where that moves a gradient across an
            # e4m3 rounding boundary its residual moves by a whole e4m3
            # step; a residual in the wrong layout or blocks differs
            # everywhere
            assert r["residual"].keys() == res.keys()
            diff = sum(float(np.square(r["residual"][k] - res[k]).sum())
                       for k in res)
            norm = sum(float(np.square(res[k]).sum()) for k in res)
            moved = sum(int((np.abs(r["residual"][k] - res[k]) > 1e-6).sum())
                        for k in res)
            total = sum(res[k].size for k in res)
            assert norm > 0 and diff <= 1e-4 * norm, (diff, norm)
            assert moved <= 1e-3 * total, (moved, total)


# -- live retune through the program cache -------------------------------------


class TestRetuneFsdpPrecisionZeroRecompile:
    def test_prewarmed_fsdp_retune_swaps_with_zero_builds(self, ctx):
        trainer, batch = _trainer(gp="bf16")
        state = trainer.prepare()
        state, m = trainer.step(state, batch)
        assert bool(m["finite"]) and trainer.fsdp_precision == "bf16"
        assert trainer.prewarm(fsdp_precision="fp8")
        assert trainer.fsdp_precision == "bf16"
        assert ctx.fsdp_precision == "bf16"
        before = trainer.compile_count
        state = trainer.retune(state, fsdp_precision="fp8")
        assert trainer.compile_count == before
        assert trainer.fsdp_precision == "fp8" and ctx.fsdp_precision == "fp8"
        state, m = trainer.step(state, batch)
        assert bool(m["finite"])
        state = trainer.retune(state, fsdp_precision="bf16")
        assert trainer.compile_count == before
        assert trainer.fsdp_precision == "bf16"
        state, m = trainer.step(state, batch)
        assert bool(m["finite"])

    def test_program_key_carries_both_precisions(self, ctx):
        trainer, _ = _trainer(gp="fp8")
        strategy = trainer._resolved_strategy(1)
        key = trainer._program_key(strategy)
        assert "|fp=bf16" in key and "|gp=fp8" in key
        trainer.fsdp_precision = "fp8"
        assert "|fp=fp8" in trainer._program_key(strategy)

    def test_probe_failure_runs_and_reports_bf16(self, monkeypatch):
        monkeypatch.setattr(elastic_mod, "fp8_wire_supported",
                            lambda d=None: False)
        trainer, _ = _trainer(gp="bf16", fsdp_precision="fp8")
        assert trainer.fsdp_precision == "bf16"
        assert trainer._effective_precision("fp8") == "bf16"


# -- the executor's plans -------------------------------------------------------


class _Acks:
    def __init__(self):
        self.reports = []

    def report_trainer_config(self, **kw):
        self.reports.append(kw)


class TestExecutorNacksUnsupportedFsdpPlan:
    def test_probe_degraded_plan_is_negative_acked(self):
        class _Trainer:
            fsdp_precision = moe_precision = "bf16"
            steps_per_call = dispatch_chunks = 1

            @staticmethod
            def _effective_precision(p):
                return "bf16"

        ex = TrainExecutor.__new__(TrainExecutor)
        ex._trainer = _Trainer()
        acks = []
        ex._report_trainer_config = lambda **kw: acks.append(kw)
        ex._apply_plan_scoped({"fsdp_precision": "fp8",
                               "plan_id": "plan-x"}, "plan-x")
        assert acks and acks[0]["apply_failed"] is True
        assert acks[0]["plan_id"] == "plan-x"

    def test_plan_hook_routes_the_fsdp_plan(self):
        class _Ex:
            def __init__(self):
                self.retunes = []

            def request_retune(self, **kw):
                self.retunes.append(kw)

        class _Client:
            def get_parallel_config(self):
                return comm.ParallelConfig(
                    fsdp_precision="fp8", plan_id="plan-fp",
                    trace_id="inc-fp", predicted_speedup=1.3)

        hook = OptimizerPlanHook(_Client(), poll_secs=0)
        ex = _Ex()
        hook._executor = ex
        hook.poll_once()
        hook.poll_once()  # a plan id applies once
        assert len(ex.retunes) == 1
        assert ex.retunes[0]["fsdp_precision"] == "fp8"
        assert ex.retunes[0]["moe_precision"] is None
        assert ex.retunes[0]["steps_per_call"] is None
        assert ex.retunes[0]["plan_id"] == "plan-fp"

    @pytest.mark.parametrize("probe", [True, False],
                             ids=["applied", "degraded"])
    def test_executor_applies_or_nacks_the_plan(self, ctx, monkeypatch,
                                                probe):
        """Through the executor's loop: a plan for the fp8 wire made at
        step 2 is applied at the boundary (prewarmed, nothing built by
        the retune) and acked; with the probe failing it is acked
        negatively and the trainer stays on bf16."""
        trainer, batch = _trainer(gp="bf16")
        if not probe:
            monkeypatch.setattr(elastic_mod, "fp8_wire_supported",
                                lambda d=None: False)
        client = _Acks()

        class At(TrainHook):
            def after_step(self, step, metrics):
                if step == 2:
                    ex.request_retune(fsdp_precision="fp8",
                                      plan_id="plan-fp")

        ex = TrainExecutor(trainer, train_iter_fn=lambda: [batch] * 4,
                           hooks=[At()],
                           conf=Configuration({"train_steps": 4,
                                               "log_every_steps": 0,
                                               "train_window": 1,
                                               "preemption_grace": False}))
        ex._master_client = client
        out = ex.train_and_evaluate()
        assert out["step"] == 4
        acks = [r for r in client.reports if r["plan_id"] == "plan-fp"]
        assert len(acks) == 1
        if probe:
            assert trainer.fsdp_precision == "fp8"
            assert acks[0]["apply_failed"] is False
            assert acks[0]["fsdp_precision"] == "fp8"
            assert trainer.compile_count == 2  # bf16, the prewarmed fp8
        else:
            assert trainer.fsdp_precision == "bf16"
            assert acks[0]["apply_failed"] is True
            assert trainer.compile_count == 1
