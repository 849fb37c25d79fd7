"""The port's MoE against the JAX package's, on the CPU in f32.

Inputs come from numpy seeds and go to both packages: the routing core,
the grouped matmul (the port's plain version against the Pallas kernel
in interpret mode) with both gradients, ``moe_ffn`` in its three
single-device dispatches, the MoE Llama's loss and gradients through
``interop``, and a 5-step TrainExecutor trajectory.

Routing ties: ``_routing`` takes an argmax over f32 softmax
probabilities, and a last-bit difference between the frameworks could
flip a token whose top choices tie, changing its output wholesale. The
router inputs here are seeded so that every token's top-(k+1)
probabilities are more than 1e-5 apart (each test asserts it), and the
routing decisions are compared before the outputs.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops import grouped_matmul as jax_gm
from dlrover_tpu.ops import moe as jax_moe
from dlrover_tpu.parallel import mesh as jax_mesh
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer.conf import build_configuration as jax_conf
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxTrainer
from dlrover_tpu.trainer.executor import TrainExecutor as JaxExecutor
from dlrover_tpu.trainer.executor import TrainHook as JaxHook
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.examples import train_llama as example
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import grouped_matmul as gm
from dlrover_tpu_torch.ops import moe
from dlrover_tpu_torch.parallel import mesh
from dlrover_tpu_torch.parallel.strategy import Strategy
from dlrover_tpu_torch.trainer.conf import build_configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import TrainExecutor, TrainHook

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARGIN = 1e-5  # least gap between a token's top-(k+1) router probabilities


@pytest.fixture(autouse=True)
def _torch_settings():
    """f32 results are compared: no TF32. One CPU thread: the shapes are
    tiny, and the suite's other workers run timing-sensitive tests."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_num_threads(saved[1])


def _assert_margins(logits: np.ndarray, k: int):
    """Every token's top-(k+1) probabilities differ by more than MARGIN,
    so neither framework's last bit can flip a routing decision."""
    z = logits.astype(np.float64)
    p = np.exp(z - z.max(axis=-1, keepdims=True))
    p /= p.sum(axis=-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    assert np.diff(-top, axis=-1).min() > MARGIN


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], f"{prefix}/{key}"))
        return out
    return {prefix: tree}


class TestRouting:
    @pytest.mark.parametrize("top_k", [1, 2])
    @pytest.mark.parametrize("capacity", [5, 48], ids=["drops", "cap_T"])
    def test_routing_matches(self, top_k, capacity):
        """Rounds (expert, position, keep) exactly, gates, aux loss and
        metrics within 1e-6; with capacity 5 of 48 tokens some drop."""
        logits = np.random.RandomState(11).randn(48, 4).astype(np.float32)
        _assert_margins(logits, top_k)
        j_rounds, j_aux, j_m = jax_moe._routing(jnp.asarray(logits),
                                                capacity, top_k, None, 0.0)
        rounds, aux, m = moe._routing(torch.from_numpy(logits), capacity,
                                      top_k, None, 0.0)
        assert len(rounds) == len(j_rounds) == top_k
        for (idx, pos, keep, gate), (jidx, jpos, jkeep, jgate) in zip(
                rounds, j_rounds):
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
            np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
            np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
            np.testing.assert_allclose(gate.numpy(), np.asarray(jgate),
                                       atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(aux.item(), float(j_aux), rtol=1e-6)
        for key in ("dropped_frac", "expert_load", "frac_tokens",
                    "frac_probs"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(j_m[key]),
                                       atol=1e-6, rtol=1e-6, err_msg=key)
        if capacity == 5:
            assert m["dropped_frac"].item() > 0

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_router_dispatch_materialises_the_same_slots(self, top_k):
        """The [T, E, C] dispatch mask exactly, combine weights and aux
        loss within 1e-6, at a capacity that drops."""
        logits = np.random.RandomState(11).randn(48, 4).astype(np.float32)
        _assert_margins(logits, top_k)
        jd, jc, jaux = jax_moe.router_dispatch(jnp.asarray(logits), 7,
                                               top_k)
        d, c, aux = moe.router_dispatch(torch.from_numpy(logits), 7, top_k)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6)
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
        assert d.sum(dim=0).max().item() == 1.0  # one token per slot

    def test_jitter_draws_from_the_generator(self):
        """Router jitter draws from the generator it is given: the same
        generator state gives the same routing, and without a generator
        nothing is drawn."""
        logits = torch.from_numpy(
            np.random.RandomState(0).randn(16, 4).astype(np.float32))
        out = [moe._routing(logits, 16, 1, torch.Generator().manual_seed(3),
                            0.1)[2]["frac_probs"] for _ in range(2)]
        torch.testing.assert_close(out[0], out[1], atol=0, rtol=0)
        plain = moe._routing(logits, 16, 1, None, 0.1)[2]["frac_probs"]
        assert not torch.equal(out[0], plain)


def _gm_case(tiles, d=16, f=48, bt=8, seed=0, sentinel=()):
    """x, w, tile_expert and a cotangent for ``tiles`` row tiles per
    expert; the experts in ``sentinel`` own one tile of zero rows."""
    rs = np.random.RandomState(seed)
    tile_expert = np.repeat(np.arange(len(tiles)), tiles).astype(np.int32)
    x = rs.randn(len(tile_expert) * bt, d).astype(np.float32)
    for e in sentinel:
        x[np.repeat(tile_expert, bt) == e] = 0.0
    w = (rs.randn(len(tiles), d, f) * 0.1).astype(np.float32)
    cot = rs.randn(x.shape[0], f).astype(np.float32)
    return x, w, tile_expert, cot, bt


class TestGroupedMatmul:
    @pytest.mark.parametrize("tiles,sentinel", [
        ([2, 1, 3], ()), ([1, 1, 2], (1,)),
    ], ids=["tiles_2_1_3", "sentinel_expert"])
    def test_y_dx_dw_match_the_pallas_kernel(self, tiles, sentinel):
        """The port's plain path (what the wrapper runs on CPU tensors)
        against the Pallas kernel in interpret mode: y, dx and dw of
        sum(y * cot), f32, 1e-5 absolute."""
        x, w, te, cot, bt = _gm_case(tiles, sentinel=sentinel)

        def jloss(x, w):
            y = jax_gm.grouped_matmul(x, w, jnp.asarray(te), bt, 16, True)
            return jnp.sum(y * cot), y

        (_, jy), (jdx, jdw) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                                 jnp.asarray(w))
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = gm.grouped_matmul(xt, wt, torch.from_numpy(te), bt, 16)
        (y * torch.from_numpy(cot)).sum().backward()
        for got, want in ((y, jy), (xt.grad, jdx), (wt.grad, jdw)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), atol=1e-5)
        if sentinel:
            assert wt.grad[list(sentinel)].abs().max().item() == 0.0

    def test_plain_versions_are_the_kernels_functions(self):
        """The two plain versions against a per-row loop: y and dx read
        the row's expert (dx through w^T), dw sums x^T dy per expert."""
        x, w, te, cot, bt = _gm_case([2, 1, 3])
        xt, wt, tet = map(torch.from_numpy, (x, w, te))
        row_e = np.repeat(te, bt)
        y = gm.grouped_matmul_fwd_plain(xt, wt, tet, bt)
        dx = gm.grouped_matmul_fwd_plain(torch.from_numpy(cot), wt, tet, bt,
                                         transpose_w=True)
        dw = gm.grouped_matmul_dw_plain(xt, torch.from_numpy(cot), tet, 4,
                                        bt)
        for i, e in enumerate(row_e):
            np.testing.assert_allclose(y[i].numpy(), x[i] @ w[e], atol=1e-5)
            np.testing.assert_allclose(dx[i].numpy(), cot[i] @ w[e].T,
                                       atol=1e-5)
        for e in range(3):
            sel = row_e == e
            np.testing.assert_allclose(dw[e].numpy(), x[sel].T @ cot[sel],
                                       atol=1e-4)
        assert dw[3].abs().max().item() == 0.0  # an expert with no tile

    def test_bf16_rounds_once_after_f32_accumulation(self):
        x, w, te, _, bt = _gm_case([1, 2])
        xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
        y = gm.grouped_matmul(xb, wb, torch.from_numpy(te), bt)
        assert y.dtype == torch.bfloat16
        want = gm.grouped_matmul_fwd_plain(xb.float(), wb.float(),
                                           torch.from_numpy(te), bt)
        torch.testing.assert_close(y, want.to(torch.bfloat16), atol=0,
                                   rtol=0)


class TestTileExpertContract:
    def _xw(self, tiles, d=16, f=32, bt=8, e=3):
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randn(len(tiles) * bt, d).astype(np.float32))
        w = torch.from_numpy(rs.randn(e, d, f).astype(np.float32))
        return x, w, torch.tensor(tiles, dtype=torch.int32), bt

    @pytest.mark.parametrize("tiles,match", [
        ([0, 0, 2], "absent from"), ([0, 2, 1], "NON-DECREASING"),
    ], ids=["missing_expert", "decreasing"])
    def test_refusals_match_the_reference(self, tiles, match):
        x, w, te, bt = self._xw(tiles)
        with pytest.raises(ValueError, match=match):
            gm.grouped_matmul(x, w, te, bt)
        with pytest.raises(ValueError, match=match):
            jax_gm.grouped_matmul(jnp.asarray(x.numpy()),
                                  jnp.asarray(w.numpy()),
                                  jnp.asarray(te.numpy()), bt, 16, True)

    def test_valid_call_and_shape_checks(self):
        x, w, te, bt = self._xw([0, 1, 2])
        assert gm.grouped_matmul(x, w, te, bt).shape == (24, 32)
        with pytest.raises(ValueError, match="whole tiles"):
            gm.grouped_matmul_fwd(x[:-1], w, te, bt)
        with pytest.raises(ValueError, match="one entry per tile"):
            gm.grouped_matmul_fwd(x, w, te[:2], bt)
        with pytest.raises(ValueError, match="does not match"):
            gm.grouped_matmul_fwd(x[:, :8], w, te, bt)

    def test_cuda_path_rejects_what_the_kernel_cannot_take(self):
        """The kernel-side checks run before any launch: dtype, 16-byte
        rows, int32 tile_expert and the 128-row tile multiple."""
        x, w, te, _ = self._xw([0, 1, 2], bt=128)
        name = "grouped_matmul_fwd"
        with pytest.raises(TypeError, match="not supported"):
            gm._kernel_suffix(name, te, 128, x.half(), w.half())
        with pytest.raises(ValueError, match="multiples of 8"):
            gm._kernel_suffix(name, te, 128, x[:, :12].contiguous(), w)
        with pytest.raises(TypeError, match="int32"):
            gm._kernel_suffix(name, te.long(), 128, x, w)
        with pytest.raises(ValueError, match="128-row"):
            gm._kernel_suffix(name, te, 64, x, w)
        assert gm._kernel_suffix(name, te, 256, x, w) == "f32"


def _moe_inputs(e=4, d=16, f=32, b=2, s=24, seed=2):
    params = jax.device_get(jax_moe.init_moe_params(
        jax.random.PRNGKey(seed), d, f, e))
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, d).astype(np.float32)
    cot = rs.randn(b, s, d).astype(np.float32)
    return params, x, cot


class TestMoeFfn:
    @pytest.mark.parametrize("dispatch", ["einsum", "gather", "grouped"])
    @pytest.mark.parametrize("top_k", [1, 2])
    def test_matches_the_reference(self, dispatch, top_k):
        """Output, aux loss, metrics and the gradients of
        sum(out * cot) + 0.01 aux in params and x: 1e-5 (f32)."""
        params, x, cot = _moe_inputs()
        xt2, router = x.reshape(-1, x.shape[-1]), params["router"]["kernel"]
        _assert_margins(xt2 @ router, top_k)
        capacity = (48 if dispatch == "grouped"
                    else moe._capacity(48, 4, 1.25, top_k))
        # the routing decisions first: the same experts, queue positions
        # and drops, or the outputs cannot agree
        j_rounds = jax_moe._routing(jnp.asarray(xt2) @ jnp.asarray(router),
                                    capacity, top_k, None, 0.0)[0]
        rounds = moe._routing(torch.tensor(xt2) @ torch.tensor(router),
                              capacity, top_k, None, 0.0)[0]
        for got, want in zip(rounds, j_rounds):
            for g, w in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        jcfg = jax_moe.MoEConfig(num_experts=4, top_k=top_k,
                                 dispatch=dispatch, kernel_interpret=True)

        def jloss(p, x):
            out, aux, m = jax_moe.moe_ffn(p, x, jcfg)
            return jnp.sum(out * cot) + 0.01 * aux, (out, aux, m)

        (_, (jout, jaux, jm)), (jgp, jgx) = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(
                jax.tree.map(jnp.asarray, params), jnp.asarray(x))

        tparams = interop.params_from_numpy(params, device="cpu")
        for t in tree_leaves(tparams):
            t.requires_grad_()
        xt = torch.from_numpy(x).requires_grad_()
        cfg = moe.MoEConfig(num_experts=4, top_k=top_k, dispatch=dispatch)
        out, aux, m = moe.moe_ffn(tparams, xt, cfg)
        ((out * torch.from_numpy(cot)).sum() + 0.01 * aux).backward()

        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
        assert sorted(m) == sorted(jm) == sorted(moe.PUBLIC_METRICS)
        for key in m:
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]),
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx),
                                   atol=1e-5, rtol=1e-5)
        flat_j = _flatten(jax.device_get(jgp))
        flat_p = _flatten(tparams)
        assert flat_j.keys() == flat_p.keys()
        for key, jg in flat_j.items():
            np.testing.assert_allclose(flat_p[key].grad.numpy(), jg,
                                       atol=1e-5, rtol=1e-5, err_msg=key)

    def test_grouped_is_dropless_and_pads_every_expert(self):
        """An all-zero router ties every token onto expert 0: the layout
        still gives experts 1..3 one (sentinel) tile each, nothing drops,
        and their gradients are exactly zero."""
        params, x, _ = _moe_inputs()
        params["router"]["kernel"] = np.zeros_like(params["router"]["kernel"])
        tparams = interop.params_from_numpy(params, device="cpu")
        for t in tree_leaves(tparams):
            t.requires_grad_()
        cfg = moe.MoEConfig(num_experts=4, dispatch="grouped")
        out, _, m = moe.moe_ffn(tparams, torch.from_numpy(x), cfg)
        (out ** 2).sum().backward()
        assert m["dropped_frac"].item() == 0.0
        up = tparams["experts"]["up"]["kernel"].grad
        assert up[0].abs().sum().item() > 0
        assert up[1:].abs().max().item() == 0.0
        rounds, _, _ = moe._routing(torch.zeros(48, 4), 48, 1, None, 0.0)
        lay = moe.grouped_layout(rounds, 48, 4, 8)
        assert lay.rows == 48 + 4 * 8
        assert lay.tile_expert.tolist() == [0] * 6 + [1, 2, 3] + [3]

    def test_expert_parallel_options_raise(self):
        """What still raises: an unknown dispatch or wire precision, and
        an expert group over a tensor axis (A15). With no expert group
        of size > 1, grouped_ep and its options run the one-rank
        grouped path, as the reference does."""
        params, x, _ = _moe_inputs()
        tparams = interop.params_from_numpy(params, device="cpu")
        with pytest.raises(ValueError, match="unknown MoE precision"):
            moe.moe_ffn(tparams, torch.from_numpy(x),
                        moe.MoEConfig(num_experts=4, dispatch="grouped_ep",
                                      precision="int3"))
        with pytest.raises(ValueError, match="unknown MoE dispatch"):
            moe.moe_ffn(tparams, torch.from_numpy(x),
                        moe.MoEConfig(num_experts=4, dispatch="groupd"))
        with pytest.raises(NotImplementedError, match="A15"):
            mesh.MeshPlan(data=2, tensor=2).build(4)
        want = moe.moe_ffn(tparams, torch.from_numpy(x),
                           moe.MoEConfig(num_experts=4, dispatch="grouped"))
        for kw in ({"dispatch": "grouped_ep"},
                   {"dispatch": "grouped_ep", "dispatch_chunks": 2,
                    "precision": "fp8"}):
            got = moe.moe_ffn(tparams, torch.from_numpy(x),
                              moe.MoEConfig(num_experts=4, **kw))
            torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
            torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)


def _jax_params(cfg, seed=0):
    return jax.device_get(jax_llama.init(jax.random.PRNGKey(seed), cfg))


class TestMoeLlama:
    def test_loss_metrics_and_grads_match(self):
        """llama_tiny with 4 experts, top-2, grouped dispatch: loss, the
        load-balance metrics and every gradient against JAX (the Pallas
        grouped kernel interpreted), 2e-5 as the dense model tests."""
        kw = dict(num_experts=4, moe_top_k=2, moe_dispatch="grouped")
        jcfg = jax_llama.llama_tiny(**kw)
        tree = _jax_params(jcfg)
        ids = np.random.RandomState(0).randint(0, 256, size=(2, 33))
        batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
        (jloss, jm), jgrads = jax.value_and_grad(
            jax_llama.make_loss_fn(jcfg), has_aux=True)(
                jax.tree.map(jnp.asarray, tree),
                {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(0))

        params = interop.params_from_numpy(tree, device="cpu")
        for t in tree_leaves(params):
            t.requires_grad_()
        loss, m = llama.make_loss_fn(llama.llama_tiny(**kw))(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}, None)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
        assert sorted(m) == sorted(jm)
        for key in m:
            np.testing.assert_allclose(m[key].detach().numpy(),
                                       np.asarray(jm[key]), atol=1e-6)
        flat_j, flat_p = _flatten(jax.device_get(jgrads)), _flatten(params)
        assert flat_j.keys() == flat_p.keys()
        for key, jg in flat_j.items():
            np.testing.assert_allclose(flat_p[key].grad.numpy(), jg,
                                       atol=2e-5, rtol=2e-5, err_msg=key)

    @pytest.mark.parametrize("policy,fwd_per_layer", [
        ("none", 4), ("full", 6), ("dots_saveable", 6),
    ])
    def test_grouped_kernels_run_per_policy(self, monkeypatch, policy,
                                            fwd_per_layer):
        """Per layer and step: B4 for the up and down products and their
        two dx, plus the recompute of both under remat (the grouped
        Function's output is not an aten product, so ``dots_saveable``
        does not keep it); B5 twice. chip_smoke.py expects these."""
        calls = {"fwd": 0, "dw": 0}
        real_fwd, real_dw = gm.grouped_matmul_fwd, gm.grouped_matmul_dw

        def fwd(*args, **kwargs):
            calls["fwd"] += 1
            return real_fwd(*args, **kwargs)

        def dw(*args, **kwargs):
            calls["dw"] += 1
            return real_dw(*args, **kwargs)

        monkeypatch.setattr(gm, "grouped_matmul_fwd", fwd)
        monkeypatch.setattr(gm, "grouped_matmul_dw", dw)
        cfg = llama.llama_tiny(num_experts=4, moe_top_k=2,
                               moe_dispatch="grouped", remat_policy=policy)
        params = llama.init(torch.Generator().manual_seed(0), cfg)
        for t in tree_leaves(params):
            t.requires_grad_()
        ids = np.random.RandomState(0).randint(0, 256, size=(1, 17))
        loss, _ = llama.make_loss_fn(cfg)(
            params, {"input_ids": torch.from_numpy(ids[:, :-1]),
                     "labels": torch.from_numpy(ids[:, 1:])}, None)
        loss.backward()
        assert calls == {"fwd": cfg.num_layers * fwd_per_layer,
                         "dw": cfg.num_layers * 2}

    def test_layout_and_param_count_match(self):
        cfg = jax_llama.llama_tiny(num_experts=4)
        port = llama.init(torch.Generator().manual_seed(0),
                          llama.llama_tiny(num_experts=4))
        assert {k: tuple(v.shape) for k, v in _flatten(port).items()} == \
            {k: v.shape for k, v in _flatten(_jax_params(cfg)).items()}
        # the AOT_MOE_25B.json model: llama2_7b with 8 experts
        assert llama.param_count(llama.llama2_7b(num_experts=8)) == \
            jax_llama.param_count(jax_llama.llama2_7b(num_experts=8)) == \
            25_496_391_680


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_train_llama", os.path.join(ROOT, "examples", "train_llama.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Record:
    def after_step(self, step, metrics):
        self.losses.append(float(metrics["loss"]))
        self.loads.append(np.asarray(metrics["moe_expert_load"], np.float64))


class JaxRecorder(_Record, JaxHook):
    def __init__(self):
        self.losses, self.loads = [], []


class Recorder(_Record, TrainHook):
    def __init__(self):
        self.losses, self.loads = [], []


class TestTrajectory:
    def test_five_steps_match_the_jax_executor(self):
        """The MoE model (4 experts, top-2, grouped) through both
        executors from the same init and token stream: losses to 1e-4
        relative (f32; Adam's normalised update lifts last-bit gradient
        differences), expert loads to 1e-6."""
        batch, seq, steps = 4, 32, 5
        kw = dict(num_experts=4, moe_top_k=2, moe_dispatch="grouped")
        jcfg = jax_llama.llama_tiny(**kw)
        jbatches = _jax_example().synthetic_batches(jcfg.vocab_size, batch,
                                                    seq)
        jrec = JaxRecorder()
        jtrainer = JaxTrainer(
            jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
            optax.adamw(3e-4, weight_decay=0.1), next(jbatches()),
            strategy=JaxStrategy(mesh=jax_mesh.single_device_plan(),
                                 rule_set="moe", remat_policy=""),
            devices=[jax.devices()[0]],
        )
        JaxExecutor(jtrainer, train_iter_fn=jbatches, hooks=[jrec],
                    conf=jax_conf({"train_steps": steps,
                                   "log_every_steps": 100})
                    ).train_and_evaluate()

        tree = _jax_params(jcfg)
        cfg = llama.llama_tiny(**kw)
        batches = example.synthetic_batches(cfg.vocab_size, batch, seq)
        rec = Recorder()
        trainer = ElasticTrainer(
            lambda gen: interop.params_from_numpy(tree, device="cpu"),
            llama.make_loss_fn(cfg), example.adamw(), next(batches()),
            strategy=Strategy(mesh=mesh.single_device_plan(),
                              rule_set="moe", remat_policy=""),
            device="cpu",
        )
        out = TrainExecutor(trainer, train_iter_fn=batches, hooks=[rec],
                            conf=build_configuration({
                                "train_steps": steps,
                                "log_every_steps": 100})
                            ).train_and_evaluate()
        assert out["step"] == steps
        assert len(rec.losses) == len(jrec.losses) == steps
        np.testing.assert_allclose(rec.losses, jrec.losses, rtol=1e-4)
        np.testing.assert_allclose(np.stack(rec.loads),
                                   np.stack(jrec.loads), atol=1e-6)


def test_example_runs_moe_on_the_cpu():
    out = example.main(["--preset", "tiny", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--moe_experts", "4",
                        "--device", "cpu"])
    assert out["step"] == 3
