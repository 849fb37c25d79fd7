"""The port's Llama against the JAX package's, through ``interop``.

The JAX parameters (``llama.init`` from a PRNG key) are converted to the
port's tree; both packages then run the same token ids. ``llama_tiny``
computes in f32, so the tolerances are summation-order ones: 2e-5 on
logits, loss and gradients (absolute and relative), 1e-6 on elementwise
pieces.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import common as jax_common
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.models import losses as jax_losses
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import common, llama, losses
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import flash_attention as fa

TOL = 2e-5


@pytest.fixture(autouse=True)
def _torch_settings():
    """f32 results are compared: no TF32 in matmuls or convolutions. One
    CPU thread: these shapes are tiny, and the suite's other workers
    run timing-sensitive tests beside them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved[:2]
    torch.set_num_threads(saved[2])


def _jax_params(cfg, seed=0):
    return jax.device_get(jax_llama.init(jax.random.PRNGKey(seed), cfg))


def _batch(b=2, s=32, vocab=256, seed=0):
    ids = np.random.RandomState(seed).randint(0, vocab, size=(b, s + 1))
    return ids[:, :-1], ids[:, 1:]


def _port_cfg(jax_cfg, **kw):
    return llama.llama_tiny(use_flash=jax_cfg.use_flash, **kw)


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


class TestInterop:
    def test_round_trip_is_bitwise_f32(self):
        tree = _jax_params(jax_llama.llama_tiny())
        back = interop.params_to_numpy(
            interop.params_from_numpy(tree, device="cpu"))
        flat, flat_back = _flatten(tree), _flatten(back)
        assert flat.keys() == flat_back.keys()
        for key, a in flat.items():
            assert flat_back[key].dtype == np.float32
            np.testing.assert_array_equal(flat_back[key], a)

    def test_port_to_jax_to_port_is_bitwise(self):
        params = llama.init(torch.Generator().manual_seed(3),
                            llama.llama_tiny())
        again = interop.params_from_numpy(
            jax.device_get(jax.tree.map(
                jnp.asarray, interop.params_to_numpy(params))),
            device="cpu")
        for a, b in zip(tree_leaves(params), tree_leaves(again)):
            assert torch.equal(a, b)

    def test_bf16_leaves_keep_their_bits(self):
        tree = {"w": np.asarray(jnp.asarray(
            np.random.RandomState(0).randn(4, 8), jnp.bfloat16))}
        t = interop.params_from_numpy(tree, device="cpu")["w"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            interop.params_to_numpy({"w": t})["w"],
            tree["w"].astype(np.float32))

    def test_layout_matches_the_reference(self):
        cfg = jax_llama.llama_tiny()
        jax_shapes = {k: v.shape for k, v in
                      _flatten(_jax_params(cfg)).items()}
        port = llama.init(torch.Generator().manual_seed(0),
                          llama.llama_tiny())
        assert {k: tuple(v.shape) for k, v in _flatten(port).items()} \
            == jax_shapes


class TestPieces:
    def test_rope_matches(self):
        rs = np.random.RandomState(0)
        x = rs.randn(2, 12, 4, 16).astype(np.float32)
        pos = np.broadcast_to(np.arange(12), (2, 12))
        out = llama._rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                          500000.0)
        ref = jax_llama._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                                   rtol=1e-6)

    def test_rms_norm_bf16_casts_before_the_scale(self):
        rs = np.random.RandomState(1)
        x = rs.randn(3, 64).astype(np.float32)
        scale = (1 + 0.1 * rs.randn(64)).astype(np.float32)
        out = common.rms_norm(torch.from_numpy(x).to(torch.bfloat16),
                              torch.from_numpy(scale), 1e-5)
        ref = jax_common.rms_norm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(scale), 1e-5)
        assert out.dtype == torch.bfloat16
        # same cast points, so at most one bf16 rounding apart
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2 ** -7, atol=0)

    def test_masked_and_chunked_losses_match(self):
        rs = np.random.RandomState(2)
        logits = rs.randn(2, 16, 32).astype(np.float32)
        labels = rs.randint(0, 32, (2, 16))
        labels[0, :3] = losses.IGNORE_INDEX
        out = losses.masked_lm_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels), 1e-4)
        ref = jax_losses.masked_lm_loss(jnp.asarray(logits),
                                        jnp.asarray(labels), 1e-4)
        np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
        hidden = rs.randn(2, 16, 8).astype(np.float32)
        kernel = rs.randn(8, 32).astype(np.float32)
        chunked = losses.chunked_lm_head_loss(
            torch.from_numpy(hidden), torch.from_numpy(kernel),
            torch.from_numpy(labels), chunk_size=6)
        full = losses.masked_lm_loss(
            torch.from_numpy(hidden) @ torch.from_numpy(kernel),
            torch.from_numpy(labels))
        np.testing.assert_allclose(chunked.item(), full.item(), rtol=1e-6)

    @pytest.mark.parametrize("cfg_fn", ["llama2_7b", "llama3_8b",
                                        "llama_tiny"])
    def test_param_count_and_flops_match(self, cfg_fn):
        port, ref = getattr(llama, cfg_fn)(), getattr(jax_llama, cfg_fn)()
        assert llama.param_count(port) == jax_llama.param_count(ref)
        assert llama.flops_per_token(port) == jax_llama.flops_per_token(ref)


class TestLlamaAgainstJax:
    @pytest.mark.parametrize("jax_flash", [False, True],
                             ids=["reference_attn", "jax_flash_interpret"])
    def test_logits_loss_and_grads(self, jax_flash):
        jcfg = jax_llama.llama_tiny(use_flash=jax_flash,
                                    flash_interpret=True)
        tree = _jax_params(jcfg)
        ids, labels = _batch()
        jparams = jax.tree.map(jnp.asarray, tree)
        jbatch = {"input_ids": jnp.asarray(ids),
                  "labels": jnp.asarray(labels)}
        jlogits, _ = jax_llama.apply(jparams, jbatch["input_ids"], jcfg)
        (jloss, _), jgrads = jax.value_and_grad(
            jax_llama.make_loss_fn(jcfg), has_aux=True)(
                jparams, jbatch, jax.random.PRNGKey(0))

        # the port runs the same attention mode: plain flash vs JAX's
        # interpreted flash kernels, reference vs reference
        cfg = _port_cfg(jcfg)
        params = interop.params_from_numpy(tree, device="cpu")
        for t in tree_leaves(params):
            t.requires_grad_()
        batch = {"input_ids": torch.from_numpy(ids),
                 "labels": torch.from_numpy(labels)}
        logits, _ = llama.apply(params, batch["input_ids"], cfg)
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=TOL, rtol=TOL)
        loss, _ = llama.make_loss_fn(cfg)(params, batch, None)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
        loss.backward()
        flat_j = _flatten(jax.device_get(jgrads))
        flat_p = _flatten(params)
        for key, jg in flat_j.items():
            np.testing.assert_allclose(
                flat_p[key].grad.numpy(), jg, atol=TOL, rtol=TOL,
                err_msg=key)

    def test_causality(self):
        cfg = llama.llama_tiny(remat_policy="none")
        params = llama.init(torch.Generator().manual_seed(0), cfg)
        ids = torch.zeros((1, 16), dtype=torch.long)
        ids2 = ids.clone()
        ids2[0, 10] = 7
        l1, _ = llama.apply(params, ids, cfg)
        l2, _ = llama.apply(params, ids2, cfg)
        torch.testing.assert_close(l1[0, :10], l2[0, :10], atol=1e-5,
                                   rtol=0)
        assert not torch.allclose(l1[0, 10:], l2[0, 10:], atol=1e-5)


class TestRemat:
    @pytest.mark.parametrize("policy,calls_per_layer", [
        ("none", 1), ("full", 2), ("dots_saveable", 2),
    ])
    def test_forward_kernel_runs_per_policy(self, monkeypatch, policy,
                                            calls_per_layer):
        """dots_saveable keeps product outputs but not the attention
        kernel's, so the backward re-runs the forward once per layer
        (what chip_smoke.py's launch count expects)."""
        calls = []
        real = fa._launch_fwd  # what the autograd forward launches B1 by

        def counting(*args):
            calls.append(1)
            return real(*args)

        monkeypatch.setattr(fa, "_launch_fwd", counting)
        cfg = llama.llama_tiny(use_flash=True, remat_policy=policy)
        params = llama.init(torch.Generator().manual_seed(0), cfg)
        for t in tree_leaves(params):
            t.requires_grad_()
        ids, labels = _batch(b=1, s=16)
        loss, _ = llama.make_loss_fn(cfg)(
            params, {"input_ids": torch.from_numpy(ids),
                     "labels": torch.from_numpy(labels)}, None)
        loss.backward()
        assert len(calls) == cfg.num_layers * calls_per_layer

    def test_policies_do_not_change_gradients(self):
        ids, labels = _batch(b=1, s=16)
        batch = {"input_ids": torch.from_numpy(ids),
                 "labels": torch.from_numpy(labels)}
        grads = {}
        for policy in ("none", "dots_saveable", "full"):
            cfg = llama.llama_tiny(use_flash=True, remat_policy=policy)
            params = llama.init(torch.Generator().manual_seed(0), cfg)
            for t in tree_leaves(params):
                t.requires_grad_()
            loss, _ = llama.make_loss_fn(cfg)(params, batch, None)
            grads[policy] = torch.autograd.grad(loss, tree_leaves(params))
        for policy in ("dots_saveable", "full"):
            for a, b in zip(grads["none"], grads[policy]):
                torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)

    def test_unknown_policy_raises(self):
        from dlrover_tpu_torch.ops.remat import apply_remat

        with pytest.raises(ValueError, match="unknown remat policy"):
            apply_remat(lambda x: x, "bogus")


class TestLaterSlicesRaise:
    @pytest.mark.parametrize("override,item", [
        # grouped_ep runs (tests/test_torch_ep.py); its pairing with the
        # fp8 FSDP wire does not yet
        ({"num_experts": 4, "moe_dispatch": "grouped_ep",
          "fsdp_precision": "fp8"}, "A14"),
        ({"seq_axis": "seq"}, "A13"),
        ({"fsdp_precision": "fp8"}, "A14"),
    ])
    def test_config_options(self, override, item):
        cfg = dataclasses.replace(llama.llama_tiny(), **override)
        with pytest.raises(NotImplementedError, match=item):
            llama.apply({}, torch.zeros((1, 4), dtype=torch.long), cfg)

    def test_serving_raises(self):
        cfg = llama.llama_tiny()
        params = llama.init(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(NotImplementedError, match="A16"):
            llama.decode_step(params)


def _packed(b=2, s=32, vocab=256, seed=0):
    """Token ids, segment ids and labels of packed rows: documents
    separated by ids (a -1 pad tail on the second row), labels -100
    across each boundary and on pads, as the reference's packer writes
    them."""
    ids, labels = _batch(b, s, vocab, seed)
    seg = np.array([[0] * 10 + [1] * 14 + [2] * 8,
                    [5] * 20 + [6] * 7 + [-1] * 5], np.int32)[:b, :s]
    labels = labels.copy()
    labels[:, :-1][seg[:, :-1] != seg[:, 1:]] = -100
    labels[seg == -1] = -100
    return ids, seg, labels


class TestPackedLlamaAgainstJax:
    """``segment_ids`` through ``apply``: per-document RoPE positions and
    attention within each document, against the JAX package's."""

    def _jax(self, jcfg, tree, ids, seg, labels):
        jparams = jax.tree.map(jnp.asarray, tree)
        jbatch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels),
                  "segment_ids": jnp.asarray(seg)}
        jlogits, _ = jax_llama.apply(jparams, jbatch["input_ids"], jcfg,
                                     segment_ids=jbatch["segment_ids"])
        (jloss, _), jgrads = jax.value_and_grad(
            jax_llama.make_loss_fn(jcfg), has_aux=True)(
                jparams, jbatch, jax.random.PRNGKey(0))
        return jlogits, jloss, jgrads

    def _port(self, cfg, tree, ids, seg, labels):
        params = interop.params_from_numpy(tree, device="cpu")
        for t in tree_leaves(params):
            t.requires_grad_()
        batch = {"input_ids": torch.from_numpy(ids),
                 "labels": torch.from_numpy(labels),
                 "segment_ids": torch.from_numpy(seg)}
        logits, _ = llama.apply(params, batch["input_ids"], cfg,
                                segment_ids=batch["segment_ids"])
        loss, _ = llama.make_loss_fn(cfg)(params, batch, None)
        loss.backward()
        return logits, loss, params

    def _compare(self, got, want):
        """Logits and loss within 1e-5, gradients within 1e-4 (f32)."""
        (logits, loss, params), (jlogits, jloss, jgrads) = got, want
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
        flat_p = _flatten(params)
        for key, jg in _flatten(jax.device_get(jgrads)).items():
            np.testing.assert_allclose(
                flat_p[key].grad.numpy(), jg, atol=1e-4, rtol=1e-4,
                err_msg=key)

    @pytest.mark.parametrize("jax_flash", [False, True],
                             ids=["reference_attn", "jax_flash_interpret"])
    def test_logits_loss_and_grads(self, jax_flash):
        jcfg = jax_llama.llama_tiny(use_flash=jax_flash,
                                    flash_interpret=True)
        tree = _jax_params(jcfg)
        data = _packed()
        want = self._jax(jcfg, tree, *data)
        self._compare(self._port(_port_cfg(jcfg), tree, *data), want)

    @pytest.mark.parametrize("policy", ["none", "full"])
    def test_remat_policy_keeps_the_ids(self, policy):
        """The ids reach every layer through the remat wrapper's partial
        under each policy (the JAX side under its default)."""
        jcfg = jax_llama.llama_tiny(use_flash=True, flash_interpret=True)
        tree = _jax_params(jcfg, seed=1)
        data = _packed(seed=1)
        want = self._jax(jcfg, tree, *data)
        cfg = _port_cfg(jcfg, remat_policy=policy)
        self._compare(self._port(cfg, tree, *data), want)

    def test_positions_restart_per_document(self):
        """A document's logits do not depend on what precedes it in the
        row: the same tokens packed after another document, or alone."""
        cfg = llama.llama_tiny(remat_policy="none")
        params = llama.init(torch.Generator().manual_seed(0), cfg)
        ids = torch.from_numpy(_batch(b=1, s=24)[0])
        seg = torch.tensor([[0] * 10 + [1] * 14], dtype=torch.int32)
        packed, _ = llama.apply(params, ids, cfg, segment_ids=seg)
        alone, _ = llama.apply(params, ids[:, 10:], cfg)
        torch.testing.assert_close(packed[:, 10:], alone, atol=1e-5,
                                   rtol=1e-5)
