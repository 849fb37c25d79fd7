"""Attention in the PyTorch port held against the JAX package.

Inputs come from a numpy seed and go through both the JAX function and
its port counterpart. On the CPU the port's flash wrappers take their
plain versions; the JAX flash kernels run in Pallas interpret mode, as
the JAX package's own tests run them. f32 throughout, so the tolerances
are summation-order ones: 1e-5 for outputs and lse, 1e-4 for gradients.

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_kernels.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.attention_ref import mha_reference as jax_mha
from dlrover_tpu.ops.flash_attention import (
    flash_attention_lse as jax_flash_lse,
)
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import kernel_build
from dlrover_tpu_torch.ops.attention_ref import mha_reference

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


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


def _arrays(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _qkv(b, h, hkv, s, d, seed=0):
    return _arrays([(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)], seed)


def _t(a, grad=False):
    return torch.from_numpy(a).requires_grad_(grad)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


class TestMhaReference:
    @pytest.mark.parametrize("causal,hkv,bias", [
        (True, 4, False), (False, 4, False), (True, 2, False),
        (False, 2, True),
    ], ids=["causal", "non_causal", "gqa", "gqa_bias"])
    def test_matches_jax(self, causal, hkv, bias):
        q, k, v = _qkv(2, 4, hkv, 48, 16)
        extra = {}
        jextra = {}
        if bias:
            (b,) = _arrays([(2, 1, 48, 48)], 5)
            extra, jextra = {"bias": _t(b)}, {"bias": jnp.asarray(b)}
        out = mha_reference(_t(q), _t(k), _t(v), causal=causal, **extra)
        ref = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      causal=causal, **jextra)
        _close(out, ref, FWD_TOL)

    def test_bf16_matches_jax(self):
        q, k, v = _qkv(1, 4, 2, 32, 16)
        qb, kb, vb = (_t(a).to(torch.bfloat16) for a in (q, k, v))
        out = mha_reference(qb, kb, vb)
        ref = jax_mha(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
        assert out.dtype == torch.bfloat16
        # both round the same f32 probabilities to bf16 for the second
        # product; one bf16 ulp at these magnitudes
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=1e-2, rtol=1e-2)


# (b, h, hkv, s, d, causal, jax block): block < s runs the JAX kernels
# over a multi-block grid
FLASH_CASES = {
    "causal": (1, 2, 2, 64, 32, True, 64),
    "non_causal": (1, 2, 2, 64, 32, False, 64),
    "gqa_4_2": (2, 4, 2, 64, 16, True, 64),
    "gqa_multi_block": (1, 4, 2, 128, 32, True, 32),
    # B3's edges on the card: a sequence shorter than one 64-row
    # warpgroup tile, and a GQA group of 8
    "short_seq": (1, 4, 2, 40, 32, True, 40),
    "gqa_8_1_multi_block": (1, 8, 1, 64, 16, True, 32),
}


class TestFlashAgainstJax:
    @pytest.mark.parametrize("case", sorted(FLASH_CASES))
    def test_out_lse_and_grads_with_dlse(self, case):
        b, h, hkv, s, d, causal, block = FLASH_CASES[case]
        q, k, v = _qkv(b, h, hkv, s, d, seed=1)
        dout, dlse = _arrays([(b, h, s, d), (b, h, s)], 2)

        def jfn(q, k, v):
            return jax_flash_lse(q, k, v, causal, None, block, block, True)

        (jout, jlse), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
        jgrads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out, lse = fa.flash_attention_lse(tq, tk, tv, causal,
                                          block_q=block, block_k=block)
        assert lse.dtype == torch.float32
        _close(out, jout, FWD_TOL)
        _close(lse, jlse, FWD_TOL)
        grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                    (_t(dout), _t(dlse)))
        for g, jg in zip(grads, jgrads):
            _close(g, jg, GRAD_TOL)

    def test_bf16_matches_jax(self):
        """bf16 inputs through both: the same products on bf16 values
        with f32 accumulation, probabilities rounded to bf16 at the
        same point. Out and grads within 2e-2 (a few bf16 ulps at these
        magnitudes), lse within 1e-5 (f32, from identical logits)."""
        q, k, v = _qkv(1, 4, 2, 64, 32, seed=3)
        dout, dlse = _arrays([(1, 4, 64, 32), (1, 4, 64)], 4)
        bf = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
        (jout, jlse), vjp = jax.vjp(
            lambda q, k, v: jax_flash_lse(q, k, v, True, None, 64, 64,
                                          True), *bf)
        jgrads = vjp((jnp.asarray(dout, jnp.bfloat16), jnp.asarray(dlse)))
        tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16).requires_grad_() for a in bf)
        out, lse = fa.flash_attention_lse(tq, tk, tv, True)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        _close(lse, jlse, FWD_TOL)
        grads = torch.autograd.grad(
            (out, lse), (tq, tk, tv),
            (_t(dout).to(torch.bfloat16), _t(dlse)))
        for got, ref in zip((out,) + grads, (jout,) + tuple(jgrads)):
            np.testing.assert_allclose(got.float().detach().numpy(),
                                       np.asarray(ref, np.float32),
                                       atol=2e-2, rtol=2e-2)

    def test_flash_matches_mha_reference(self):
        q, k, v = (_t(a) for a in _qkv(1, 4, 2, 40, 16))
        for causal in (True, False):
            np.testing.assert_allclose(
                fa.flash_attention(q, k, v, causal).numpy(),
                mha_reference(q, k, v, causal=causal).numpy(),
                atol=FWD_TOL, rtol=FWD_TOL)

    def test_default_scale_is_inverse_sqrt_head_dim(self):
        q, k, v = (_t(a) for a in _qkv(1, 2, 2, 16, 16))
        np.testing.assert_array_equal(
            fa.flash_attention(q, k, v).numpy(),
            fa.flash_attention(q, k, v, True, 0.25).numpy())

    def test_causal_requires_equal_lengths(self):
        q = torch.zeros(1, 2, 8, 16)
        k = torch.zeros(1, 2, 4, 16)
        with pytest.raises(ValueError, match="s_q == s_k"):
            fa.flash_attention(q, k, k, causal=True)
        assert fa.flash_attention(q, k, k, causal=False).shape == q.shape

    def test_gqa_maps_head_to_kv_head_by_division(self):
        # query head h reads kv head h // group: heads 0,1 see kv 0
        q, k, v = (_t(a) for a in _qkv(1, 4, 2, 16, 16))
        out = fa.flash_attention(q, k, v, causal=False)
        for h in range(4):
            one = fa.flash_attention(q[:, h:h + 1], k[:, h // 2:h // 2 + 1],
                                     v[:, h // 2:h // 2 + 1], causal=False)
            np.testing.assert_allclose(out[:, h:h + 1].numpy(), one.numpy(),
                                       atol=1e-6)


class TestNoFallback:
    def test_cpu_tensors_take_the_plain_path(self):
        fa.reset_launch_counts()
        q, k, v = (_t(a, True) for a in _qkv(1, 2, 1, 32, 16))
        out = fa.flash_attention(q, k, v)
        out.sum().backward()
        assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkv": 0,
                                      "flash_bwd_dq": 0, "flash_fwd_seg": 0,
                                      "flash_bwd_dkv_seg": 0,
                                      "flash_bwd_dq_seg": 0,
                                      "flash_fwd_pfx": 0,
                                      "flash_bwd_dkv_pfx": 0,
                                      "flash_bwd_dq_pfx": 0}

    def test_other_devices_raise(self):
        # a device with neither a kernel nor a plain version (the meta
        # device has its own path: empty outputs, nothing launched)
        other = types.SimpleNamespace(device=torch.device("xpu"))
        with pytest.raises(ValueError, match="no kernel"):
            kernel_build.on_cpu("flash attention", other, other)
        q = torch.zeros(1, 2, 8, 16, device="meta")
        out, lse = fa.flash_fwd(q, q, q, True, 0.25)
        assert out.device.type == "meta" and out.shape == q.shape
        assert lse.shape == (1, 2, 8)

    def test_shapes_are_checked_before_any_kernel(self):
        q = torch.zeros(1, 4, 8, 16)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_fwd(q, torch.zeros(1, 2, 8, 32),
                         torch.zeros(1, 2, 8, 32), True, 0.25)
        with pytest.raises(ValueError, match="not divisible"):
            fa.flash_fwd(q, torch.zeros(1, 3, 8, 16),
                         torch.zeros(1, 3, 8, 16), True, 0.25)
        kv = torch.zeros(1, 2, 8, 16)
        with pytest.raises(ValueError, match="lse/delta"):
            fa.flash_bwd_dq(q, kv, kv, q, torch.zeros(1, 4, 7),
                            torch.zeros(1, 4, 8), True, 0.25)

    def test_mixed_devices_raise(self):
        q = torch.zeros(1, 2, 8, 16)
        with pytest.raises(ValueError, match="several devices"):
            fa.flash_fwd(q, q.to("meta"), q, True, 0.25)
