"""The port's fp8 wire format and B6's plain version against the JAX
package, on the CPU.

The encode is held to the reference bit for bit (values' bytes and
scales) on the cases of ``tests/test_quantize.py``: random rows, a zero
block, denormal and deep-denormal blocks. XLA on the CPU, like the TPU,
flushes subnormal f32 to zero, so the deep-denormal block (1e-43, a
subnormal input) reads as a zero block there: its scale is 1.0, where
the port, which keeps subnormals as the GPU does, floors it at the
smallest normal f32. That case is compared with the port's CPU
flushing subnormals too (``torch.set_flush_denormal``); either way its
values are zeros.

B6's plain version (what the wrapper runs on CPU tensors) is held to the
Pallas kernel in interpret mode on the same e4m3 bytes, carried between
the frameworks as uint8, and to the port's own contract, bitwise:
dequantize, then B4's f32 path, forward and dW.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import grouped_matmul as jax_gm
from dlrover_tpu.ops import quantize as jax_q
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.ops import grouped_matmul as gm
from dlrover_tpu_torch.ops import moe, quantize, shard_compat


@pytest.fixture(autouse=True)
def _one_cpu_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _bytes_of(t: torch.Tensor) -> bytes:
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _jax_bytes(a) -> bytes:
    return np.asarray(a).view(np.uint8).tobytes()


CASES = {
    "random": lambda: np.random.RandomState(0).randn(5, 7, 64) * 3,
    "zero_block": lambda: np.concatenate(
        [np.zeros((4, 32)), np.random.RandomState(1).randn(4, 32)], -1),
    "denormal": lambda: np.full((2, 64), 1e-20),
    "random_tiny": lambda: np.random.RandomState(0).randn(4, 64) * 1e-18,
    "deep_denormal": lambda: np.full((2, 64), 1e-43),
    "outliers": lambda: np.random.RandomState(2).randn(64, 64) * np.where(
        np.arange(64) % 17 == 0, 1e4, 1.0),
    "ragged_block": lambda: np.random.RandomState(3).randn(6, 48),
}


@contextlib.contextmanager
def _flushing(case):
    """Subnormals flushed to zero, as XLA does, for the subnormal case."""
    flush = case == "deep_denormal"
    if flush and not torch.set_flush_denormal(True):
        pytest.skip("this CPU cannot flush subnormals")
    try:
        yield
    finally:
        if flush:
            torch.set_flush_denormal(False)


class TestQuantizeMatchesTheReference:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_encode_is_bitwise_the_reference(self, case):
        x = CASES[case]().astype(np.float32)
        jv, js = jax_q.quantize_block_scaled(jnp.asarray(x))
        with _flushing(case):
            v, s = quantize.quantize_block_scaled(torch.from_numpy(x))
        assert v.dtype == quantize.WIRE_DTYPE and s.dtype == torch.float32
        assert v.shape == x.shape
        assert s.shape == x.shape[:-1] + (
            x.shape[-1] // quantize.resolve_quant_block(x.shape[-1]),)
        assert _bytes_of(v) == _jax_bytes(jv), case
        assert _bytes_of(s) == _jax_bytes(js), case

    def test_bf16_input_divides_in_f32(self):
        x = np.random.RandomState(4).randn(8, 64).astype(np.float32)
        xb = torch.from_numpy(x).to(torch.bfloat16)
        jv, js = jax_q.quantize_block_scaled(
            jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
        v, s = quantize.quantize_block_scaled(xb)
        assert _bytes_of(v) == _jax_bytes(jv)
        assert _bytes_of(s) == _jax_bytes(js)

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_decode_is_bitwise_the_reference(self, case):
        x = CASES[case]().astype(np.float32)
        v, s = quantize.quantize_block_scaled(torch.from_numpy(x))
        jv = jnp.asarray(v.view(torch.uint8).numpy()).view(jnp.float8_e4m3fn)
        want = jax_q.dequantize_block_scaled(jv, jnp.asarray(s.numpy()))
        got = quantize.dequantize_block_scaled(v, s)
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), case

    def test_resolve_quant_block_matches(self):
        for d in (7, 16, 48, 64, 96, 4096, 11008):
            assert quantize.resolve_quant_block(d) == \
                jax_q.resolve_quant_block(d)
        with pytest.raises(ValueError, match="does not divide"):
            quantize.quantize_block_scaled(torch.zeros(2, 10), block=4)
        assert quantize.FP8_MAX == jax_q.FP8_MAX == 448.0
        assert quantize.PRECISIONS == jax_q.PRECISIONS


class TestRoundTrip:
    def test_zero_blocks_decode_to_exact_zeros(self):
        v, s = quantize.quantize_block_scaled(torch.zeros(4, 64))
        assert torch.all(s == 1.0)
        assert torch.all(quantize.dequantize_block_scaled(v, s) == 0.0)

    def test_uniform_denormal_block_round_trips_exactly(self):
        tiny = torch.full((2, 64), 1e-20)
        assert torch.equal(quantize.qdq(tiny), tiny)

    def test_deep_denormal_scale_floors_and_stays_finite(self):
        v, s = quantize.quantize_block_scaled(torch.full((2, 64), 1e-43))
        assert torch.all(s >= torch.finfo(torch.float32).tiny)
        assert torch.all(torch.isfinite(
            quantize.dequantize_block_scaled(v, s)))

    def test_error_bound_relative_to_block_max(self):
        x = torch.from_numpy(
            np.random.RandomState(1).randn(64, 64).astype(np.float32) * 10)
        v, s = quantize.quantize_block_scaled(x)
        back = quantize.dequantize_block_scaled(v, s)
        amax = x.abs().reshape(64, 2, 32).amax(dim=-1)
        err = (back - x).abs().reshape(64, 2, 32)
        assert torch.all(err <= amax[:, :, None] * 2.0 ** -4 + 1e-7)
        assert v.float().abs().max().item() == quantize.FP8_MAX

    def test_dequantize_casts_last(self):
        x = torch.randn(3, 64, generator=torch.Generator().manual_seed(0))
        v, s = quantize.quantize_block_scaled(x)
        f32 = quantize.dequantize_block_scaled(v, s)
        bf = quantize.dequantize_block_scaled(v, s, torch.bfloat16)
        assert torch.equal(bf, f32.to(torch.bfloat16))


def _quant_case(rows=256, d=64, f=96, e=4, bt=64, seed=0):
    """The shapes of tests/test_quantize.py: x [256, 64] quantized,
    w [4, 64, 96], one 64-row tile per expert."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, d).astype(np.float32)
    w = rng.randn(e, d, f).astype(np.float32)
    te = np.repeat(np.arange(e), rows // bt // e).astype(np.int32)
    jv, js = jax_q.quantize_block_scaled(jnp.asarray(x))
    v = torch.from_numpy(np.asarray(jv).view(np.uint8).copy()).view(
        quantize.WIRE_DTYPE)
    s = torch.from_numpy(np.asarray(js).copy())
    return jv, js, v, s, w, te, bt


class TestGroupedMatmulQuantized:
    def test_plain_b6_matches_the_pallas_kernel(self):
        """y and dw of sum(y^2) against the interpreted Pallas kernel on
        the same e4m3 bytes: f32, 1e-5 relative."""
        jv, js, v, s, w, te, bt = _quant_case()

        def jloss(w_):
            y = jax_gm.grouped_matmul_quantized(jv, js, w_, jnp.asarray(te),
                                                bt, 512, True)
            return (y ** 2).sum(), y

        (_, jy), jdw = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(w))
        wt = torch.from_numpy(w).requires_grad_()
        y = gm.grouped_matmul_quantized(v, s, wt, torch.from_numpy(te), bt)
        (y ** 2).sum().backward()
        assert y.dtype == torch.float32
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw),
                                   rtol=1e-5, atol=1e-4)

    def test_bitwise_dequantize_then_b4_f32(self):
        """The port's own contract (the reference pins it inside itself):
        B6 equals dequantize + B4's f32 path, forward and dW, bit for
        bit."""
        _, _, v, s, w, te, bt = _quant_case(seed=1)
        tet = torch.from_numpy(te)
        xd = quantize.dequantize_block_scaled(v, s)
        w_q = torch.from_numpy(w).requires_grad_()
        w_r = torch.from_numpy(w).requires_grad_()
        y_q = gm.grouped_matmul_quantized(v, s, w_q, tet, bt)
        y_r = gm.grouped_matmul(xd, w_r, tet, bt)
        assert y_q.detach().numpy().tobytes() == \
            y_r.detach().numpy().tobytes()
        (y_q ** 2).sum().backward()
        (y_r ** 2).sum().backward()
        assert w_q.grad.numpy().tobytes() == w_r.grad.numpy().tobytes()
        assert torch.equal(
            gm.grouped_matmul_fwd_quant_plain(v, s, w_q.detach(), tet, bt),
            gm.grouped_matmul_fwd_plain(xd, w_r.detach(), tet, bt))

    def test_values_and_scales_get_no_gradient(self):
        _, _, v, s, w, te, bt = _quant_case(seed=2)
        wt = torch.from_numpy(w).requires_grad_()
        sg = s.clone().requires_grad_()
        y = gm.grouped_matmul_quantized(v, sg, wt, torch.from_numpy(te), bt)
        y.sum().backward()
        assert sg.grad is None and wt.grad is not None

    def test_wrapper_checks(self):
        _, _, v, s, w, te, bt = _quant_case()
        wt, tet = torch.from_numpy(w), torch.from_numpy(te)
        with pytest.raises(TypeError, match="e4m3fn"):
            gm.grouped_matmul_fwd_quant(v.float(), s, wt, tet, bt)
        with pytest.raises(ValueError, match="whole blocks"):
            gm.grouped_matmul_fwd_quant(v, s[:, :1].repeat(1, 3), wt, tet,
                                        bt)
        with pytest.raises(ValueError, match="one entry per tile"):
            gm.grouped_matmul_fwd_quant(v, s, wt, tet[:2], bt)
        assert gm.KERNELS["grouped_matmul_fwd_quant"]["replaces"] == \
            "dlrover_tpu/ops/grouped_matmul.py:90"
        assert gm.launch_counts()["grouped_matmul_fwd_quant"] == 0


class TestPrecisionKnob:
    def test_explicit_config_wins(self, monkeypatch):
        monkeypatch.setattr(get_context(), "moe_precision", "bf16")
        assert moe.resolve_moe_precision(
            moe.MoEConfig(num_experts=4, precision="fp8")) == "fp8"

    def test_empty_config_reads_the_context(self, monkeypatch):
        monkeypatch.setattr(get_context(), "moe_precision", "fp8_qdq")
        assert moe.resolve_moe_precision(
            moe.MoEConfig(num_experts=4)) == "fp8_qdq"
        monkeypatch.setattr(get_context(), "moe_precision", "bf16")
        assert moe.resolve_moe_precision(
            moe.MoEConfig(num_experts=4)) == "bf16"

    def test_env_override_reaches_the_context(self, monkeypatch):
        from dlrover_tpu_torch.common.config import Context

        monkeypatch.setenv("DLROVER_TPU_MOE_PRECISION", "fp8")
        monkeypatch.setenv("DLROVER_TPU_DISPATCH_CHUNKS", "4")
        ctx = Context()
        assert (ctx.moe_precision, ctx.dispatch_chunks) == ("fp8", 4)

    def test_chunks_resolve_like_precision(self, monkeypatch):
        monkeypatch.setattr(get_context(), "dispatch_chunks", 2)
        assert moe.resolve_dispatch_chunks(moe.MoEConfig(num_experts=4)) == 2
        assert moe.resolve_dispatch_chunks(
            moe.MoEConfig(num_experts=4, dispatch_chunks=4)) == 4

    def test_unknown_precision_raises(self):
        with pytest.raises(ValueError, match="unknown MoE precision"):
            moe.resolve_moe_precision(
                moe.MoEConfig(num_experts=4, precision="int3"))

    def test_probe_failure_degrades_to_bf16(self, monkeypatch):
        assert shard_compat.fp8_wire_supported(torch.device("cpu"))
        monkeypatch.setitem(shard_compat._FP8_WIRE_SUPPORTED, "cpu", False)
        assert moe.resolve_moe_precision(
            moe.MoEConfig(num_experts=4, precision="fp8"),
            torch.device("cpu")) == "bf16"
