"""Packed-document (segment-id) attention in the PyTorch port held
against the JAX package.

Inputs come from a numpy seed and go through both the JAX function and
its port counterpart. On the CPU the port's flash wrappers take their
plain versions; the JAX flash kernels run in Pallas interpret mode, as
the JAX package's own tests run them, over several blocks per sequence.
f32 throughout, so the tolerances are summation-order ones: 1e-5 for
outputs and lse, 1e-4 for gradients.

The segmented kernels themselves are held to these plain versions on
the card by ``tests/test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models.common import segment_positions as jax_positions
from dlrover_tpu.ops.flash_attention import (
    flash_attention_segmented as jax_segmented,
    flash_attention_segmented_pair_lse as jax_pair_lse,
    segmented_attention as jax_segmented_attention,
)
from dlrover_tpu_torch.models.common import segment_positions
from dlrover_tpu_torch.ops import flash_attention as fa

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_settings():
    """f32 results are compared: no TF32 in matmuls. One CPU thread:
    these shapes are tiny, and the suite's other workers run
    timing-sensitive tests beside them."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_num_threads(saved[1])


def _ids(lengths, s, first=0):
    """Segment ids of one row: documents of ``lengths`` numbered from
    ``first`` (the last cut at ``s``), then a -1 pad tail to ``s``."""
    ids = np.full((s,), -1, np.int32)
    at = 0
    for n, length in enumerate(lengths):
        take = min(length, s - at)
        ids[at:at + take] = first + n
        at += take
        if at == s:
            break
    return ids


# one row each; a block is 64 or 128 tokens in the cases below
LAYOUTS = {
    # boundaries inside blocks, short and long documents
    "inside": lambda s: _ids([37, 90, 5, 61, 100, 23, 130, 64], s),
    # one document over several blocks, then two short ones
    "spanning": lambda s: _ids([s - 56, 30, 26], s, first=7),
    # three documents, then pads: -1 after higher ids
    "pad_tail": lambda s: _ids([70, 100, 60], s, first=3),
}

# (b, h, hkv, s, d, causal, jax block, one layout per batch row)
CASES = {
    "gqa_causal_256": (2, 4, 2, 256, 16, True, 64, ("inside", "spanning")),
    "mha_causal_384": (1, 2, 2, 384, 16, True, 128, ("pad_tail",)),
    "gqa_causal_384": (2, 4, 2, 384, 32, True, 128,
                       ("spanning", "pad_tail")),
    "gqa_non_causal_384": (2, 4, 2, 384, 16, False, 128,
                           ("pad_tail", "inside")),
    "mha_non_causal_256": (1, 2, 2, 256, 32, False, 64, ("spanning",)),
}


def _arrays(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


class TestSegmentedFlashAgainstJax:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_out_and_grads(self, case):
        b, h, hkv, s, d, causal, block, layouts = CASES[case]
        q, k, v, dout = _arrays([(b, h, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, h, s, d)], 1)
        seg = np.stack([LAYOUTS[name](s) for name in layouts])

        def jfn(q, k, v):
            return jax_segmented(q, k, v, jnp.asarray(seg), causal, None,
                                 block, block, True)

        jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(dout))

        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out = fa.flash_attention_segmented(tq, tk, tv, _t(seg), causal,
                                           block_q=block, block_k=block)
        _close(out, jout, FWD_TOL)
        grads = torch.autograd.grad(out, (tq, tk, tv), _t(dout))
        for g, jg in zip(grads, jgrads):
            _close(g, jg, GRAD_TOL)

    @pytest.mark.parametrize("causal,s_q,s_k", [
        (False, 128, 256), (True, 256, 256),
    ], ids=["cross", "causal"])
    def test_pair_lse_rows_without_keys(self, causal, s_q, s_k):
        """Independent q- and kv-side ids, the kv side lacking two of the
        q side's: those rows read out 0 and lse NEG_INF on both sides,
        and every gradient (with a non-zero lse cotangent) agrees."""
        b, h, hkv, d = 2, 4, 2, 16
        q, dout, dlse = _arrays([(b, h, s_q, d), (b, h, s_q, d),
                                 (b, h, s_q)], 3)
        k, v = _arrays([(b, hkv, s_k, d), (b, hkv, s_k, d)], 4)
        seg_q = np.stack([_ids([40, 30, 58], s_q), _ids([90, 38], s_q, 5)])
        # row 0 lacks id 1, row 1 lacks id 6
        seg_k = np.stack([_ids([100, 0, 156], s_k),
                          _ids([s_k - 20], s_k, 5)])
        if causal:  # the causal pair needs s_q == s_k
            seg_k = np.stack([_ids([40, 0, 58], s_k),
                              _ids([90], s_k, 5)])
        no_key = np.stack([~np.isin(seg_q[i], seg_k[i]) for i in range(b)])
        assert no_key.any() and not no_key.all()

        def jfn(q, k, v):
            return jax_pair_lse(q, k, v, jnp.asarray(seg_q),
                                jnp.asarray(seg_k), causal, None, 64, 64,
                                True)

        (jout, jlse), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
        jgrads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out, lse = fa.flash_attention_segmented_pair_lse(
            tq, tk, tv, _t(seg_q), _t(seg_k), causal)
        assert lse.dtype == torch.float32
        _close(out, jout, FWD_TOL)
        _close(lse, jlse, FWD_TOL)
        rows = np.broadcast_to(no_key[:, None, :], (b, h, s_q))
        for o, l in ((out.detach().numpy(), lse.detach().numpy()),
                     (np.asarray(jout), np.asarray(jlse))):
            assert np.all(o[rows] == 0.0)
            assert np.all(l[rows] == fa.NEG_INF)
            assert np.all(l[~rows] > fa.NEG_INF / 2)
        grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                    (_t(dout), _t(dlse)))
        for g, jg in zip(grads, jgrads):
            assert np.isfinite(g.numpy()).all()
            _close(g, jg, GRAD_TOL)


class TestSegmentedAttention:
    def test_reference_path_matches_jax(self):
        """``use_flash=False``: the reference attention with the
        additive NEG_INF bias between segments; output and gradients."""
        b, h, hkv, s, d = 2, 4, 2, 64, 16
        q, k, v, dout = _arrays([(b, h, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, h, s, d)], 5)
        seg = np.stack([_ids([10, 30, 5], s), _ids([50], s, 2)])
        jout, vjp = jax.vjp(
            lambda q, k, v: jax_segmented_attention(
                q, k, v, jnp.asarray(seg), False), *map(jnp.asarray,
                                                        (q, k, v)))
        jgrads = vjp(jnp.asarray(dout))
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out = fa.segmented_attention(tq, tk, tv, _t(seg), False)
        _close(out, jout, FWD_TOL)
        for g, jg in zip(torch.autograd.grad(out, (tq, tk, tv), _t(dout)),
                         jgrads):
            _close(g, jg, GRAD_TOL)

    def test_flash_path_matches_reference_path(self):
        b, h, hkv, s, d = 2, 4, 1, 96, 16
        q, k, v = (_t(a) for a in _arrays(
            [(b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)], 6))
        seg = _t(np.stack([LAYOUTS["inside"](s), LAYOUTS["pad_tail"](s)]))
        np.testing.assert_allclose(
            fa.segmented_attention(q, k, v, seg, True).numpy(),
            fa.segmented_attention(q, k, v, seg, False).numpy(),
            atol=FWD_TOL, rtol=FWD_TOL)

    def test_one_segment_is_plain_causal_attention(self):
        q, k, v = (_t(a) for a in _arrays(
            [(1, 4, 48, 16), (1, 2, 48, 16), (1, 2, 48, 16)], 7))
        seg = torch.full((1, 48), 3, dtype=torch.int32)
        np.testing.assert_array_equal(
            fa.flash_attention_segmented(q, k, v, seg).numpy(),
            fa.flash_attention(q, k, v).numpy())

    def test_documents_do_not_see_each_other(self):
        """Changing a token of the first document leaves the second
        document's outputs exactly as they were."""
        q, k, v = _arrays([(1, 2, 64, 16), (1, 2, 64, 16),
                           (1, 2, 64, 16)], 8)
        seg = _t(_ids([20, 44], 64)[None])
        base = fa.flash_attention_segmented(_t(q), _t(k), _t(v), seg)
        k2, v2 = k.copy(), v.copy()
        k2[:, :, 5] += 1.0
        v2[:, :, 5] -= 1.0
        moved = fa.flash_attention_segmented(_t(q), _t(k2), _t(v2), seg)
        np.testing.assert_array_equal(moved[:, :, 20:].numpy(),
                                      base[:, :, 20:].numpy())
        assert not torch.equal(moved[:, :, 5:20], base[:, :, 5:20])


class TestSegmentPositions:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_matches_jax(self, seed):
        rs = np.random.RandomState(seed)
        s = 100
        rows = []
        for first in (0, 9):
            cuts = np.sort(rs.choice(np.arange(1, s), 4, replace=False))
            rows.append(_ids(np.diff(np.r_[0, cuts, s - 10]), s, first))
        seg = np.stack(rows)
        np.testing.assert_array_equal(
            segment_positions(torch.from_numpy(seg)).numpy(),
            np.asarray(jax_positions(jnp.asarray(seg))))

    def test_restarts_at_each_document(self):
        seg = torch.tensor([[4, 4, 4, 7, 7, -1, -1]])
        assert segment_positions(seg).tolist() == [[0, 1, 2, 0, 1, 0, 1]]


class TestSegmentChecks:
    def test_ids_must_be_int32_of_the_right_shape(self):
        q = torch.zeros(1, 2, 8, 16)
        ids = torch.zeros(1, 8, dtype=torch.int32)
        with pytest.raises(ValueError, match="int32"):
            fa.flash_fwd(q, q, q, True, 0.25, seg_q=ids.long(), seg_k=ids)
        with pytest.raises(ValueError, match="seg_k must be"):
            fa.flash_fwd(q, q, q, True, 0.25, seg_q=ids, seg_k=ids[:, :4])
        with pytest.raises(ValueError, match="both"):
            fa.flash_bwd_dq(q, q, q, q, torch.zeros(1, 2, 8),
                            torch.zeros(1, 2, 8), True, 0.25, seg_q=ids)

    def test_entry_points_cast_the_ids_once(self):
        """int64 ids (a token batch's usual type) reach the wrappers as
        int32, and give what int32 ids give."""
        q, k, v = (_t(a) for a in _arrays(
            [(1, 2, 32, 16), (1, 1, 32, 16), (1, 1, 32, 16)], 9))
        ids = torch.from_numpy(_ids([12, 20], 32))[None]
        np.testing.assert_array_equal(
            fa.flash_attention_segmented(q, k, v, ids.long()).numpy(),
            fa.flash_attention_segmented(q, k, v, ids).numpy())

    def test_ids_on_another_device_raise(self):
        q = torch.zeros(1, 2, 8, 16)
        ids = torch.zeros(1, 8, dtype=torch.int32)
        with pytest.raises(ValueError, match="several devices"):
            fa.flash_fwd(q, q, q, True, 0.25, seg_q=ids.to("meta"),
                         seg_k=ids)

    def test_cpu_path_counts_no_launch(self):
        fa.reset_launch_counts()
        q, k, v = (_t(a, True) for a in _arrays(
            [(1, 2, 32, 16), (1, 1, 32, 16), (1, 1, 32, 16)], 10))
        ids = torch.from_numpy(_ids([12, 20], 32))[None]
        fa.flash_attention_segmented(q, k, v, ids).sum().backward()
        assert set(fa.launch_counts().values()) == {0}
