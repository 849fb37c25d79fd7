"""The f32 grouped kernels' live rows (B4's f32 path, B5's and B6)
against the reference, on the CPU.

The expert-parallel regroup (``ops/moe.py``'s ``regroup_layout``) pads
the received rows to a static bound; every row from the padded end of
the last local expert's group on reads the zero sentinel.
``RegroupLayout.live_rows`` says where that is, and the f32 kernels skip
the row tiles past it. Here: ``live_rows`` against the reference's own
row map, the plain versions with ``live_rows`` against the Pallas
kernels in interpret mode (B5's ``dw`` summing the rows below it only),
autograd through both grouped products against ``jax.grad``, the
wrappers' checks of it, and a plain
emulation of the 3xTF32 split that ``chip_stages.py tf32`` measured on
the card and ruled out (its tensor-core accumulation is biased).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import grouped_matmul as jax_gm
from dlrover_tpu.ops import moe as jax_moe
from dlrover_tpu.ops import quantize as jax_quantize
from dlrover_tpu_torch.ops import grouped_matmul as gm
from dlrover_tpu_torch.ops import moe, quantize

F32_TOL = 1e-5  # f32 products of a few dozen terms, two summation orders


@pytest.fixture(autouse=True)
def _torch_settings():
    """f32 results are compared: no TF32; one CPU thread (tiny shapes)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.set_num_threads(saved[1])


def _padded_end(recv, lo, nc, block_t):
    """The padded end of the last local expert's group, by hand: each
    local expert's rows inside the window [lo, lo + nc) of every source
    block, rounded up to whole tiles, one sentinel tile at least."""
    csum = np.cumsum(recv, axis=1)
    start = csum - recv
    cnt = np.clip(np.minimum(csum, lo + nc) - np.maximum(start, lo), 0, nc)
    m = cnt.sum(axis=0)
    return int((np.maximum(-(-m // block_t), 1) * block_t).sum())


def _reference_row_src(monkeypatch, recv, lo, nc, ep, el, block_t, d=4):
    """The reference's own row map: ``dlrover_tpu.ops.moe._regroup_window``
    run on rows that carry their index + 1 (the sentinel row is zeros),
    its grouped matmul replaced by a spy that records the rows it is
    handed (``x_pad[row_src]``) and its tile_expert."""
    seen = {}

    def spy(x, w, tile_expert, *args, **kwargs):
        seen.setdefault("x", np.asarray(x))
        seen.setdefault("tile_expert", np.asarray(tile_expert))
        return jnp.zeros((x.shape[0], w.shape[-1]), x.dtype)

    monkeypatch.setattr(jax_gm, "grouped_matmul", spy)
    idx = np.arange(ep * nc, dtype=np.float32).reshape(ep, nc) + 1.0
    x_chunk = np.zeros((ep, nc, d), np.float32)
    x_chunk[..., 0] = idx
    w = np.zeros((el, d, d), np.float32)
    jax_moe._regroup_window(
        jnp.asarray(recv, jnp.int32), lo, nc, jnp.asarray(w), jnp.asarray(w),
        x_chunk=jnp.asarray(x_chunk), ep=ep, el=el, block_t=block_t,
        interpret=True, activation=lambda h: h, out_dtype=jnp.float32)
    row_src = seen["x"][:, 0].astype(np.int64) - 1
    row_src[row_src < 0] = ep * nc  # the sentinel
    return row_src, seen["tile_expert"]


# (label, recv [P, el], lo, nc, block_t): rows of each (source, local
# expert) pair, the window of received block rows
LAYOUTS = [
    ("skewed", [[7, 0], [5, 1], [9, 0], [3, 0]], 0, 10, 4),
    ("local expert with no rows", [[0, 6], [0, 3], [0, 5], [0, 2]], 0, 6,
     4),
    ("three experts, a window", [[2, 3, 1], [0, 4, 4], [5, 0, 2]], 3, 4, 2),
    ("full: every slot, whole tiles", [[4, 4]] * 4, 0, 8, 4),
]


@pytest.mark.parametrize("label,recv,lo,nc,block_t", LAYOUTS,
                         ids=[c[0] for c in LAYOUTS])
def test_live_rows_is_the_padded_end_of_the_reference_layout(
        monkeypatch, label, recv, lo, nc, block_t):
    """``live_rows`` is the padded end of the last local expert's group,
    as counted by hand; the port's row map and tile_expert equal the
    reference's; every row at or past ``live_rows`` reads the sentinel
    in the reference's map, and none before it in the full layout. The
    static bound keeps ``el * block_t`` rows of slack whenever any row
    arrives, so even the full layout ends there."""
    recv = np.asarray(recv, np.int32)
    ep, el = recv.shape
    lay = moe.regroup_layout(torch.from_numpy(recv), lo, nc, ep, el,
                             block_t)
    ref_src, ref_te = _reference_row_src(monkeypatch, recv, lo, nc, ep, el,
                                         block_t)
    live = _padded_end(recv, lo, nc, block_t)
    assert lay.live_rows.dtype == torch.int32
    assert tuple(lay.live_rows.shape) == (1,)
    assert lay.live_rows.item() == live
    np.testing.assert_array_equal(lay.row_src.numpy(), ref_src)
    np.testing.assert_array_equal(lay.tile_expert.numpy(), ref_te)
    sentinel = ep * nc
    assert (ref_src[live:] == sentinel).all()
    if label.startswith("full"):
        assert live == lay.rows - el * block_t
        assert (ref_src[:live] != sentinel).all()
    else:
        assert live < lay.rows


def test_no_row_fills_the_bound():
    """With no row in the window every local expert owns one sentinel
    tile and the bound is exactly those: ``live_rows == rows``."""
    recv = torch.zeros((4, 2), dtype=torch.int32)
    lay = moe.regroup_layout(recv, 0, 0, 4, 2, 8)
    assert lay.rows == 16 and lay.live_rows.item() == 16


def _ep_case(recv, nc, block_t, d, f, seed):
    """Rows as rank 0's regroup lays them out (pad rows read the zero
    sentinel), their fp8 wire form, f32 weights [el, d, f] and the
    layout."""
    recv = np.asarray(recv, np.int32)
    ep, el = recv.shape
    rs = np.random.RandomState(seed)
    lay = moe.regroup_layout(torch.from_numpy(recv), 0, nc, ep, el, block_t)
    rows = rs.randn(ep * nc, d).astype(np.float32) * 2.0
    x_pad = np.concatenate([rows, np.zeros((1, d), np.float32)])
    x = x_pad[lay.row_src.numpy()]
    w = (rs.randn(el, d, f) / np.sqrt(d)).astype(np.float32)
    return x, w, lay


@pytest.mark.parametrize("recv,nc,block_t,d,f", [
    ([[7, 0], [5, 1], [9, 0], [3, 0]], 10, 8, 32, 48),
    ([[0, 6], [0, 3], [0, 5], [0, 2]], 6, 8, 64, 32),
], ids=["skewed", "empty_local_expert"])
def test_plain_f32_with_live_rows_matches_the_pallas_kernels(
        recv, nc, block_t, d, f):
    """B4's f32 plain version (y, and dx through w^T) and B6's with
    ``live_rows`` against the reference's grouped_matmul and
    grouped_matmul_quantized in interpret mode over all rows (whose
    pad rows compute zeros from zero inputs), f32, within F32_TOL; rows
    at or past ``live_rows`` exactly zero. B6's plain version is bit
    for bit B4's on the dequantized rows."""
    x, w, lay = _ep_case(recv, nc, block_t, d, f, 0)
    te, live = lay.tile_expert, lay.live_rows
    cot = np.random.RandomState(1).randn(x.shape[0], f).astype(np.float32)
    cot[live.item():] = 0.0  # the layout's contract for dy: no gradient
    jte = jnp.asarray(te.numpy())
    want_y = np.asarray(jax_gm.grouped_matmul(jnp.asarray(x), jnp.asarray(w),
                                              jte, block_t, 16, True))
    want_dx = np.asarray(jax_gm.grouped_matmul(
        jnp.asarray(cot), jnp.swapaxes(jnp.asarray(w), 1, 2), jte, block_t,
        16, True))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y = gm.grouped_matmul_fwd_plain(xt, wt, te, block_t, live_rows=live)
    dx = gm.grouped_matmul_fwd_plain(torch.from_numpy(cot), wt, te, block_t,
                                     transpose_w=True, live_rows=live)
    for got, want in ((y, want_y), (dx, want_dx)):
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)
        assert got[live.item():].abs().max().item() == 0.0

    jv, js = jax_quantize.quantize_block_scaled(jnp.asarray(x))
    want_q = np.asarray(jax_gm.grouped_matmul_quantized(
        jv, js, jnp.asarray(w), jte, block_t, 16, True))
    v, s = quantize.quantize_block_scaled(xt)
    yq = gm.grouped_matmul_fwd_quant_plain(v, s, wt, te, block_t,
                                           live_rows=live)
    np.testing.assert_allclose(yq.numpy(), want_q, atol=F32_TOL)
    assert yq[live.item():].abs().max().item() == 0.0
    b4 = gm.grouped_matmul_fwd_plain(quantize.dequantize_block_scaled(v, s),
                                     wt, te, block_t, live_rows=live)
    assert torch.equal(yq, b4)


def test_live_rows_through_autograd_and_the_wrappers():
    """``grouped_matmul`` with ``live_rows`` (the CPU path of the
    wrappers): y and dx zero past it and equal to the run without it on
    the rows before (which a zero pad row leaves unchanged); dw the
    same either way; ``grouped_matmul_quantized`` equal to
    ``grouped_matmul`` on the dequantized rows."""
    x, w, lay = _ep_case([[7, 0], [5, 1], [9, 0], [3, 0]], 10, 8, 32, 48, 2)
    te, live = lay.tile_expert, lay.live_rows
    n = live.item()
    grads = []
    for lr in (live, None):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        y = gm.grouped_matmul(xt, wt, te, 8, live_rows=lr)
        cot = torch.ones_like(y)
        cot[n:] = 0.0
        (y * cot).sum().backward()
        grads.append((y.detach(), xt.grad, wt.grad))
    (y1, dx1, dw1), (y0, dx0, dw0) = grads
    assert y1[n:].abs().max().item() == 0.0
    assert dx1[n:].abs().max().item() == 0.0
    assert torch.equal(y1[:n], y0[:n]) and torch.equal(dx1[:n], dx0[:n])
    assert torch.equal(dw1, dw0)
    v, s = quantize.quantize_block_scaled(torch.from_numpy(x))
    yq = gm.grouped_matmul_quantized(v, s, torch.from_numpy(w), te, 8,
                                     live_rows=live)
    yd = gm.grouped_matmul(quantize.dequantize_block_scaled(v, s),
                           torch.from_numpy(w), te, 8, live_rows=live)
    assert torch.equal(yq, yd)


def _dw_case(recv, lo, nc, block_t, d, f, seed):
    """x as rank 0's regroup lays out its received rows (zero sentinel
    rows past ``live_rows``), a gradient dy random on the live rows and
    zero past them, as the layout leaves it, and the layout."""
    recv = np.asarray(recv, np.int32)
    ep, el = recv.shape
    rs = np.random.RandomState(seed)
    lay = moe.regroup_layout(torch.from_numpy(recv), lo, nc, ep, el, block_t)
    rows = rs.randn(ep * nc, d).astype(np.float32)
    x = np.concatenate([rows, np.zeros((1, d), np.float32)])[
        lay.row_src.numpy()]
    dy = rs.randn(lay.rows, f).astype(np.float32)
    dy[lay.live_rows.item():] = 0.0
    return x, dy, lay


@pytest.mark.parametrize("label,recv,lo,nc,block_t", LAYOUTS,
                         ids=[c[0] for c in LAYOUTS])
def test_plain_dw_with_live_rows_matches_the_pallas_kernel(
        label, recv, lo, nc, block_t):
    """B5's plain version with ``live_rows`` against the reference's dw
    kernel (``_grouped_matmul_dw``) in interpret mode over every row, on
    the reference's own regroup layouts, f32, within F32_TOL; and the
    rows past ``live_rows`` are not summed at all: garbage put there
    leaves the result bit for bit the same."""
    d, f = 32, 48
    x, dy, lay = _dw_case(recv, lo, nc, block_t, d, f, 5)
    te, live = lay.tile_expert, lay.live_rows
    el = int(np.asarray(recv).shape[1])
    want = np.asarray(jax_gm._grouped_matmul_dw(
        jnp.asarray(x), jnp.asarray(dy), jnp.asarray(te.numpy()), el,
        block_t, 16, True))
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    got = gm.grouped_matmul_dw(xt, dyt, te, el, block_t, live_rows=live)
    assert got.shape == (el, d, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)
    n = live.item()
    rs = np.random.RandomState(6)
    xg, dyg = xt.clone(), dyt.clone()
    xg[n:] = torch.from_numpy(rs.randn(lay.rows - n, d).astype(np.float32))
    dyg[n:] = torch.from_numpy(rs.randn(lay.rows - n, f).astype(np.float32))
    assert torch.equal(gm.grouped_matmul_dw_plain(xg, dyg, te, el, block_t,
                                                  live_rows=live), got)
    if n < lay.rows:  # without it, the garbage is summed
        assert not torch.equal(
            gm.grouped_matmul_dw_plain(xg, dyg, te, el, block_t), got)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["grouped_matmul", "grouped_matmul_quantized"])
def test_autograd_dw_with_live_rows_matches_jax_grad(quantized):
    """dW through ``grouped_matmul`` (B4 forward, B5 backward) and through
    ``grouped_matmul_quantized`` (B6 forward, B5 on the dequantized rows)
    with ``live_rows``: within F32_TOL of the reference's ``jax.grad`` of
    the same loss over every row (the layout's rows past it are zero),
    and within F32_TOL of the port's run without ``live_rows``."""
    block_t, f = 8, 48
    x, w, lay = _ep_case([[7, 0], [5, 1], [9, 0], [3, 0]], 10, block_t, 32,
                         f, 7)
    te, live = lay.tile_expert, lay.live_rows
    n = live.item()
    cot = np.random.RandomState(8).randn(x.shape[0], f).astype(np.float32)
    cot[n:] = 0.0  # the layout's contract: no gradient past it
    jte = jnp.asarray(te.numpy())
    if quantized:
        jv, js = jax_quantize.quantize_block_scaled(jnp.asarray(x))

        def loss(jw):
            return (jax_gm.grouped_matmul_quantized(
                jv, js, jw, jte, block_t, 16, True) * cot).sum()
    else:
        def loss(jw):
            return (jax_gm.grouped_matmul(jnp.asarray(x), jw, jte, block_t,
                                          16, True) * cot).sum()
    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    grads = []
    for lr in (live, None):
        wt = torch.from_numpy(w).requires_grad_()
        if quantized:
            v, s = quantize.quantize_block_scaled(torch.from_numpy(x))
            y = gm.grouped_matmul_quantized(v, s, wt, te, block_t,
                                            live_rows=lr)
        else:
            y = gm.grouped_matmul(torch.from_numpy(x), wt, te, block_t,
                                  live_rows=lr)
        (y * torch.from_numpy(cot)).sum().backward()
        grads.append(wt.grad)
    np.testing.assert_allclose(grads[0].numpy(), want, atol=F32_TOL)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               atol=F32_TOL)


@pytest.mark.parametrize("bad,err,match", [
    (torch.tensor([16], dtype=torch.int64), TypeError, "int32"),
    (torch.tensor([16.0]), TypeError, "int32"),
    (torch.tensor([16, 8], dtype=torch.int32), ValueError, r"shape \(1,\)"),
    (torch.tensor(16, dtype=torch.int32), ValueError, r"shape \(1,\)"),
    (torch.empty(1, dtype=torch.int32, device="meta"), ValueError,
     "live_rows on meta"),
    (16, TypeError, "tensor or None"),
], ids=["int64", "float", "two_entries", "scalar", "other_device", "int"])
def test_wrappers_refuse_a_bad_live_rows(bad, err, match):
    """The three wrappers that take it (B4, B6 and B5's dw) check
    ``live_rows`` before anything runs: int32, shape [1], on x's device
    (the kernels read one int through a raw pointer)."""
    x, w, lay = _ep_case([[7, 0], [5, 1], [9, 0], [3, 0]], 10, 8, 32, 48, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(err, match=match):
        gm.grouped_matmul_fwd(xt, wt, lay.tile_expert, 8, live_rows=bad)
    v, s = quantize.quantize_block_scaled(xt)
    with pytest.raises(err, match=match):
        gm.grouped_matmul_fwd_quant(v, s, wt, lay.tile_expert, 8,
                                    live_rows=bad)
    dy = torch.zeros((xt.shape[0], 48))
    with pytest.raises(err, match=match):
        gm.grouped_matmul_dw(xt, dy, lay.tile_expert, 2, 8, live_rows=bad)


# -- the 3xTF32 split, emulated -------------------------------------------


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32 (10 explicit mantissa bits) to nearest, ties
    away from zero, on the bit patterns: PTX's cvt.rna.tf32.f32 on
    finite inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def test_tf32_split_is_exact_to_two_to_the_minus_22():
    """big has its low 13 bits clear and so does small; big + small
    gives x back within 2^-22 |x|; a tie rounds away from zero."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(np.concatenate([
        rs.randn(4096), rs.randn(1024) * 1e-30, rs.randn(1024) * 1e30,
    ]).astype(np.float32))
    big, small = _split(x)
    for part in (big, small):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    err = (big.double() + small.double() - x.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert _tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]


def test_emulated_3xtf32_product_matches_the_reference_kernel():
    """big*big + big*small + small*big, each product of tf32 values
    exact in f32 and the sums in f32, against the reference's grouped
    matmul in interpret mode on one layout: within F32_TOL, as B4's f32
    path is. (The card's tensor cores truncate those sums; the kernels
    stay on the CUDA cores: PERF.md.)"""
    x, w, lay = _ep_case([[7, 0], [5, 1], [9, 0], [3, 0]], 10, 8, 32, 48, 4)
    te, bt = lay.tile_expert, 8
    want = np.asarray(jax_gm.grouped_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(te.numpy()), bt, 16,
        True))
    xb, xs = _split(torch.from_numpy(x))
    row_e = te.long().repeat_interleave(bt)
    got = torch.zeros(x.shape[0], w.shape[2])
    for e in range(w.shape[0]):
        wb, ws = _split(torch.from_numpy(w[e]))
        sel = row_e == e
        got[sel] = xb[sel] @ ws + xs[sel] @ wb + xb[sel] @ wb
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)
