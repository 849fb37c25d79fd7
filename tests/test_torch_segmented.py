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

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.models.common import segment_positions as jax_positions
from dlrover_tpu.ops.flash_attention import (
    flash_attention_segmented as jax_segmented,
    flash_attention_segmented_pair_lse as jax_pair_lse,
    segmented_attention as jax_segmented_attention,
)
from dlrover_tpu_torch.models.common import segment_positions
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import flash_check

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


# -- the segment-id kernels' tile lists ---------------------------------------


def _numpy_ranges(ids):
    """[B, ceil(S / 64), 2]: each 64-id tile's min and max id."""
    n = -(-ids.shape[1] // 64)
    return np.stack([[(row[t * 64:(t + 1) * 64].min(),
                       row[t * 64:(t + 1) * 64].max()) for t in range(n)]
                     for row in ids]).astype(np.int32)


def _same_id_pairs(seg_q, seg_k, causal):
    """Per tile of B3 [B, 128-row q tiles, 128-key tiles] and of B2
    [B, 128-key tiles, 64-row q steps]: whether it holds a (row, key)
    pair of one id (key at or before the row when causal)."""
    same = seg_q[:, :, None] == seg_k[:, None, :]
    if causal:
        same &= np.tri(seg_q.shape[1], seg_k.shape[1], dtype=bool)

    def tiles(a, rows, cols):
        b, n, m = a.shape
        padded = np.zeros((b, -(-n // rows) * rows, -(-m // cols) * cols),
                          bool)
        padded[:, :n, :m] = a
        return padded.reshape(b, padded.shape[1] // rows, rows,
                              padded.shape[2] // cols, cols).any(axis=(2, 4))

    return tiles(same, 128, 128), tiles(same, 64, 128).transpose(0, 2, 1)


class TestSegmentTiles:
    @pytest.mark.parametrize("s_q,s_k", [(64, 64), (100, 100), (300, 300),
                                         (4096, 4096), (130, 257), (1, 65)])
    def test_table_matches_numpy(self, s_q, s_k):
        """Each 64-id tile's [min, max], q side then k side, a ragged
        last tile over its own ids only."""
        rs = np.random.RandomState(s_q + s_k)
        seg_q = rs.randint(-1, 9, (2, s_q)).astype(np.int32)
        seg_k = rs.randint(-1, 9, (2, s_k)).astype(np.int32)
        got = fa.segment_tiles(_t(seg_q), _t(seg_k))
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), np.concatenate([_numpy_ranges(seg_q),
                                         _numpy_ranges(seg_k)], axis=1))

    @staticmethod
    @st.composite
    def _layouts(draw):
        """(seg_q, seg_k, causal, sorted self form): documents of drawn
        lengths, sorted, shuffled (with an id that recurs far apart), with
        a -1 pad tail, or the pair form with independent kv-side ids."""
        kind = draw(st.sampled_from(["sorted", "shuffled", "pad_tail",
                                     "pair"]))
        s = draw(st.integers(1, 320))
        causal = draw(st.booleans())
        rs = np.random.RandomState(draw(st.integers(0, 2 ** 31 - 1)))

        def row(length):
            docs = draw(st.lists(st.integers(1, 160), min_size=1,
                                 max_size=10))
            ids = np.repeat(np.arange(len(docs)), docs)[:length]
            return np.r_[ids, np.full(length - len(ids), ids[-1])]

        seg_q = row(s)
        if kind == "shuffled":
            seg_q = rs.permutation(seg_q.max() + 1)[seg_q]
            seg_q[seg_q == seg_q[-1]] = seg_q[0]
        if kind == "pad_tail":
            seg_q[s - draw(st.integers(1, s)):] = -1
        seg_k = seg_q
        if kind == "pair":
            s_k = s if causal else draw(st.integers(1, 320))
            seg_k = row(s_k) + draw(st.integers(-3, 3))
        return (seg_q[None].astype(np.int32), seg_k[None].astype(np.int32),
                causal, kind == "sorted")

    @settings(max_examples=300, deadline=None, derandomize=True)
    @given(_layouts())
    def test_lists_keep_every_tile_with_a_same_id_pair(self, layout):
        """For any ids, every tile holding a same-id (causal) pair is
        listed, and nothing outside the causal cut is; on sorted ids
        exactly those tiles are."""
        seg_q, seg_k, causal, exact = layout
        lists = flash_check.listed_tiles(
            fa.segment_tiles(_t(seg_q), _t(seg_k)), seg_q.shape[1],
            seg_k.shape[1], causal)
        needed = dict(zip(("flash_bwd_dq", "flash_bwd_dkv"),
                          _same_id_pairs(seg_q, seg_k, causal)))
        needed["flash_fwd"] = needed["flash_bwd_dq"]  # B3's geometry
        for name, (listed, visited) in lists.items():
            listed, visited = listed.numpy(), visited.numpy()
            assert listed.shape == needed[name].shape, name
            assert not (needed[name] & ~listed).any(), name
            assert not (listed & ~visited).any(), name
            if exact:
                np.testing.assert_array_equal(listed, needed[name],
                                              err_msg=name)

    @pytest.mark.parametrize("layout,counts", [
        ("packed row", (145, 528, 290, 1056)),
        ("documents of 512", (80, 528, 160, 1056)),
        ("documents of 700", (129, 528, 241, 1056)),
        ("-1 pad tail", (171, 528, 313, 1056)),
        ("pair form", (198, 1024, 367, 2048)),
    ])
    def test_phase_13_counts(self, layout, counts):
        """The tiles B1 and B3 (one list) and B2 list against the
        causal tiles they would visit without lists, on chip_smoke.py's
        phase-13 layouts (the first packed training row: documents of
        627, 1253, 785, 617, 373 and 441 tokens)."""
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                       "chip_smoke.py"))
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        row = next(smoke.packed_segment_rows(4096, smoke.PACK_SEED))
        assert list(smoke.segment_lengths(row)) == [627, 1253, 785, 617,
                                                    373, 441]
        ar = np.arange(4096, dtype=np.int32)
        seg_q = {"packed row": row, "documents of 512": ar // 512,
                 "documents of 700": ar // 700,
                 "-1 pad tail": np.r_[row[:-333], np.full(333, -1)],
                 "pair form": ar // 700}[layout][None].astype(np.int32)
        seg_k = seg_q
        if layout == "pair form":  # every odd id missing on the kv side
            seg_k = np.where(seg_q % 2 == 1, seg_q + 1_000_000, seg_q)
        causal = layout != "pair form"
        lists = flash_check.listed_tiles(
            fa.segment_tiles(_t(seg_q), _t(seg_k)), 4096, 4096, causal)
        got = []
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            listed, visited = lists[name]
            got += [int(listed.sum()), int(visited.sum())]
        assert tuple(got) == counts[:2] + counts

    def test_wrappers_take_a_table_or_build_it(self):
        """The public wrappers build the ids' tile table themselves and
        take none; the launch helpers the autograd function calls take
        the one table it builds for the three kernels. On the CPU the
        plain versions answer either way."""
        q, k, v, dout = (_t(a) for a in _arrays(
            [(1, 2, 100, 16), (1, 1, 100, 16), (1, 1, 100, 16),
             (1, 2, 100, 16)], 11))
        ids = torch.from_numpy(_ids([30, 70], 100))[None]
        lse, delta = torch.zeros(1, 2, 100), torch.zeros(1, 2, 100)
        bwd = (q, k, v, dout, lse, delta, True, 0.25)
        table = fa.segment_tiles(ids, ids)
        assert table.shape == (1, 4, 2)
        for fn, helper, args in (
                (fa.flash_fwd, fa._launch_fwd, (q, k, v, True, 0.25)),
                (fa.flash_bwd_dkv, fa._launch_bwd_dkv, bwd),
                (fa.flash_bwd_dq, fa._launch_bwd_dq, bwd)):
            built = fn(*args, seg_q=ids, seg_k=ids)
            given_ = helper(*args, ids, ids, None, table)
            for a, b in zip(built if isinstance(built, tuple) else (built,),
                            given_ if isinstance(given_, tuple)
                            else (given_,)):
                assert torch.equal(a, b)
            with pytest.raises(TypeError, match="seg_tiles"):
                fn(*args, seg_q=ids, seg_k=ids, seg_tiles=table)

    def test_entry_points_take_the_table_after_the_ids(self):
        """Every segment-id entry point, B1's too, takes three int32
        pointers after the others: seg_q, seg_k and the tile table."""
        for name, pointers in (("flash_fwd", 5), ("flash_bwd_dkv", 8),
                               ("flash_bwd_dq", 7)):
            argtypes = fa._ARGTYPES[name + "_seg"]
            assert argtypes[:pointers + 3] == [fa._P] * (pointers + 3)
            assert argtypes[pointers + 3] is fa._I  # B, then the shape

    @pytest.mark.parametrize("causal", [True, False])
    def test_one_table_a_layer(self, monkeypatch, causal):
        """One forward and backward of the autograd function builds the
        ids' tile table once and hands that same tensor to B1, B2 and
        B3's launch helpers."""
        built, given_ = [], {}
        real_tiles = fa.segment_tiles

        def tiles(*args):
            built.append(real_tiles(*args))
            return built[-1]

        def seen(name):
            real = getattr(fa, name)

            def helper(*args):
                given_[name] = args[-1]
                return real(*args)
            return helper

        monkeypatch.setattr(fa, "segment_tiles", tiles)
        for name in ("_launch_fwd", "_launch_bwd_dkv", "_launch_bwd_dq"):
            monkeypatch.setattr(fa, name, seen(name))
        q, k, v = (_t(a, True) for a in _arrays(
            [(1, 2, 160, 16), (1, 1, 160, 16), (1, 1, 160, 16)], 12))
        ids = torch.from_numpy(_ids([50, 110], 160))[None]
        fa.flash_attention_segmented(q, k, v, ids,
                                     causal=causal).sum().backward()
        assert len(built) == 1
        assert set(given_) == {"_launch_fwd", "_launch_bwd_dkv",
                               "_launch_bwd_dq"}
        assert all(t is built[0] for t in given_.values())
