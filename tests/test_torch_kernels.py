"""The flash-attention and grouped-matmul kernels (B1-B6) against their
plain versions.

This file imports no JAX, so it also runs on a machine with a GPU and
no JAX installed (``tests/conftest.py`` imports JAX; skip it there):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tests marked ``cuda`` build the kernels with ``nvcc`` and skip without a
card. The others check, on the CPU, what surrounds the kernels.
"""

import math
import os

import pytest
import torch

from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import flash_check, kernel_build
from dlrover_tpu_torch.ops import grouped_check
from dlrover_tpu_torch.ops import grouped_matmul as gm
from dlrover_tpu_torch.ops import quantize
from dlrover_tpu_torch.ops.attention_ref import mha_reference



@pytest.fixture(autouse=True)
def _one_cpu_thread():
    """These shapes are tiny, and the suite's other workers run
    timing-sensitive tests beside them."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)

def test_plain_versions_match_autograd_through_the_reference():
    """The plain backward (dkv, dq with a dlse cotangent) against torch
    autograd through ``mha_reference`` plus a logsumexp, on the CPU.
    Both compute in f32 (the plain versions always do, as the kernels
    accumulate), so the tolerance is a summation-order one: 1e-5."""
    gen = torch.Generator().manual_seed(0)
    b, h, hkv, s, d = 1, 4, 2, 24, 16
    q, k, v = (torch.randn(shape, generator=gen, requires_grad=True)
               for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    dout = torch.randn(b, h, s, d, generator=gen)
    dlse = torch.randn(b, h, s, generator=gen)
    scale = 1 / math.sqrt(d)
    for causal in (True, False):
        out = mha_reference(q, k, v, causal=causal)
        logits = fa._scores(q, k, causal, scale)
        lse_ref = torch.logsumexp(logits, dim=-1)
        ref = torch.autograd.grad((out, lse_ref), (q, k, v), (dout, dlse))
        out_p, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
        delta = (dout * out_p).sum(-1) - dlse
        dk, dv = fa.flash_bwd_dkv_plain(q, k, v, dout, lse, delta, causal,
                                        scale)
        dq = fa.flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal,
                                   scale)
        for got, want in zip((dq, dk, dv), ref):
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def _bf16_case(seed=0, b=1, h=4, hkv=2, s=256, d=64):
    gen = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen).to(torch.bfloat16)
                   for shape in ((b, h, s, d), (b, hkv, s, d),
                                 (b, hkv, s, d), (b, h, s, d)))
    return q, k, v, do, d ** -0.5


def test_row_rule_passes_rounding_level_differences():
    """``mha_reference`` normalises P before rounding it to bf16, the
    plain forward after: a bf16 rounding apart, as kernel and plain
    version are. The row rule (1% of each row's norm) lets that pass."""
    q, k, v, _, scale = _bf16_case()
    out, _ = fa.flash_fwd_plain(q, k, v, True, scale)
    ref = mha_reference(q, k, v, causal=True, scale=scale)
    errs = flash_check.row_errors(out, ref)
    assert flash_check.rows_close(out, ref), errs
    assert errs["worst_row"] < 0.5, errs


def test_row_rule_rejects_planted_faults():
    """Each planted kernel fault (a skipped k tile, a causal mask one
    key too wide in the forward and in dQ, a skipped rescale, a q tile
    or a GQA head left out of the backward's sums) fails the rule that
    the kernels pass."""
    q, k, v, do, scale = _bf16_case(seed=1)
    out, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    dk, dv = fa.flash_bwd_dkv_plain(*args)
    right = {"out": out, "dk": dk, "dv": dv,
             "dq": fa.flash_bwd_dq_plain(*args)}
    faults = flash_check.planted_faults(q, k, v, do, lse, delta, scale)
    assert len(faults) == 9
    assert ("dq", "causal mask one key too wide") in [
        (name, fault) for name, fault, _ in faults]
    for name, fault, got in faults:
        assert got.shape == right[name].shape, fault
        assert not flash_check.rows_close(got, right[name]), (
            name, fault, flash_check.row_errors(got, right[name]))


def test_bias_rule_passes_rounding_and_rejects_truncation():
    """The whole-tensor bias rule (the signed error projected on the
    reference within 5e-4) passes what rounding to nearest leaves: the
    reference's forward against the plain one, and dK/dV and dQ from
    f32 P and dS against the plain versions, which round them to bf16.
    It rejects the controls that truncate P, P^T, dS^T or dS to bf16
    instead (about -0.1 % to -0.3 %), which the row rule lets through."""
    q, k, v, do, scale = _bf16_case(seed=1)
    out, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    dk, dv = fa.flash_bwd_dkv_plain(*args)
    right = {"out": out, "dk": dk, "dv": dv,
             "dq": fa.flash_bwd_dq_plain(*args)}
    p, ds = fa._probs_and_ds(*args)
    b, hkv, s, d = k.shape
    h = q.shape[1]

    def group_sum(t):
        return t.view(b, hkv, -1, s, d).sum(dim=2).to(k.dtype)

    sound = {
        "out": mha_reference(q, k, v, causal=True, scale=scale),
        "dv": group_sum(torch.einsum("bhqk,bhqd->bhkd", p, do.float())),
        "dk": group_sum(torch.einsum("bhqk,bhqd->bhkd", ds, q.float())),
        "dq": torch.einsum("bhqk,bhkd->bhqd", ds, k.repeat_interleave(
            h // hkv, dim=1).float()).to(q.dtype),
    }
    for name, got in sound.items():
        assert flash_check.bias_close(got, right[name]), (
            name, flash_check.bias(got, right[name]))
        assert flash_check.rows_close(got, right[name]), name
    controls = flash_check.bias_controls(*args)
    assert [name for name, _, _ in controls] == ["out", "dv", "dk", "dq"]
    for name, fault, got in controls:
        assert got.shape == right[name].shape, fault
        assert not flash_check.bias_close(got, right[name]), (
            fault, flash_check.bias(got, right[name]))


@pytest.mark.parametrize("s", [40, 129])
def test_dq_checks_hold_at_short_sequences(s):
    """At the short sequences B3 is checked at on the card (a q tile
    shorter than one warpgroup's 64 rows, one row past a tile), dQ from
    f32 dS passes both rules against the plain version, which rounds dS
    to bf16; dS truncated to bf16 fails the bias rule, and a causal
    mask one key too wide fails the row rule."""
    q, k, v, do, scale = _bf16_case(seed=2, s=s)
    out, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    right = fa.flash_bwd_dq_plain(*args)
    _, ds = fa._probs_and_ds(*args)
    group = q.shape[1] // k.shape[1]
    sound = torch.einsum("bhqk,bhkd->bhqd", ds, k.repeat_interleave(
        group, dim=1).float()).to(q.dtype)
    assert flash_check.rows_close(sound, right)
    assert flash_check.bias_close(sound, right), flash_check.bias(sound,
                                                                  right)
    control = {fault: got for name, fault, got in
               flash_check.bias_controls(*args) if name == "dq"}
    got = control["dS truncated to bf16"]
    assert not flash_check.bias_close(got, right), flash_check.bias(got,
                                                                    right)
    faults = {fault: got for name, fault, got in
              flash_check.planted_faults(q, k, v, do, lse, delta, scale)
              if name == "dq"}
    got = faults["causal mask one key too wide"]
    assert not flash_check.rows_close(got, right)


def test_truncate_bf16_rounds_toward_zero():
    x = torch.tensor([1.0 + 2 ** -8 + 2 ** -9, -(1.0 + 2 ** -8 + 2 ** -9),
                      3.0, 0.0])
    t = flash_check.truncate_bf16(x)
    assert t.dtype == torch.float32
    assert t.tolist() == [1.0, -1.0, 3.0, 0.0]
    assert x.to(torch.bfloat16).float().tolist()[:2] == [1.0078125,
                                                         -1.0078125]


def test_missing_compiler_raises(monkeypatch):
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("the toolkit is installed at its default place")
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_build.nvcc_path()


def test_library_name_tracks_sources_and_flags(monkeypatch):
    """A changed kernel or flag set gets a new library file: a stale
    build is never loaded."""
    first = kernel_build.library_path("flash_fwd")
    assert first == kernel_build.library_path("flash_fwd")
    assert first.parent == kernel_build.BUILD_DIR
    monkeypatch.setattr(kernel_build, "NVCC_FLAGS",
                        kernel_build.NVCC_FLAGS + ("-DX",))
    assert kernel_build.library_path("flash_fwd") != first
    assert kernel_build.library_path("flash_bwd_dq") != first


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain runs on the card)")
    # f32 results are compared: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,hkv,s,d,causal,tol,sk", [
    (torch.bfloat16, 1, 8, 2, 512, 128, True, 1e-3, None),
    (torch.bfloat16, 1, 4, 1, 1000, 128, True, 1e-3, None),
    (torch.float32, 2, 4, 2, 1000, 64, True, 1e-4, None),
    (torch.float32, 2, 4, 2, 1000, 64, False, 1e-4, None),
    # the edges of B1's bf16 tiles
    (torch.bfloat16, 1, 4, 2, 1000, 64, False, 1e-3, None),
    (torch.bfloat16, 1, 4, 2, 1000, 80, True, 1e-3, None),
    (torch.bfloat16, 2, 8, 2, 1000, 128, True, 1e-3, None),
    (torch.bfloat16, 1, 4, 2, 300, 128, False, 1e-3, 1000),
    (torch.bfloat16, 1, 4, 2, 129, 128, True, 1e-3, None),
    # head dims below the 64-wide tile, zero-filled past D
    (torch.bfloat16, 1, 4, 2, 1000, 16, True, 1e-3, None),
    (torch.bfloat16, 1, 4, 2, 1000, 32, False, 1e-3, None),
    (torch.bfloat16, 2, 4, 2, 300, 48, True, 1e-3, None),
    # B2's edges: group 1 (the MoE cell's heads), group 8, and batch 2
    # on the 64-wide head tile without the causal mask
    (torch.bfloat16, 1, 4, 4, 1000, 128, True, 1e-3, None),
    (torch.bfloat16, 1, 8, 1, 1000, 128, True, 1e-3, None),
    (torch.bfloat16, 2, 4, 2, 1000, 64, False, 1e-3, None),
    # an expert-parallel rank's attention in the MoE cell (32/32 heads)
    (torch.bfloat16, 1, 32, 32, 1024, 128, True, 1e-3, None),
    # B3's edge: a q tile shorter than one warpgroup's 64 rows, so the
    # second warpgroup has none
    (torch.bfloat16, 1, 4, 2, 40, 128, True, 1e-3, None),
    # the 64-wide head tile's own kernels: without the causal mask on a
    # row that ends inside a 64-row step, cross attention, and a q tile
    # shorter than one warpgroup's rows
    (torch.bfloat16, 2, 4, 2, 900, 64, False, 1e-3, None),
    (torch.bfloat16, 1, 4, 2, 300, 64, False, 1e-3, 1000),
    (torch.bfloat16, 1, 4, 2, 40, 64, True, 1e-3, None),
], ids=["bf16", "bf16_ragged", "f32_ragged_causal", "f32_ragged",
        "bf16_d64", "bf16_d80_padded", "bf16_batch2_ragged_q",
        "bf16_cross", "bf16_one_past_tile", "bf16_d16", "bf16_d32",
        "bf16_d48", "bf16_group1", "bf16_group8", "bf16_batch2_d64",
        "bf16_moe_heads", "bf16_short_q_tile", "bf16_d64_noncausal_900",
        "bf16_d64_cross", "bf16_d64_short_q_tile"])
def test_kernels_match_plain_on_card(cuda_device, dtype, b, h, hkv, s, d,
                                     causal, tol, sk):
    """Each kernel against its plain version on the same card inputs:
    f32 to 1e-4 absolute; bf16 outputs row by row (``flash_check``:
    each row's error within 1% of its norm, plus 0.1% of the tensor's
    RMS row norm) and by their bias (the signed error projected on the
    plain output within 5e-4); lse, always f32, to 1e-3 absolute.
    ``sk``: the key length of a cross-attention case (default ``s``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    sk = s if sk is None else sk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = rnd(b, h, s, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), \
        rnd(b, h, s, d)
    scale = d ** -0.5
    fa.reset_launch_counts()
    out_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale)
    delta = (do.float() * out_ref.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    pairs = [
        (fa.flash_fwd(q, k, v, causal, scale), (out_ref, lse_ref)),
        (fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*args)),
        ((fa.flash_bwd_dq(*args),), (fa.flash_bwd_dq_plain(*args),)),
    ]
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dkv": 1,
                                  "flash_bwd_dq": 1, "flash_fwd_seg": 0,
                                  "flash_bwd_dkv_seg": 0,
                                  "flash_bwd_dq_seg": 0,
                                  "flash_fwd_pfx": 0, "flash_bwd_dkv_pfx": 0,
                                  "flash_bwd_dq_pfx": 0}
    for got, ref in pairs:
        for g, r in zip(got, ref):
            if g.dtype == torch.bfloat16:
                assert flash_check.rows_close(g, r), \
                    flash_check.row_errors(g, r)
                assert flash_check.bias_close(g, r), flash_check.bias(g, r)
            else:
                assert (g.float() - r.float()).abs().max().item() <= tol


def _doc_ids(b, s, doc, pad=0, device="cpu"):
    """[b, s] int32 segment ids: documents of ``doc`` tokens (row r's
    ids start at 10 r), the last ``pad`` tokens -1 (after higher ids)."""
    ids = torch.arange(s, device=device)[None] // doc + 10 * torch.arange(
        b, device=device)[:, None]
    if pad:
        ids[:, s - pad:] = -1
    return ids.int().contiguous()


def test_segment_faults_fail_the_row_rule():
    """On the CPU, bf16 and causal, documents of 70 tokens and a pad
    tail: the reference attention with the segment bias passes the row
    rule against the plain segmented forward; a segment mask shifted by
    one key, or ids ignored, fail it in every output."""
    q, k, v, do, scale = _bf16_case(seed=3)
    seg = _doc_ids(1, q.shape[2], 70, pad=30)
    out, lse = fa.flash_fwd_plain(q, k, v, True, scale, seg, seg)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale, seg, seg)
    dk, dv = fa.flash_bwd_dkv_plain(*args)
    right = {"out": out, "dk": dk, "dv": dv,
             "dq": fa.flash_bwd_dq_plain(*args)}
    same = seg[:, None, :, None] == seg[:, None, None, :]
    sound = mha_reference(q, k, v, causal=True, scale=scale,
                          bias=torch.where(same, 0.0, fa.NEG_INF))
    assert flash_check.rows_close(sound, out), flash_check.row_errors(
        sound, out)
    faults = flash_check.segment_faults(q, k, v, do, lse, delta, scale, seg,
                                        seg)
    assert len(faults) == 8
    for name, fault, got in faults:
        assert got.shape == right[name].shape, fault
        assert not flash_check.rows_close(got, right[name]), (
            name, fault, flash_check.row_errors(got, right[name]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,hkv,s,d,causal,doc,pad,sk,ids", [
    # documents on tile edges (512) and inside tiles (700), a pad tail
    (torch.bfloat16, 1, 8, 2, 2048, 128, True, 512, 0, None, "docs"),
    (torch.bfloat16, 1, 8, 2, 2048, 128, True, 700, 100, None, "docs"),
    (torch.bfloat16, 2, 4, 2, 1000, 64, True, 130, 77, None, "docs"),
    (torch.bfloat16, 1, 4, 1, 1000, 128, False, 300, 0, None, "docs"),
    (torch.bfloat16, 2, 4, 4, 300, 48, True, 37, 20, None, "docs"),
    (torch.float32, 2, 4, 2, 300, 64, True, 70, 25, None, "docs"),
    (torch.float32, 1, 4, 2, 300, 64, False, 90, 0, None, "docs"),
    # the pair form: kv-side ids lacking some q-side ids
    (torch.bfloat16, 1, 4, 2, 300, 128, False, 60, 0, 1000, "docs"),
    (torch.float32, 1, 4, 2, 300, 64, False, 60, 0, 1000, "docs"),
    # documents in shuffled order, the last one taking the first's id
    (torch.bfloat16, 1, 8, 2, 2000, 128, True, 230, 0, None, "shuffled"),
    (torch.bfloat16, 2, 4, 2, 1000, 64, False, 90, 40, None, "shuffled"),
    # blocks whose tile lists are empty: the second half of the keys
    # carries ids no row has (their dK, dV and those rows' dQ are 0)
    (torch.bfloat16, 1, 4, 2, 1000, 128, False, 100, 0, 1000, "empty"),
    (torch.bfloat16, 2, 4, 2, 1000, 64, True, 150, 0, 1000, "empty"),
], ids=["bf16_docs_512", "bf16_docs_700_pad", "bf16_batch2_d64_pad",
        "bf16_non_causal", "bf16_group1_d48", "f32_ragged_causal",
        "f32_non_causal", "bf16_pair_rows_without_keys",
        "f32_pair_rows_without_keys", "bf16_shuffled_causal",
        "bf16_shuffled_non_causal_pad", "bf16_empty_lists_non_causal",
        "bf16_empty_lists_causal"])
def test_segmented_kernels_match_plain_on_card(cuda_device, dtype, b, h,
                                               hkv, s, d, causal, doc, pad,
                                               sk, ids):
    """Each kernel in segment-id mode against its plain version on the
    same card inputs, held as ``test_kernels_match_plain_on_card`` holds
    the unsegmented ones (bf16 by the row and the bias rule, f32 to 1e-4,
    lse to 1e-3). ``sk``: the key length of a pair case, whose kv-side
    ids are the q side's documents of ``doc`` tokens with every other id
    dropped, so that some rows see no key: those read out 0 and lse
    NEG_INF (``ids == "empty"``: the second half of the keys' ids
    negated instead, so that whole blocks of B2 and B3 list no tile and
    must store exact zeros). ``ids == "shuffled"``: the documents' ids
    permuted, the last document's id the first's."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    pair = sk is not None
    sk = s if sk is None else sk

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = rnd(b, h, s, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), \
        rnd(b, h, s, d)
    seg_q = _doc_ids(b, s, doc, pad, cuda_device)
    if ids == "shuffled":
        perm = torch.randperm(int(seg_q.max()) + 1,
                              generator=torch.Generator().manual_seed(2))
        perm[-1] = perm[0]
        seg_q = torch.where(seg_q >= 0, perm.to(cuda_device)[seg_q.long()],
                            seg_q).int().contiguous()
    seg_k = seg_q if not pair else _doc_ids(b, sk, doc, 0, cuda_device)
    if ids == "empty":
        second = torch.arange(sk, device=cuda_device) >= sk // 2
        seg_k = torch.where(second, -1 - seg_k, seg_k).int()
    elif pair:  # drop the odd ids from the kv side
        seg_k = torch.where(seg_k % 2 == 1, seg_k + 1000, seg_k).int()
    if ids == "empty":  # the layout does what it says
        lists = flash_check.listed_tiles(fa.segment_tiles(seg_q, seg_k), s,
                                         sk, causal)
        for listed, _ in lists.values():
            assert bool((listed.sum(dim=-1) == 0).any())
        # the rows of B1's blocks that list no tile, [B, S]
        no_tile = (lists["flash_fwd"][0].sum(dim=-1) == 0)
        no_tile = no_tile.repeat_interleave(128, dim=1)[:, :s].to(
            cuda_device)
    scale = d ** -0.5
    fa.reset_launch_counts()
    seg = {"seg_q": seg_q, "seg_k": seg_k}
    out_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal, scale, seg_q,
                                          seg_k)
    delta = (do.float() * out_ref.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    pairs = [
        (fa.flash_fwd(q, k, v, causal, scale, **seg), (out_ref, lse_ref)),
        (fa.flash_bwd_dkv(*args, **seg),
         fa.flash_bwd_dkv_plain(*args, seg_q, seg_k)),
        ((fa.flash_bwd_dq(*args, **seg),),
         (fa.flash_bwd_dq_plain(*args, seg_q, seg_k),)),
    ]
    torch.cuda.synchronize()
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dkv": 0,
                                  "flash_bwd_dq": 0, "flash_fwd_seg": 1,
                                  "flash_bwd_dkv_seg": 1,
                                  "flash_bwd_dq_seg": 1,
                                  "flash_fwd_pfx": 0, "flash_bwd_dkv_pfx": 0,
                                  "flash_bwd_dq_pfx": 0}
    if pair:
        no_key = lse_ref == fa.NEG_INF
        assert no_key.any() and not no_key.all()
        out, lse = pairs[0][0]
        assert bool((lse[no_key] == fa.NEG_INF).all())
        assert bool((out[no_key] == 0).all())
        if ids == "empty":  # B1's empty lists: no tile run, zeros stored
            rows = no_tile[:, None].expand(lse.shape)
            assert bool(rows.any())
            assert bool((lse[rows] == fa.NEG_INF).all())
            assert bool((out[rows] == 0).all())
        assert bool((pairs[2][0][0][no_key] == 0).all())  # dQ
        # keys whose id no row carries: exact zeros in dK and dV
        unseen = ~torch.stack([torch.isin(seg_k[r], seg_q[r])
                               for r in range(b)])[:, None]
        for g in pairs[1][0]:
            assert bool((g[unseen.expand(g.shape[:3])] == 0).all())
    for got, ref in pairs:
        for g, r in zip(got, ref):
            if g.dtype == torch.bfloat16:
                assert flash_check.rows_close(g, r), \
                    flash_check.row_errors(g, r)
                assert flash_check.bias_close(g, r), flash_check.bias(g, r)
            else:
                tol = 1e-3 if g.dim() == 3 else 1e-4
                assert (g.float() - r.float()).abs().max().item() <= tol


def test_prefix_faults_fail_the_row_rule():
    """On the CPU, bf16 and causal, prompts of 300 and 170 tokens: the
    reference attention with the prefix-LM bias passes the row rule
    against the plain prefix forward; a kernel that ignores the prefix,
    one whose prompt is one key too wide, or one that leaves out the
    prompt's tiles above the diagonal fails it in every output."""
    q, k, v, do, scale = _bf16_case(seed=4, b=2, s=512)
    prefix = torch.tensor([300, 170], dtype=torch.int32)
    out, lse = fa.flash_fwd_plain(q, k, v, True, scale, prefix_len=prefix)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, True, scale)
    dk, dv = fa.flash_bwd_dkv_plain(*args, prefix_len=prefix)
    right = {"out": out, "dk": dk, "dv": dv,
             "dq": fa.flash_bwd_dq_plain(*args, prefix_len=prefix)}
    rows = torch.arange(q.shape[2])[:, None]
    cols = torch.arange(q.shape[2])[None, :]
    visible = (cols <= rows) | (cols < prefix[:, None, None, None])
    sound = mha_reference(q, k, v, causal=False, scale=scale,
                          bias=torch.where(visible, 0.0, fa.NEG_INF))
    assert flash_check.rows_close(sound, out), flash_check.row_errors(
        sound, out)
    faults = flash_check.prefix_faults(q, k, v, do, lse, delta, scale,
                                       prefix)
    assert len(faults) == 12
    for name, fault, got in faults:
        assert got.shape == right[name].shape, fault
        assert not flash_check.rows_close(got, right[name]), (
            name, fault, flash_check.row_errors(got, right[name]))
    for name, fault, got in flash_check.bias_controls(
            q, k, v, do, lse, delta, True, scale, prefix_len=prefix):
        assert not flash_check.bias_close(got, right[name]), (name, fault)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,h,hkv,s,d,prefix", [
    # GLM's heads (64 of width 64, MHA) on prompts inside tiles, on a
    # tile edge and past half the row
    (torch.bfloat16, 2, 8, 8, 2048, 64, (1000, 128)),
    (torch.bfloat16, 2, 8, 8, 2048, 64, (127, 129)),
    # a ragged row (1000 rows: the last 128-row q tile part full) with a
    # prompt inside a tile beside none, and prompts that end inside a
    # 128-row tile on a 64-row edge, over GQA groups of 2
    (torch.bfloat16, 2, 8, 8, 1000, 64, (192, 0)),
    (torch.bfloat16, 2, 8, 4, 1000, 64, (64, 320)),
    # GQA and the 128-wide head tile, a ragged row
    (torch.bfloat16, 2, 8, 2, 1000, 128, (700, 37)),
    (torch.bfloat16, 1, 4, 1, 300, 48, (300,)),
    # out-of-range prefixes keep the reference's rule
    (torch.bfloat16, 2, 4, 2, 512, 64, (-5, 5000)),
    (torch.float32, 2, 4, 2, 300, 64, (130, 0)),
    (torch.float32, 1, 4, 4, 300, 64, (299,)),
], ids=["bf16_glm_heads", "bf16_tile_edges", "bf16_ragged_d64",
        "bf16_step_edge_gqa", "bf16_gqa_ragged",
        "bf16_whole_row_d48", "bf16_out_of_range", "f32_ragged",
        "f32_mha"])
def test_prefix_kernels_match_plain_on_card(cuda_device, dtype, b, h, hkv,
                                            s, d, prefix):
    """Each kernel in prefix-LM mode against its plain version on the
    same card inputs, held as ``test_kernels_match_plain_on_card`` holds
    the unsegmented ones (bf16 by the row and the bias rule, f32 to
    1e-4, lse to 1e-3)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = rnd(b, h, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), \
        rnd(b, h, s, d)
    p = torch.tensor(prefix, dtype=torch.int32, device=cuda_device)
    scale = d ** -0.5
    fa.reset_launch_counts()
    out_ref, lse_ref = fa.flash_fwd_plain(q, k, v, True, scale, prefix_len=p)
    delta = (do.float() * out_ref.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse_ref, delta, True, scale)
    pairs = [
        (fa.flash_fwd(q, k, v, True, scale, prefix_len=p),
         (out_ref, lse_ref)),
        (fa.flash_bwd_dkv(*args, prefix_len=p),
         fa.flash_bwd_dkv_plain(*args, prefix_len=p)),
        ((fa.flash_bwd_dq(*args, prefix_len=p),),
         (fa.flash_bwd_dq_plain(*args, prefix_len=p),)),
    ]
    torch.cuda.synchronize()
    counts = fa.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {
        "flash_fwd_pfx": 1, "flash_bwd_dkv_pfx": 1, "flash_bwd_dq_pfx": 1}
    for got, ref in pairs:
        for g, r in zip(got, ref):
            if g.dtype == torch.bfloat16:
                assert flash_check.rows_close(g, r), \
                    flash_check.row_errors(g, r)
                assert flash_check.bias_close(g, r), flash_check.bias(g, r)
            else:
                tol = 1e-3 if g.dim() == 3 else 1e-4
                assert (g.float() - r.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefix_edges_match_the_unprefixed_kernels_bitwise(cuda_device,
                                                           dtype):
    """Prefixes 0 and 1 mask as the causal kernels do, and a prefix of
    the whole row as the non-causal ones: the outputs are bit for bit
    theirs (ragged row, GLM's 64-wide heads)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    b, h, s, d = 2, 4, 1000, 64

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(dtype)

    q, k, v, do = (rnd(b, h, s, d) for _ in range(4))
    scale = d ** -0.5
    for p, causal in ((0, True), (1, True), (s, False)):
        prefix = torch.full((b,), p, dtype=torch.int32, device=cuda_device)
        out, lse = fa.flash_fwd(q, k, v, True, scale, prefix_len=prefix)
        ref_out, ref_lse = fa.flash_fwd(q, k, v, causal, scale)
        delta = (do.float() * ref_out.float()).sum(-1).contiguous()
        args = (q, k, v, do, ref_lse, delta)
        got = (out, lse, *fa.flash_bwd_dkv(*args, True, scale,
                                           prefix_len=prefix),
               fa.flash_bwd_dq(*args, True, scale, prefix_len=prefix))
        want = (ref_out, ref_lse, *fa.flash_bwd_dkv(*args, causal, scale),
                fa.flash_bwd_dq(*args, causal, scale))
        for name, g, w in zip(("out", "lse", "dk", "dv", "dq"), got, want):
            assert torch.equal(g, w), (p, name)


def _grouped_case(device, dtype, tiles, d, f, seed=0, bt=128):
    """x [rows, d], w [E, d, f], tile_expert and dy [rows, f] for
    ``tiles`` row tiles per expert (0: an expert that owns no tile)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    te = torch.repeat_interleave(torch.arange(len(tiles)),
                                 torch.tensor(tiles)).int().to(device)
    rows = te.numel() * bt
    x = torch.randn(rows, d, generator=gen, device=device)
    w = torch.randn(len(tiles), d, f, generator=gen, device=device) / d ** 0.5
    dy = torch.randn(rows, f, generator=gen, device=device)
    return x.to(dtype), w.to(dtype), te, dy.to(dtype), bt


def test_grouped_row_rule_passes_rounding_and_rejects_planted_faults():
    """On the CPU, bf16: the plain versions against bf16 products taken
    another way (torch's bf16 matmul, a rounding apart) pass the row
    rule; the outputs of kernels broken at an expert boundary (a tile
    read with the neighbour's weights, an expert's last tile left out
    of dw, its first counted twice) fail it."""
    x, w, te, dy, bt = _grouped_case("cpu", torch.bfloat16, [2, 3, 1],
                                     64, 96, bt=16)
    rows = te.long().repeat_interleave(bt)
    right = {
        "y": gm.grouped_matmul_fwd_plain(x, w, te, bt),
        "dx": gm.grouped_matmul_fwd_plain(dy, w, te, bt, transpose_w=True),
        "dw": gm.grouped_matmul_dw_plain(x, dy, te, 3, bt),
    }
    other = {
        "y": torch.cat([x[rows == e] @ w[e] for e in range(3)]),
        "dx": torch.cat([dy[rows == e] @ w[e].t() for e in range(3)]),
        "dw": torch.stack([(x[rows == e].t() @ dy[rows == e]).float()
                           for e in range(3)]),
    }
    for name, ref in right.items():
        assert flash_check.rows_close(other[name], ref), name
    faults = grouped_check.planted_faults(x, w, dy, te, bt)
    assert [name for name, _, _ in faults] == ["y", "dx", "dw", "dw"]
    for name, fault, got in faults:
        assert not flash_check.rows_close(got, right[name]), (
            fault, flash_check.row_errors(got, right[name]))


def test_grouped_bias_rule_passes_rounding_and_rejects_truncation():
    """On the CPU, bf16: the plain versions against bf16 products taken
    another way pass the bias rule as well as the row rule; the
    truncation controls (y rounded toward zero to bf16, dw with each row
    tile's partial product truncated to bf16) pass the row rule and fail
    the bias rule."""
    x, w, te, dy, bt = _grouped_case("cpu", torch.bfloat16, [2, 3, 1],
                                     64, 96, bt=16)
    rows = te.long().repeat_interleave(bt)
    right = {
        "y": gm.grouped_matmul_fwd_plain(x, w, te, bt),
        "dx": gm.grouped_matmul_fwd_plain(dy, w, te, bt, transpose_w=True),
        "dw": gm.grouped_matmul_dw_plain(x, dy, te, 3, bt),
    }
    other = {
        "y": torch.cat([x[rows == e] @ w[e] for e in range(3)]),
        "dx": torch.cat([dy[rows == e] @ w[e].t() for e in range(3)]),
        "dw": torch.stack([(x[rows == e].t() @ dy[rows == e]).float()
                           for e in range(3)]),
    }
    for name, ref in right.items():
        assert flash_check.bias_close(other[name], ref), (
            name, flash_check.bias(other[name], ref))
    controls = grouped_check.truncation_controls(x, w, dy, te, bt)
    assert [name for name, _, _ in controls] == ["y", "dw"]
    for name, fault, got in controls:
        ref = right[name]
        assert got.shape == ref.shape and got.dtype == ref.dtype, fault
        assert flash_check.rows_close(got, ref), (
            fault, flash_check.row_errors(got, ref))
        assert not flash_check.bias_close(got, ref), (
            fault, flash_check.bias(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tiles,d,f", [
    (torch.bfloat16, [3, 1, 4, 2], 512, 1024),
    (torch.bfloat16, [2, 0, 3, 1], 256, 384),
    (torch.bfloat16, [2, 1, 3], 200, 1000),
    (torch.bfloat16, [1], 256, 512),
    (torch.bfloat16, [0, 12, 0, 1], 192, 320),
    (torch.float32, [1, 2, 1], 96, 200),
], ids=["bf16", "bf16_empty_expert", "bf16_ragged", "bf16_one_tile",
        "bf16_long_expert", "f32_ragged"])
def test_grouped_kernels_match_plain_on_card(cuda_device, dtype, tiles, d,
                                             f):
    """B4 (y and dx, w read transposed in place) and B5 (dw) against
    their plain versions: bf16 outputs, and B5's f32 output of bf16
    inputs, row by row and by their bias (``flash_check``); f32 inputs to
    1e-4 absolute plus 1e-4 relative. The bf16 cases reach the edges of
    the kernels' 128 x 256 x 64 tiles: D and F not multiples of 64 (a K
    tail and ragged M and N), a single row tile in all, and one expert
    with 12 tiles beside empty ones. An expert that owns no tile gets an
    exact-zero dw, written over memory the allocator hands back full of
    NaN."""
    x, w, te, dy, bt = _grouped_case(cuda_device, dtype, tiles, d, f)
    e = len(tiles)
    gm.reset_launch_counts()
    junk = torch.full((e, d, f), float("nan"), device=cuda_device)
    del junk  # its block goes back to the caching allocator
    dw = gm.grouped_matmul_dw(x, dy, te, e, bt)
    pairs = [
        (gm.grouped_matmul_fwd(x, w, te, bt),
         gm.grouped_matmul_fwd_plain(x, w, te, bt)),
        (gm.grouped_matmul_fwd(dy, w, te, bt, transpose_w=True),
         gm.grouped_matmul_fwd_plain(dy, w, te, bt, transpose_w=True)),
        (dw, gm.grouped_matmul_dw_plain(x, dy, te, e, bt)),
    ]
    torch.cuda.synchronize()
    assert gm.launch_counts() == {"grouped_matmul_fwd": 2,
                                  "grouped_matmul_dw": 1,
                                  "grouped_matmul_fwd_quant": 0}
    for got, ref in pairs:
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if dtype == torch.bfloat16:
            assert flash_check.rows_close(got, ref), \
                flash_check.row_errors(got, ref)
            assert flash_check.bias_close(got, ref), \
                flash_check.bias(got, ref)
        else:
            torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
    for expert in (i for i, n in enumerate(tiles) if n == 0):
        assert torch.count_nonzero(dw[expert]).item() == 0


def test_quant_row_rule_rejects_planted_faults():
    """On the CPU: B6's plain output passes the row rule against the
    dequantize-then-matmul product taken another way, and a neighbour
    block's scale, ignored scales or a tile read with the neighbour
    expert's weights fail it."""
    x, w, te, _, bt = _grouped_case("cpu", torch.float32, [2, 3, 1], 64, 96,
                                    bt=16)
    v, s = quantize.quantize_block_scaled(x)
    right = gm.grouped_matmul_fwd_quant_plain(v, s, w, te, bt)
    xd = quantize.dequantize_block_scaled(v, s)
    rows = te.long().repeat_interleave(bt)
    other = torch.cat([xd[rows == e] @ w[e] for e in range(3)])
    assert flash_check.rows_close(other, right)
    faults = grouped_check.planted_quant_faults(v, s, w, te, bt)
    assert len(faults) == 3
    for name, fault, got in faults:
        assert got.shape == right.shape, fault
        assert not flash_check.rows_close(got, right), (
            fault, flash_check.row_errors(got, right))


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,d,f", [
    ([1, 2, 1], 96, 200),
    ([2, 0, 3], 256, 384),
    ([1, 2, 1], 200, 96),
], ids=["ragged", "empty_expert", "scale_block_25"])
def test_quant_kernel_matches_plain_on_card(cuda_device, tiles, d, f):
    """B6 against its plain version (f32, 1e-4 absolute plus relative),
    and bit for bit against dequantize followed by B4's f32 path: the
    contract the reference pins inside itself. D=200 has 25-channel
    scale blocks, which straddle the kernel's eight-byte loads, and a
    half-filled last k tile."""
    x, w, te, _, bt = _grouped_case(cuda_device, torch.float32, tiles, d, f)
    v, s = quantize.quantize_block_scaled(x * 3)
    gm.reset_launch_counts()
    y = gm.grouped_matmul_fwd_quant(v, s, w, te, bt)
    ref = gm.grouped_matmul_fwd_quant_plain(v, s, w, te, bt)
    b4 = gm.grouped_matmul_fwd(quantize.dequantize_block_scaled(v, s), w, te,
                               bt)
    torch.cuda.synchronize()
    assert gm.launch_counts() == {"grouped_matmul_fwd": 1,
                                  "grouped_matmul_dw": 0,
                                  "grouped_matmul_fwd_quant": 1}
    assert y.shape == ref.shape and y.dtype == torch.float32
    torch.testing.assert_close(y, ref, atol=1e-4, rtol=1e-4)
    assert torch.equal(y, b4)


@pytest.mark.cuda
@pytest.mark.parametrize("tiles,d,f,live", [
    ([3, 2, 1], 256, 384, 512),
    ([3, 2, 1], 384, 256, 512),
    ([1, 2, 1], 96, 200, 300),
    ([1, 2, 1], 200, 96, 300),
    ([2, 1], 128, 256, 0),
    ([2, 1], 128, 256, 10 ** 6),
    ([2, 6], 256, 384, 512),
    ([1, 9], 256, 384, 1024),
    ([2, 1, 3], 256, 384, 256),
    ([1, 2, 1], 96, 200, 256),
], ids=["up", "down", "ragged_up", "ragged_down", "all_dead", "all_live",
        "main_like", "skewed", "expert_without_live_rows",
        "ragged_whole_tiles"])
def test_f32_kernels_with_live_rows_on_card(cuda_device, tiles, d, f, live):
    """B4's f32 forms (y = x w[e]; dx = dy w[e]^T, w read transposed in
    place) and B6 with and without ``live_rows``: within 1e-4 absolute
    plus relative of their plain versions; rows at or past it exactly
    zero, the rows before bit for bit the same kernel's without it (a
    dead row tile is skipped, not computed); B6 bit for bit dequantize +
    B4's f32 path with the same ``live_rows``. B5's f32 dw: on inputs
    zero past ``live_rows`` bit for bit the same with and without it; on
    inputs that are not, the same result (nothing past it is read),
    within 1e-4 of the plain version; an expert whose rows all lie past
    it gets zeros. Shapes with D < F (an up projection) and D > F (a
    down one), ragged D and F (a K tail, ragged columns), a
    ``live_rows`` inside a row tile (B5's tail rows), none live, one
    past the end (every row live), the expert-parallel layout's (the
    last expert's pad tiles past it), a skewed one, and experts with no
    live rows."""
    x, w, te, dy, bt = _grouped_case(cuda_device, torch.float32, tiles, d, f)
    lr = torch.tensor([live], dtype=torch.int32, device=cuda_device)
    n = min(live, x.shape[0])
    e = len(tiles)
    xz, dyz = x.clone(), dy.clone()
    xz[n:], dyz[n:] = 0.0, 0.0
    gm.reset_launch_counts()
    dw_all = gm.grouped_matmul_dw(xz, dyz, te, e, bt)
    dw_live = gm.grouped_matmul_dw(xz, dyz, te, e, bt, live_rows=lr)
    dw_junk = gm.grouped_matmul_dw(x, dy, te, e, bt, live_rows=lr)
    ref = gm.grouped_matmul_dw_plain(x, dy, te, e, bt, live_rows=lr)
    torch.cuda.synchronize()
    assert torch.equal(dw_all, dw_live) and torch.equal(dw_junk, dw_live)
    torch.testing.assert_close(dw_live, ref, atol=1e-4, rtol=1e-4)
    first = torch.searchsorted(te, torch.arange(e, device=cuda_device,
                                                dtype=te.dtype)) * bt
    for expert in range(e):
        if first[expert].item() >= n:
            assert torch.count_nonzero(dw_live[expert]).item() == 0
    v, s = quantize.quantize_block_scaled(x * 3)
    xd = quantize.dequantize_block_scaled(v, s)
    for args, kwargs in (((x, w, te, bt), {}),
                         ((dy, w, te, bt), {"transpose_w": True})):
        full = gm.grouped_matmul_fwd(*args, **kwargs)
        got = gm.grouped_matmul_fwd(*args, live_rows=lr, **kwargs)
        ref = gm.grouped_matmul_fwd_plain(*args, live_rows=lr, **kwargs)
        torch.cuda.synchronize()
        torch.testing.assert_close(full, gm.grouped_matmul_fwd_plain(
            *args, **kwargs), atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)
        assert torch.count_nonzero(got[n:]).item() == 0
        assert torch.equal(got[:n], full[:n])
    for live_rows in (None, lr):
        y = gm.grouped_matmul_fwd_quant(v, s, w, te, bt, live_rows=live_rows)
        b4 = gm.grouped_matmul_fwd(xd, w, te, bt, live_rows=live_rows)
        ref = gm.grouped_matmul_fwd_quant_plain(v, s, w, te, bt,
                                                live_rows=live_rows)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, ref, atol=1e-4, rtol=1e-4)
        assert torch.equal(y, b4)
    assert torch.count_nonzero(y[n:]).item() == 0
    assert gm.launch_counts() == {"grouped_matmul_fwd": 6,
                                  "grouped_matmul_dw": 3,
                                  "grouped_matmul_fwd_quant": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe_grouped"])
def test_multi_step_is_k_single_steps_bitwise_on_card(cuda_device, moe):
    """The fused multi-step call on the card: two calls of K = 4 against
    eight single steps from the same init and batches, through the
    flash kernels (and with experts the grouped ones): every loss and
    every parameter bit equal, and the same launches."""
    from dlrover_tpu_torch.examples import train_llama as example
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.models.common import tree_leaves
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    kw = (dict(num_experts=4, moe_top_k=2, moe_dispatch="grouped")
          if moe else {})
    cfg = llama.llama_tiny(use_flash=True, **kw)
    gen = example.synthetic_batches(cfg.vocab_size, 2, 128)()
    batches = [next(gen) for _ in range(8)]
    runs = []
    for k in (1, 4):
        trainer = ElasticTrainer(llama.make_init_fn(cfg),
                                 llama.make_loss_fn(cfg), example.adamw(),
                                 batches[0], device=cuda_device,
                                 steps_per_call=k)
        state, losses = trainer.prepare(), []
        fa.reset_launch_counts()
        gm.reset_launch_counts()
        for i in range(0, 8, k):
            if k == 1:
                state, m = trainer.step(state, batches[i])
            else:
                state, m = trainer.step_multi(state, batches[i:i + k])
            losses += torch.atleast_1d(m["loss"]).tolist()
        torch.cuda.synchronize()
        runs.append((losses, [p.detach().cpu()
                              for p in tree_leaves(state.params)],
                     {**fa.launch_counts(), **gm.launch_counts()}))
    (l1, p1, c1), (l4, p4, c4) = runs
    assert l1 == l4
    assert all(torch.equal(a, b) for a, b in zip(p1, p4))
    assert c1 == c4 and c1["flash_fwd"] > 0
    if moe:
        assert c1["grouped_matmul_fwd"] > 0 and c1["grouped_matmul_dw"] > 0


@pytest.mark.cuda
def test_moe_ep_live_reshard_over_nccl_on_four_cards():
    """A planned change of world from four ranks to two with a card a
    rank (NCCL: the regrouped snapshot's transfers go through the
    cards): ranks 2 and 3 leave, the survivors hold their slices of the
    pre-change experts bit for bit and train on bit for bit as a cold
    trainer from the same snapshot. Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (one rank a card, NCCL)")
    import numpy as np

    import torch_recovery_workers as workers
    from dlrover_tpu_torch import interop
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.run import run_local

    kw = dict(num_experts=8, moe_top_k=2, moe_dispatch="grouped_ep")
    cfg = llama.llama_tiny(**kw)
    tree = interop.params_to_numpy(
        llama.init(torch.Generator().manual_seed(0), cfg))
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (6, 8, 17))
    batches = [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]
    got = run_local(workers.moe_reshard_ranks, 4,
                    (tree, batches, kw, 1e-2, 3, "cuda"), timeout=300)
    assert [r.get("left", False) for r in got] == [False, False, True, True]
    for t, r in enumerate(got[:2]):
        assert r["backend"] == "nccl" and r["world_after"] == 2
        assert r["live"] == r["cold"]
        for key in r["live_state"]:
            assert r["live_state"][key].tobytes() == \
                r["cold_state"][key].tobytes(), key
        for key, after in r["after"].items():
            if "/experts/" in key and not key.endswith("/step"):
                full = np.concatenate([g["before"][key] for g in got], 1)
                assert after.tobytes() == \
                    full[:, 4 * t:4 * t + 4].tobytes(), (t, key)


@pytest.mark.cuda
def test_fsdp_over_nccl_on_four_cards():
    """The tiny dense Llama at (data, fsdp) = (2, 2) and at (1, 4) over
    NCCL, a card a rank (the all-gathers and reduce-scatters through the
    cards), against (4, 1): three AdamW steps, losses within 1e-5
    relative (tests/test_torch_fsdp.py's CPU tolerance between meshes
    is 1e-6; the cards' kernels sum in their own order), every rank the
    same global loss, each sharded leaf split as the rules say. Then the
    layer prefetch at 4 layers, (1, 4) and (2, 2), three SGD steps on
    and off: losses within 1e-5 relative, at most two layers held, each
    layer broadcast twice a step. Needs four cards."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (one rank a card, NCCL)")
    import numpy as np

    import torch_fsdp_workers as workers
    from dlrover_tpu_torch import interop
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.run import run_local

    import torch_prefetch_workers as prefetch_workers

    cfg = llama.llama_tiny()
    tree = interop.params_to_numpy(
        llama.init(torch.Generator().manual_seed(0), cfg))
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, (3, 8, 17))
    batches = [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]
    got = run_local(workers.dense_ranks, 4,
                    (tree, {}, batches, 1e-2, None, None, None, "cuda"),
                    timeout=300)
    # the layer prefetch over NCCL, 4 layers: a layer's owner broadcasts
    # it on the process group's stream, overlapped with the previous
    # layer; its gradient reduced to the owner
    deep = {"num_layers": 4}
    tree4 = interop.params_to_numpy(llama.init(
        torch.Generator().manual_seed(0), llama.llama_tiny(**deep)))
    prefetched = run_local(prefetch_workers.quad_ranks, 4,
                           (tree4, None, deep, None, batches, None, "cuda"),
                           timeout=300)
    for r in prefetched:
        for mesh in ((1, 4), (2, 2)):
            off, on = r["runs"][mesh][False], r["runs"][mesh][True]
            np.testing.assert_allclose(on["losses"], off["losses"],
                                       rtol=1e-5)
            assert on["held"]["held_high_water"] <= 2
            assert on["stats"]["broadcast"]["calls"] == 3 * 2 * 7 * 4
            assert "broadcast" not in off["stats"]
    for r in got:
        runs = r["runs"]
        for mesh in ((2, 2), (1, 4)):
            np.testing.assert_allclose(runs[mesh]["losses"],
                                       runs[(4, 1)]["losses"], rtol=1e-5)
            assert runs[mesh]["stats"]["all_gather"]["calls"] == \
                3 * len(runs[mesh]["sharded"])
        assert runs[(2, 2)]["blocks"]["params/layers/q_proj/kernel"] == \
            (1, 64, 64)
        assert runs[(4, 1)]["sharded"] == []
        assert runs[(2, 2)]["losses"] == got[0]["runs"][(2, 2)]["losses"]


@pytest.mark.cuda
def test_staged_fp8_prefetch_on_one_card():
    """Two ranks sharing one card over gloo (the layer exchanges staged
    through host memory on a copy stream, as phase 18 of chip_smoke.py
    runs them), the tiny dense Llama at 4 layers and (data, fsdp) =
    (1, 2), the fp8 and fp8_qdq FSDP wires with the layer prefetch off
    and on, three SGD steps: the losses, each step's block gradients and
    the final blocks bit for bit, while each quantize the prefetch sends
    is held back on its stream by ~50 ms of spinning and an e4m3 NaN
    fill (a copy out racing it sends wrong bytes). Needs a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (two gloo ranks sharing it)")
    import numpy as np

    from dlrover_tpu_torch import interop
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.trainer.run import run_local

    import torch_prefetch_workers as workers

    kw, steps = {"num_layers": 4}, 3
    tree = interop.params_to_numpy(llama.init(
        torch.Generator().manual_seed(0), llama.llama_tiny(**kw)))
    ids = np.random.RandomState(3).randint(0, 256, (steps, 8, 17))
    batches = [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]
    got = run_local(workers.one_card_ranks, 2,
                    (tree, kw, batches, 100_000_000), timeout=300)
    for r in got:
        for case, run in r["runs"].items():
            off, on = run[False], run[True]
            assert run["resolved"] == case[1]
            assert on["losses"] == off["losses"], case
            for a, b in zip(off["grads"], on["grads"]):
                for path in a:
                    assert a[path].tobytes() == b[path].tobytes(), \
                        (case, path)
            for path, a in off["params"].items():
                assert on["params"][path].tobytes() == a.tobytes(), \
                    (case, path)
            assert on["held"]["fetches"] == steps * 2 * 4
