"""Prefix-LM (GLM) flash attention in the PyTorch port held against the
JAX package.

Inputs come from a numpy seed and go through both the JAX function and
its port counterpart. On the CPU the port's flash wrappers take their
plain versions; the JAX flash kernels run in Pallas interpret mode, as
the JAX package's own tests run them, with blocks of 8 to 16 tokens so
that each sequence spans several blocks. f32 throughout, so the
tolerances are summation-order ones: 1e-5 for outputs and lse, 1e-4 for
gradients.

The prefix-LM kernels themselves are held to these plain versions on
the card by ``tests/test_torch_kernels.py``.
"""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.flash_attention import (
    flash_attention_prefix as jax_prefix,
    flash_attention_prefix_lse as jax_prefix_lse,
)
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


# (b, h, hkv, s, d, jax block, prefix lengths of the rows)
CASES = {
    # one prompt row, one pure-causal row (the JAX package's own case)
    "gqa_40_0": (2, 4, 2, 64, 16, 16, (40, 0)),
    # early rows visit prompt blocks past their diagonal and past the
    # prompt: the reference's clamp case
    "mha_small_blocks_24": (1, 2, 2, 64, 16, 8, (24,)),
    # the whole row is prompt: no causal mask left
    "gqa_whole_row": (2, 4, 2, 64, 16, 16, (64, 17)),
    # prompts ending on a block boundary
    "gqa_block_boundary": (2, 4, 2, 96, 16, 16, (32, 48)),
    # GLM's 64-wide heads, MHA
    "mha_d64": (2, 2, 2, 64, 64, 16, (30, 1)),
    "gqa_d64": (1, 4, 1, 80, 64, 16, (45,)),
}


def _arrays(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).requires_grad_(grad)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def _case(name, seed):
    b, h, hkv, s, d, block, prefix = CASES[name]
    q, dout = _arrays([(b, h, s, d), (b, h, s, d)], seed)
    k, v = _arrays([(b, hkv, s, d), (b, hkv, s, d)], seed + 1)
    (dlse,) = _arrays([(b, h, s)], seed + 2)
    return q, k, v, dout, dlse, np.asarray(prefix, np.int32), block


class TestPrefixFlashAgainstJax:
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_out_lse_and_both_cotangents(self, case):
        """``flash_attention_prefix_lse``: out, lse and the gradients of
        q, k and v with cotangents on both outputs."""
        q, k, v, dout, dlse, prefix, block = _case(case, 1)
        pre = jnp.asarray(prefix)

        def jfn(q, k, v):
            return jax_prefix_lse(q, k, v, pre, None, block, block, True)

        (jout, jlse), vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
        jgrads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))

        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out, lse = fa.flash_attention_prefix_lse(tq, tk, tv, _t(prefix),
                                                 block_q=block,
                                                 block_k=block)
        assert lse.dtype == torch.float32
        _close(out, jout, FWD_TOL)
        _close(lse, jlse, FWD_TOL)
        grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                    (_t(dout), _t(dlse)))
        for g, jg in zip(grads, jgrads):
            assert np.isfinite(g.numpy()).all()
            _close(g, jg, GRAD_TOL)

    @pytest.mark.parametrize("case", ["gqa_40_0", "mha_small_blocks_24",
                                      "mha_d64"])
    def test_out_and_grads(self, case):
        """``flash_attention_prefix`` (out alone): the output and the
        gradients of an out cotangent."""
        q, k, v, dout, _, prefix, block = _case(case, 4)

        def jfn(q, k, v):
            return jax_prefix(q, k, v, jnp.asarray(prefix), None, block,
                              block, True)

        jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
        jgrads = vjp(jnp.asarray(dout))
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        out = fa.flash_attention_prefix_auto(tq, tk, tv, _t(prefix))
        _close(out, jout, FWD_TOL)
        for g, jg in zip(torch.autograd.grad(out, (tq, tk, tv), _t(dout)),
                         jgrads):
            _close(g, jg, GRAD_TOL)


class TestPrefixMask:
    def test_no_prefix_is_causal_attention(self):
        """Prefixes 0 and 1 give the causal mask: the same output as
        the causal flash attention, bit for bit."""
        q, k, v, *_ = _case("gqa_40_0", 7)
        causal = fa.flash_attention(_t(q), _t(k), _t(v))
        for p in (0, 1):
            out = fa.flash_attention_prefix(
                _t(q), _t(k), _t(v), torch.full((2,), p, dtype=torch.int32))
            np.testing.assert_array_equal(out.numpy(), causal.numpy())

    def test_whole_row_prefix_is_full_attention(self):
        q, k, v, *_ = _case("gqa_40_0", 8)
        full = fa.flash_attention(_t(q), _t(k), _t(v), causal=False)
        out = fa.flash_attention_prefix(_t(q), _t(k), _t(v),
                                        torch.full((2,), 64,
                                                   dtype=torch.int32))
        np.testing.assert_array_equal(out.numpy(), full.numpy())

    def test_generated_tokens_do_not_reach_the_prompt(self):
        """Changing a generated token's key and value leaves every prompt
        row's output exactly as it was, and moves the rows after it."""
        q, k, v, *_ = _case("mha_small_blocks_24", 9)
        p = torch.tensor([24], dtype=torch.int32)
        base = fa.flash_attention_prefix(_t(q), _t(k), _t(v), p)
        k2, v2 = k.copy(), v.copy()
        k2[:, :, 40] += 1.0
        v2[:, :, 40] -= 1.0
        moved = fa.flash_attention_prefix(_t(q), _t(k2), _t(v2), p)
        np.testing.assert_array_equal(moved[:, :, :40].numpy(),
                                      base[:, :, :40].numpy())
        assert not torch.equal(moved[:, :, 40:], base[:, :, 40:])


class TestPrefixChecks:
    def test_segment_ids_and_a_prefix_raise(self):
        q = torch.zeros(1, 2, 8, 16)
        ids = torch.zeros(1, 8, dtype=torch.int32)
        p = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="mutually exclusive"):
            fa.flash_fwd(q, q, q, True, 0.25, seg_q=ids, seg_k=ids,
                         prefix_len=p)

    def test_prefix_must_be_int32_of_the_batch(self):
        q = torch.zeros(2, 2, 8, 16)
        rows = torch.zeros(2, 2, 8)
        with pytest.raises(ValueError, match="int32"):
            fa.flash_fwd(q, q, q, True, 0.25,
                         prefix_len=torch.zeros(2, dtype=torch.int64))
        with pytest.raises(ValueError, match=r"must be int32 \[2\]"):
            fa.flash_bwd_dkv(q, q, q, q, rows, rows, True, 0.25,
                             prefix_len=torch.zeros(3, dtype=torch.int32))
        with pytest.raises(ValueError, match="causal"):
            fa.flash_bwd_dq(q, q, q, q, rows, rows, False, 0.25,
                            prefix_len=torch.zeros(2, dtype=torch.int32))

    def test_prefix_on_another_device_raises(self):
        q = torch.zeros(1, 2, 8, 16)
        p = torch.zeros(1, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="several devices"):
            fa.flash_fwd(q, q, q, True, 0.25, prefix_len=p)

    def test_entry_points_cast_the_prefix_once(self):
        """An int64 prefix (a batch's usual type) reaches the wrappers as
        int32 and gives what an int32 one gives."""
        q, k, v, *_ = _case("gqa_40_0", 10)
        p = torch.tensor([40, 3])
        np.testing.assert_array_equal(
            fa.flash_attention_prefix(_t(q), _t(k), _t(v), p).numpy(),
            fa.flash_attention_prefix(_t(q), _t(k), _t(v),
                                      p.int()).numpy())

    def test_cpu_path_counts_no_launch(self):
        fa.reset_launch_counts()
        q, k, v, *_ = _case("gqa_40_0", 11)
        tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
        fa.flash_attention_prefix(tq, tk, tv, torch.tensor([40, 0])
                                  ).sum().backward()
        counts = fa.launch_counts()
        assert {"flash_fwd_pfx", "flash_bwd_dkv_pfx",
                "flash_bwd_dq_pfx"} <= set(counts)
        assert set(counts.values()) == {0}


def _chip_smoke():
    """``chip_smoke.py`` loaded as a module (it imports no torch or JAX
    at the top)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _source(name):
    return (fa.kernel_build.CSRC / f"{name}.cu").read_text()


class TestAgainstTables:
    """``chip_smoke.py --against`` holds every bf16 entry point of the
    flash sources against another tree's, the prefix-LM and unprefixed
    ones as well as the segment-id ones, and reads each one's argument
    types from its source."""

    @pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq"])
    def test_tables_name_every_bf16_entry_point(self, name):
        smoke = _chip_smoke()
        assert name in smoke.AGAINST_SOURCES
        found = set(re.findall(r'extern "C" int (dlr_\w+_bf16)\(',
                               _source(name)))
        listed = {entry for entry, (source, _) in
                  smoke.AGAINST_ENTRIES.items() if source == name}
        assert found == listed
        assert {f"dlr_{name}_pfx_bf16", f"dlr_{name}_bf16"} <= listed
        for kernel, mode in smoke.AGAINST_TIMED:
            assert f"dlr_{kernel}{mode}_bf16" in smoke.AGAINST_ENTRIES

    @pytest.mark.parametrize("mode", ["", "_pfx", "_seg"])
    @pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq"])
    def test_parse_entry_reads_the_wrappers_argument_types(self, name,
                                                           mode):
        smoke = _chip_smoke()
        entry = f"dlr_{name}{mode}_bf16"
        assert smoke.AGAINST_ENTRIES[entry] == (name, mode)
        assert smoke._parse_entry(_source(name), entry) == \
            fa._ARGTYPES[name + mode]

    def test_cases_cover_the_new_step_geometry(self):
        """GLM's shape on phase 14's prompts and its edge prompts, and
        ragged rows whose last 128-row step is part full."""
        smoke = _chip_smoke()
        cases = smoke.against_cases([688, 563, 633, 196])
        labels = [c[0] for c in cases]
        assert len(set(labels)) == len(labels)
        prompts = [c[6] for c in cases if c[6] is not None]
        assert [688, 563, 633, 196] in prompts
        assert [128, 127, 129, 1000] in prompts
        assert [0, 1, smoke.GLM_SEQ, smoke.GLM_SEQ // 2] in prompts
        assert {c[7] for c in cases if c[6] is None} == {True, False}
        assert any(c[4] % 128 for c in cases)
        assert all(c[5] <= 64 for c in cases)

    def test_b1_is_timed_in_turns_at_glms_shape(self):
        """``--against`` times B1 beside B2 and B3, prefix-LM and
        unprefixed, and B1 alone on the non-causal layout: each timed
        layout is one of ``against_cases`` at GLM's shape."""
        smoke = _chip_smoke()
        for mode in ("_pfx", ""):
            assert {name for name, m in smoke.AGAINST_TIMED if m == mode} \
                == set(smoke.AGAINST_SOURCES)
        cases = {c[0]: c for c in smoke.against_cases([688, 563, 633, 196])}
        for label, names in smoke.AGAINST_TIMED_LAYOUTS.items():
            _, b, h, _, s, d, prompts, _ = cases[label]
            assert (b, h, s, d) == (smoke.GLM_BATCH, 64, smoke.GLM_SEQ, 64)
            assert prompts is None and "flash_fwd" in names
        assert smoke.AGAINST_TIMED_LAYOUTS["GLM shape, non-causal"] == (
            "flash_fwd",)
        assert cases["GLM shape, non-causal"][7] is False


def _chip_stages():
    spec = importlib.util.spec_from_file_location(
        "chip_stages", os.path.join(os.path.dirname(__file__), "..",
                                    "chip_stages.py"))
    stages = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(stages)
    return stages


@pytest.mark.parametrize("name", ["d64-noexp", "d64-noscores", "d64-nograds",
                                  "d64-noring", "d64-noturns",
                                  "d64-noproducts", "d64-nothing",
                                  "fwd64-noexp", "fwd64-noscores",
                                  "fwd64-nopv", "fwd64-nomask",
                                  "fwd64-noring", "fwd64-onetile",
                                  "fwd64-truncp", "fwd64-introundp",
                                  "fwd64-timeline", "fwd64-noproducts",
                                  "fwd64-nothing"])
def test_stage_variants_fit_todays_kernels(tmp_path, name):
    """``chip_stages.py write`` compiles each stage of the 64-wide head
    tile's kernels out of today's sources: every text it replaces is
    there, and only the sources it names change (B2's and B3's for the
    ``d64-`` set, B1's for the ``fwd64-`` set)."""
    stages = _chip_stages()
    root = os.path.join(os.path.dirname(__file__), "..")
    stages.write(root, str(tmp_path), [name])
    out = tmp_path / name / stages.CSRC
    changed = sorted(
        f.name for f in out.iterdir()
        if f.read_bytes() != (fa.kernel_build.CSRC / f.name).read_bytes())
    assert changed == sorted(stages.VARIANTS[name])
    for source, pairs in stages.VARIANTS[name].items():
        text = (out / source).read_text()
        for old, new in pairs:
            assert new in text
