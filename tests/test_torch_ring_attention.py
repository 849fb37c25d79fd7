"""The port's ring attention (``ops/ring_attention.py``, ``ops/ring.py``'s
shift) against the JAX package's ``ring_attention``.

The reference runs on the 8 JAX CPU devices of ``tests/conftest.py`` at
``MeshPlan(data=2, seq=4)``, impl "xla" (the blockwise attend) and, for
one case a mode, "pallas_interpret" (its Pallas kernels interpreted);
one jitted call a case gives its global output and the gradients of
``sum(out * w)``. The port runs the same global arrays (numpy, seeded)
on four gloo CPU ranks at seq = 4 and on two pairs of ranks at seq = 2,
with ``use_flash`` on (the flash kernels' plain versions) and off (the
blockwise attend), and each rank's out, dq, dk and dv are held against
the matching slice of the reference's: 2e-5 absolute and relative on
the output, 5e-5 on the gradients (f32, summation order), the
reference's own ring tests' tolerances. The cases: causal with GQA,
non-causal, packed documents with boundaries off the shard edges
(causal and not), and prefix-LM rows whose prompts straddle a shard
bound, sit on one, are empty and fill the row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops import ring_attention as jax_ra
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu_torch.ops import ring_attention as ra
from dlrover_tpu_torch.ops.flash_attention import NEG_INF
from dlrover_tpu_torch.trainer.run import run_local

import torch_seq_workers as workers

OUT_TOL, GRAD_TOL, TIMEOUT = 2e-5, 5e-5, 300
B, H, S, D = 2, 4, 32, 16


def _case(seed, causal=True, kv_heads=H, seg=None, prefix=None, rows=B,
          block_k=512):
    rs = np.random.RandomState(seed)
    case = {
        "q": rs.randn(rows, H, S, D).astype(np.float32),
        "k": rs.randn(rows, kv_heads, S, D).astype(np.float32),
        "v": rs.randn(rows, kv_heads, S, D).astype(np.float32),
        "w": rs.randn(rows, H, S, D).astype(np.float32),
        "causal": causal, "block_k": block_k}
    if seg is not None:
        case["seg"] = np.asarray(seg, np.int32)
    if prefix is not None:
        case["prefix"] = np.asarray(prefix, np.int32)
    return case


# boundaries at 5 and 25 (shards of 8 at seq = 4, 16 at seq = 2)
SEG = [[0] * 5 + [1] * 20 + [2] * 7, [0] * 13 + [1] * 11 + [3] * 8]
CASES = {
    # block_k 3: the blockwise attend pads the shard's keys (8 or 16)
    "causal_gqa": _case(0, kv_heads=2, block_k=3),
    "full": _case(1, causal=False),
    "packed_gqa": _case(2, kv_heads=2, seg=SEG, block_k=5),
    "packed_full": _case(3, causal=False, seg=SEG),
    # prompts straddling a bound (12), on one (16), empty, the whole row
    "prefix": _case(4, prefix=[12, 16, 0, 32], rows=4),
}
# the modes the reference also runs in Pallas interpret mode
PALLAS = ("causal_gqa", "packed_gqa", "prefix")


def _jax_ring(case, impl):
    mesh = JaxMeshPlan(data=2, seq=4).build()
    kw = {}
    if "seg" in case:
        kw["segment_ids"] = jnp.asarray(case["seg"])
    if "prefix" in case:
        kw["prefix_len"] = jnp.asarray(case["prefix"])

    def both(q, k, v, w):
        def f(q, k, v):
            return jax_ra.ring_attention(
                q, k, v, mesh, causal=case["causal"], head_axis=None,
                impl=impl, block_q=8, block_k=8, **kw)

        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(w)

    out, (dq, dk, dv) = jax.jit(both)(*(jnp.asarray(case[x])
                                        for x in "qkvw"))
    return {key: np.asarray(jax.device_get(t)) for key, t in
            (("out", out), ("dq", dq), ("dk", dk), ("dv", dv))}


@pytest.fixture(scope="module")
def rings():
    want = {(name, "xla"): _jax_ring(case, "xla")
            for name, case in CASES.items()}
    want.update({(name, "pallas_interpret"): _jax_ring(CASES[name],
                                                       "pallas_interpret")
                 for name in PALLAS})
    got = run_local(workers.ring_ranks, 4, (CASES,), timeout=TIMEOUT)
    return want, got


def _slice(a, my, n):
    s = a.shape[2] // n
    return a[:, :, my * s:(my + 1) * s]


class TestAgainstTheReference:
    @pytest.mark.parametrize("impl", ["flash", "blockwise"])
    @pytest.mark.parametrize("seq", [2, 4])
    @pytest.mark.parametrize("name", sorted(CASES))
    def test_out_and_grads_match_the_reference_slices(self, rings, name,
                                                      seq, impl):
        want, got = rings
        refs = [want[(name, "xla")]]
        if name in PALLAS:
            refs.append(want[(name, "pallas_interpret")])
        for r in got:
            my = r["rank"] % seq
            ours = r[f"seq{seq}"][(name, impl)]
            for ref in refs:
                for key in ("out", "dq", "dk", "dv"):
                    tol = OUT_TOL if key == "out" else GRAD_TOL
                    np.testing.assert_allclose(
                        ours[key], _slice(ref[key], my, seq), rtol=tol,
                        atol=tol, err_msg=f"rank {r['rank']} {key}")

    def test_the_case_grads_are_not_trivial(self, rings):
        want, _ = rings
        for ref in want.values():
            assert all(np.abs(ref[k]).max() > 1e-2 for k in ref)

    def test_reference_impls_agree(self, rings):
        want, _ = rings
        for name in PALLAS:
            for key in ("out", "dq", "dk", "dv"):
                np.testing.assert_allclose(
                    want[(name, "xla")][key],
                    want[(name, "pallas_interpret")][key],
                    rtol=GRAD_TOL, atol=GRAD_TOL)


class TestSchedule:
    def test_overlapped_ring_is_the_synchronous_one_bit_for_bit(self, rings):
        _, got = rings
        for r in got:
            assert all(r["overlap_bitwise"].values()), r["overlap_bitwise"]

    def test_ring_shift_and_its_backward(self, rings):
        """Rank i receives rank i-1's tensor; the cotangent goes back
        to i-1 (the reverse shift), bit for bit; a tuple travels as one
        buffer; every call is counted with its bytes and exposed wait."""
        _, got = rings
        for r in got:
            shift = r["shift"]
            assert shift["forward"] and shift["backward"] and \
                shift["reverse"]
            assert shift["stats"]["calls"] == 3
            assert shift["stats"]["bytes"] == 3 * 3 * 5 * 8
            assert shift["stats"]["wait_seconds"] >= 0.0
            peer = (r["rank"] // 2) * 2 + (r["rank"] + 1) % 2
            ids, vals = r["pair_out"]
            assert ids.tolist() == (np.arange(4) + 10 * peer).tolist()
            assert vals.tolist() == [float(peer)] * 2


class TestPieces:
    def test_permutation_tables_are_the_reference_s(self):
        from dlrover_tpu.ops import ring as jax_ring
        from dlrover_tpu_torch.ops import ring

        for n in (1, 2, 4):
            assert ring.neighbor_perm(n) == jax_ring.neighbor_perm(n)
            for step in range(-1, n + 1):
                assert ring.shifted_perm(n, step) == \
                    jax_ring.shifted_perm(n, step)

    def test_merge_of_neg_inf_rows_matches_the_reference_bitwise(self):
        """A fully masked contribution (lse NEG_INF) merges as a no-op,
        and two of them stay at NEG_INF with out 0, in the reference's
        bits."""
        rs = np.random.RandomState(0)
        o = rs.randn(2, 3, 4).astype(np.float32)
        lse = rs.randn(2, 3).astype(np.float32)
        o0 = np.zeros_like(o)
        neg = np.full_like(lse, NEG_INF)
        for args in ((o, lse, o0, neg), (o0, neg, o, lse),
                     (o0, neg, o0, neg)):
            ours = ra._merge_lse(*(torch.from_numpy(a) for a in args))
            theirs = jax_ra._merge_lse(*(jnp.asarray(a) for a in args))
            for a, b in zip(ours, theirs):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    @pytest.mark.parametrize("prefix", [None, [3, 0]])
    @pytest.mark.parametrize("causal", [True, False])
    def test_blockwise_attend_pads_indivisible_kv_len(self, causal, prefix):
        """The blockwise attend pads 37 keys to chunks of 8 with masked
        keys: it matches the reference's ``_xla_attend_lse`` (1e-5)."""
        rs = np.random.RandomState(1)
        q = rs.randn(2, 4, 37, 16).astype(np.float32)
        k = rs.randn(2, 2, 37, 16).astype(np.float32)
        v = rs.randn(2, 2, 37, 16).astype(np.float32)
        pre = None if prefix is None else np.asarray(prefix, np.int32)
        ours = ra.blockwise_attend_lse(
            *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
            scale=0.25, block_k=8,
            prefix=None if pre is None else torch.from_numpy(pre))
        theirs = jax_ra._xla_attend_lse(
            *(jnp.asarray(a) for a in (q, k, v)), causal=causal, scale=0.25,
            block_k=8, prefix=None if pre is None else jnp.asarray(pre))
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)

    def test_blockwise_backward_matches_autograd(self):
        """The blockwise backward given the forward's own lse and delta
        is autograd's gradient of the blockwise attend (f32, 1e-5)."""
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 12, 8, generator=g)
        k = torch.randn(2, 2, 12, 8, generator=g)
        v = torch.randn(2, 2, 12, 8, generator=g)
        w = torch.randn(2, 4, 12, 8, generator=g)
        seg = torch.tensor([[0] * 5 + [1] * 7, [2] * 12], dtype=torch.int32)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = ra.blockwise_attend_lse(*leaves, causal=True, scale=0.3,
                                           block_k=5, seg_q=seg)
        (out * w).sum().backward()
        delta = (w * out.detach()).sum(-1)
        got = ra.blockwise_attend_bwd(q, k, v, w, lse.detach(), delta,
                                      causal=True, scale=0.3, block_k=5,
                                      seg_q=seg)
        for a, b in zip(got, leaves):
            torch.testing.assert_close(a, b.grad, rtol=1e-5, atol=1e-5)

    def test_a_seq_group_of_one_is_the_plain_flash_call(self):
        """No seq mesh (or a seq axis of size 1): the diagonal call
        alone, bit for bit the flash attention the model calls without
        a ring, forward and backward."""
        from dlrover_tpu_torch.ops import flash_attention as fa
        from dlrover_tpu_torch.parallel.mesh import ProcessMesh

        mesh = ProcessMesh(("data", "seq"), (1, 1))
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 4, 16, 8, generator=g).requires_grad_()
                   for _ in range(3))
        seg = torch.tensor([[0] * 7 + [1] * 9])
        for kw, plain in (({}, lambda: fa.flash_attention(q, k, v, True)),
                          ({"segment_ids": seg},
                           lambda: fa.flash_attention_segmented(q, k, v,
                                                                seg))):
            a = ra.ring_attention(q, k, v, mesh, **kw)
            ga = torch.autograd.grad(a.sum(), (q, k, v))
            b = plain()
            gb = torch.autograd.grad(b.sum(), (q, k, v))
            assert torch.equal(a, b)
            assert all(torch.equal(x, y) for x, y in zip(ga, gb))

    def test_tensor_axis_raises(self):
        from dlrover_tpu_torch.parallel.mesh import ProcessMesh

        mesh = ProcessMesh(("seq", "tensor"), (2, 2))
        q = torch.zeros(1, 2, 8, 8)
        with pytest.raises(NotImplementedError, match="A15"):
            ra.ring_attention(q, q, q, mesh)

    def test_prefix_ring_needs_the_host_copy_on_a_card(self):
        """The prefix ring's skips read the prompt lengths on the host:
        a CPU ``prefix_len`` is its own host copy, a meta one attends
        every future shard, and the host copy wins when given."""
        assert ra._host_prefix(torch.tensor([3, 9]), None) == [3, 9]
        assert ra._host_prefix(torch.empty(2, device="meta"), None) is None
        assert ra._host_prefix(torch.tensor([3, 9]), [1, 2]) == [1, 2]

    def test_schedule_skips_on_the_host(self):
        """The causal ring skips future shards; the prefix ring attends
        a future shard only where some row's prompt reaches it."""
        plan = ra.RingPlan(group=None, n=4, my=1, causal=True,
                           impl="flash", scale=1.0, s_local=8)
        assert plan.step(1).mode == "causal"
        assert plan.step(0).mode == "full"
        assert plan.step(2) is None and plan.step(3) is None
        prefix = torch.tensor([12, 3], dtype=torch.int32)
        plan = ra.RingPlan(group=None, n=4, my=0, causal=True,
                           impl="flash", scale=1.0, prefix=prefix,
                           prefix_host=[12, 3], s_local=8)
        assert plan.step(0).mode == "pfx"
        assert plan.step(0).prefix.tolist() == [8, 3]
        bound = plan.step(1)
        assert bound.mode == "bound" and not bound.causal
        assert bound.seg_k.tolist() == [[0] * 4 + [1] * 4, [1] * 8]
        assert plan.step(2) is None and plan.step(3) is None
