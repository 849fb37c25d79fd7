"""Sequence parallelism through the port's step (ROADMAP A13): one AdamW
step of Llama and GLM at (data, fsdp, seq) meshes against the JAX
package's ``accelerate`` at the same ``MeshPlan``.

The reference runs on the JAX CPU devices of ``tests/conftest.py`` (its
ring over ``shard_map``, impl "xla"); the port on two and four gloo CPU
ranks (``tests/torch_seq_workers.py``), from the reference's initial
parameters through ``interop``, on the same global batch: 4 rows of 16
tokens, each seq rank a contiguous block of 8. The variants: Llama tiny
dense (the ring through the flash kernels' plain versions) and packed
with -100 labels at the boundaries (the blockwise attend), GLM tiny
with prompts straddling the shard bound and on it (flash), causal
(blockwise) and packed (flash); every model under its default remat
policy, ``dots_saveable``, so the ring's forward is recomputed in the
backward. Each data row block holds as many labelled tokens (the
port's data-parallel loss is the mean of its row blocks'), while the
two seq halves hold different counts, so the loss's seq-group
denominator is exercised. Tolerances (f32, summation order): the loss
and gradient norm 1e-5 relative, every parameter after the step 1e-4
absolute at lr 1e-2, as ``tests/test_torch_fsdp.py`` holds its meshes.
AdamW's eps is 1e-3 on both sides: the first step then moves an element
by about lr g / (|g| + 1e-3), nearly linear in a small gradient, so the
parameters carry the gradients' values; at eps 1e-8 the step is lr
sign(g), and a gradient of rounding size (GLM's key bias has an exact
gradient of zero: it shifts every score of a row alike) moves a full
lr either way.

Also: the process groups of MeshPlan(data=2, seq=2); a change of world
(2, 1, 2) -> (1, 1, 2) through ``live_reshard`` bit for bit against a
cold trainer; a checkpoint written at (1, 1, 2) restored at (2, 1, 1)
bit for bit; the meta-device count of a seq = 2 rank's step (the ring's
collective-permute bytes, B1-B3's FLOPs over the tiles its schedule
visits); the refusals (A15, A13b, A16c).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import glm as jax_glm
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import glm, llama
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.parallel.mesh import MeshPlan, ProcessMesh
from dlrover_tpu_torch.ops.shard_compat import ambient_mesh
from dlrover_tpu_torch.trainer.run import run_local

import torch_seq_workers as workers

LR, TIMEOUT = 1e-2, 420
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-4
ROWS, S = 4, 16
MESHES = [(1, 1, 2), (2, 1, 2), (1, 2, 2)]
# packed rows: documents at [0, 5), [5, 11), [11, 16) and [0, 3), [3, 6),
# [6, 16), alternating, so each row block holds one of each
LAYOUTS = ([0] * 5 + [1] * 6 + [2] * 5, [0] * 3 + [1] * 3 + [2] * 10)
# prompts straddling the bound at 8 (12), inside (3), on it (8), inside
# (7): each row block labels 19 tokens
PROMPTS = [12, 3, 8, 7]
# (family, the port's config, the reference's config, batch mode)
VARIANTS = {
    "llama": ("llama", {"use_flash": True}, {}, "dense"),
    "llama_packed": ("llama", {}, {}, "packed"),
    "glm_prefix": ("glm", {"use_flash": True}, {}, "prefix"),
    "glm_causal": ("glm", {}, {}, "dense"),
    "glm_packed": ("glm", {"use_flash": True}, {}, "packed"),
}


def _batch(mode, seed):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, size=(ROWS, S + 1))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    if mode == "packed":
        seg = np.asarray([LAYOUTS[r % 2] for r in range(ROWS)], np.int32)
        batch["segment_ids"] = seg
        batch["labels"][:, :-1][seg[:, :-1] != seg[:, 1:]] = -100
    elif mode == "prefix":
        batch["prefix_len"] = np.asarray(PROMPTS, np.int32)
        for r, p in enumerate(PROMPTS):
            batch["labels"][r, :max(p - 1, 0)] = -100
    return batch


def _family(kind):
    return (jax_llama, jax_llama.llama_tiny) if kind == "llama" else (
        jax_glm, jax_glm.glm_tiny)


def _jax_step(kind, jkw, batch, mesh):
    family, tiny = _family(kind)
    jcfg = tiny(seq_axis="seq", **jkw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    result = jax_accelerate(
        family.make_init_fn(jcfg), family.make_loss_fn(jcfg),
        optax.adamw(LR, eps=workers.STEP_EPS, weight_decay=0.1), jbatch,
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=mesh[0], fsdp=mesh[1],
                                              seq=mesh[2]), rule_set=kind),
        devices=jax.devices()[:int(np.prod(mesh))])
    state = result.init_fn(jax.random.PRNGKey(0))
    tree = jax.device_get(state.params)
    state, m = result.train_step(state, result.shard_batch(jbatch),
                                 jax.random.PRNGKey(0))
    return {"tree": tree, "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "params": jax.device_get(state.params)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): np.asarray(tree)}


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    batches = {name: _batch(v[3], i) for i, (name, v) in
               enumerate(VARIANTS.items())}
    want, runs = {}, {}
    for name, (kind, kw, jkw, _) in VARIANTS.items():
        for mesh in MESHES:
            want[(name, mesh)] = _jax_step(kind, jkw, batches[name], mesh)
            runs[(name, mesh)] = (kind, {"seq_axis": "seq", **kw},
                                  want[(name, mesh)]["tree"], batches[name],
                                  mesh)
    tree = want[("llama", (1, 1, 2))]["tree"]
    # the layer prefetch at (1, 2, 2): each layer's parameters taken from
    # the source (the other rank's layer broadcast) inside its block
    runs[("llama_prefetch", (1, 2, 2))] = (
        "llama", {"seq_axis": "seq", "use_flash": True,
                  "fsdp_prefetch": True}, tree, batches["llama"], (1, 2, 2))
    # the fp8 FSDP wire at (1, 2, 2), against its bitwise reference
    for precision in ("fp8", "fp8_qdq"):
        runs[(f"llama_{precision}", (1, 2, 2))] = (
            "llama", {"seq_axis": "seq", "use_flash": True,
                      "fsdp_precision": precision}, tree, batches["llama"],
            (1, 2, 2))
    dense = {"seq_axis": "seq", "remat_policy": "none"}
    wc_batches = [_batch("dense", 10 + i) for i in range(3)]
    ckpt = str(tmp_path_factory.mktemp("seq") / "ckpt")
    meta_kw = {"seq_axis": "seq", "use_flash": True}
    two = run_local(workers.two_ranks, 2,
                    (runs, LR, tree, dense, batches["llama"], ckpt, meta_kw,
                     batches["glm_prefix"]), timeout=TIMEOUT)
    four = run_local(workers.four_ranks, 4,
                     (runs, LR, tree, dense, wc_batches,
                      str(tmp_path_factory.mktemp("seq4") / "ckpt")),
                     timeout=TIMEOUT)
    return {"want": want, "two": two, "four": four, "meta_kw": meta_kw,
            "batches": batches}


def _ranks(seq, mesh):
    return seq["two"] if int(np.prod(mesh)) == 2 else seq["four"]


class TestOneStepAgainstTheReference:
    @pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
        map(str, m)))
    @pytest.mark.parametrize("name", sorted(VARIANTS))
    def test_loss_and_parameters_match_the_jax_accelerate(self, seq, name,
                                                          mesh):
        want = seq["want"][(name, mesh)]
        flat = _flat(want["params"])
        for r in _ranks(seq, mesh):
            run = r["runs"][(name, mesh)]
            np.testing.assert_allclose(run["loss"], want["loss"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(run["grad_norm"], want["grad_norm"],
                                       rtol=LOSS_RTOL)
            ours = {k[len("params/"):]: v for k, v in run["state"].items()
                    if k.startswith("params/")}
            assert sorted(ours) == sorted(flat)
            for path, leaf in flat.items():
                np.testing.assert_allclose(ours[path], leaf, rtol=0,
                                           atol=PARAM_ATOL, err_msg=path)
            # the step moved every rank's parameters the same way
            assert run["sizes"] == {"data": mesh[0], "fsdp": mesh[1],
                                    "seq": mesh[2]}

    @pytest.mark.parametrize("name", sorted(VARIANTS))
    def test_the_step_moves_the_parameters(self, seq, name):
        """The tolerance is well under what one AdamW step moves."""
        want = seq["want"][(name, (1, 1, 2))]
        before, after = _flat(want["tree"]), _flat(want["params"])
        moved = max(float(np.abs(after[p] - before[p]).max())
                    for p in before)
        assert moved > 50 * PARAM_ATOL

    def test_the_layer_prefetch_equals_the_whole_tree_step(self, seq):
        """The layer prefetch at (1, 2, 2) (the ring's exchanges under
        the source's) is the whole-tree step bit for bit."""
        for r in seq["four"]:
            a = r["runs"][("llama_prefetch", (1, 2, 2))]
            b = r["runs"][("llama", (1, 2, 2))]
            assert a["loss"] == b["loss"]
            assert all(np.array_equal(a["state"][k], b["state"][k])
                       for k in b["state"])
            assert a["stats"]["broadcast"]["calls"] > 0

    def test_the_fp8_wire_under_the_ring_is_fp8_qdq_bit_for_bit(self, seq):
        """The fp8 FSDP wire composes with the ring at (1, 2, 2): fp8
        (e4m3 values and scales gathered) equals fp8_qdq (the decode
        gathered at full precision), loss and state, bit for bit."""
        for r in seq["four"]:
            a = r["runs"][("llama_fp8", (1, 2, 2))]
            b = r["runs"][("llama_fp8_qdq", (1, 2, 2))]
            assert a["loss"] == b["loss"]
            assert all(np.array_equal(a["state"][k], b["state"][k])
                       for k in b["state"])
            assert a["loss"] != r["runs"][("llama", (1, 2, 2))]["loss"]

    def test_the_seq_ranks_report_one_loss(self, seq):
        for mesh in MESHES:
            losses = {r["runs"][("llama_packed", mesh)]["loss"]
                      for r in _ranks(seq, mesh)}
            assert len(losses) == 1

    def test_eval_loss_is_the_rows_loss(self, seq):
        """The eval step's loss after the step is the same on every rank
        and at every mesh (1e-5 relative)."""
        for name in VARIANTS:
            evals = [r["runs"][(name, mesh)]["eval"] for mesh in MESHES
                     for r in _ranks(seq, mesh)]
            np.testing.assert_allclose(evals, evals[0], rtol=LOSS_RTOL)

    def test_ring_exchange_bytes_per_step(self, seq):
        """Each rank's shifts in one dense Llama step at (1, 1, 2), by
        the module's formula: a layer's forward sends its K/V once
        (n - 1 = 1 hop), the remat recompute once more, the backward
        once with its K/V and twice (n hops) with the f32 dK/dV."""
        c = llama.llama_tiny()
        kv = 2 * ROWS * c.num_kv_heads * (S // 2) * c.head_dim * 4
        want = c.num_layers * (kv + kv + kv + 2 * kv)
        for r in seq["two"]:
            stats = r["runs"][("llama", (1, 1, 2))]["stats"]["ring_shift"]
            assert stats["bytes"] == want
            assert stats["calls"] == c.num_layers * 5


class TestMesh:
    def test_groups_of_data_by_seq(self, seq):
        """MeshPlan(data=2, seq=2) over four ranks: seq innermost, so a
        rank's seq group is its pair of consecutive ranks, its data
        group its stride-2 pair; a second build reuses the groups."""
        for r in seq["four"]:
            g, rank = r["groups"], r["rank"]
            assert g["sizes"]["seq"] == 2 and g["sizes"]["data"] == 2
            assert g["groups"][("seq",)] == [rank // 2 * 2, rank // 2 * 2 + 1]
            assert g["groups"][("data",)] == [rank % 2, rank % 2 + 2]
            assert g["groups"][("data", "seq")] == [0, 1, 2, 3]
            assert g["groups"][("fsdp",)] is None
            assert g["reused"]

    def test_build_refuses_pipe_and_tensor_and_takes_seq(self):
        for kw in ({"tensor": 2}, {"pipe": 2}):
            with pytest.raises(NotImplementedError, match="A15"):
                MeshPlan(data=1, **kw).build(2)
        mesh = MeshPlan(data=1, seq=2).build(2)
        assert mesh.sizes["seq"] == 2 and mesh.groups == {}

    def test_world_change_keeping_seq_is_the_cold_path(self, seq):
        """(2, 1, 2) -> (1, 1, 2) through live_reshard: the survivors go
        on bit for bit as a trainer built cold for the new world from
        the same snapshot; ranks 2 and 3 leave."""
        for r in seq["four"]:
            wc = r["world_change"]
            assert wc["mesh_before"] == {"data": 2, "fsdp": 1, "seq": 2}
            if r["rank"] >= 2:
                assert wc["left"]
                continue
            assert wc["mesh_after"] == {"data": 1, "fsdp": 1, "seq": 2}
            assert wc["accum_after"] == 2
            assert wc["live"] == wc["cold"]
            assert all(np.array_equal(wc["live_state"][k],
                                      wc["cold_state"][k])
                       for k in wc["cold_state"])

    @pytest.mark.parametrize("ranks,mesh", [
        ("two", {"data": 1, "fsdp": 1, "seq": 2}),
        ("four", {"data": 1, "fsdp": 2, "seq": 2})], ids=["1x1x2", "1x2x2"])
    def test_checkpoint_at_a_seq_mesh_restores_without_seq(self, seq, ranks,
                                                           mesh):
        """Written at (1, 1, 2), restored at (2, 1, 1); written at (1, 2,
        2), whose fsdp blocks each have a replica on both seq ranks,
        restored at (2, 2, 1): every tensor bit for bit."""
        for r in seq[ranks]:
            ck = r["checkpoint"]
            assert ck["mesh"] == mesh
            assert ck["step"] == 1
            assert sorted(ck["restored"]) == sorted(ck["saved"])
            for k in ck["saved"]:
                np.testing.assert_array_equal(ck["restored"][k],
                                              ck["saved"][k], err_msg=k)


class TestMetaCount:
    def test_ring_bytes_and_kernel_flops_follow_the_schedule(self, seq):
        """The meta-device count of a seq = 2 rank's step (Llama tiny,
        flash, remat dots_saveable): collective-permute bytes by the
        formula; B1-B3's FLOPs those of the tiles the rank attends: the
        diagonal's causal pairs, and on rank 1 the past shard's full
        block (B1 twice: the recompute)."""
        c = llama.llama_tiny()
        s = S // 2
        kv = 2 * ROWS * c.num_kv_heads * s * c.head_dim * 4
        causal, full = ROWS * s * (s + 1) // 2, ROWS * s * s
        for r in seq["two"]:
            meta = r["meta"]
            assert meta["collective"]["collective-permute"] == \
                c.num_layers * 5 * kv
            pairs = causal + (full if r["rank"] == 1 else 0)
            hd = c.num_heads * c.head_dim
            want = {"flash_fwd": 2 * 4 * hd * pairs,
                    "flash_bwd_dkv": 8 * hd * pairs,
                    "flash_bwd_dq": 6 * hd * pairs}
            for name, flops in want.items():
                assert meta["kernels"][name]["flops"] == \
                    c.num_layers * flops, name
            assert meta["kernels"]["flash_fwd"]["calls"] == \
                c.num_layers * 2 * (1 + r["rank"])

    def test_the_prefix_ring_counts_on_the_meta_device(self, seq):
        """GLM's prefix ring on the meta device (the prompts' host copy
        has no values there): every future shard attended, an upper
        bound; the shifts by the formula (no ids ride the prefix ring);
        rank 0's bound step through the pair-segmented kernels."""
        c = glm.glm_tiny()
        kv = 2 * ROWS * c.num_heads * (S // 2) * c.head_dim * 4
        for r in seq["two"]:
            meta = r["meta_glm"]
            assert meta["collective"]["collective-permute"] == \
                c.num_layers * 5 * kv
            assert meta["kernels"]["flash_fwd_pfx"]["calls"] == \
                c.num_layers * 2
            other = "flash_fwd_seg" if r["rank"] == 0 else "flash_fwd"
            assert meta["kernels"][other]["calls"] == c.num_layers * 2


class TestRefusals:
    def test_moe_under_seq_names_a13b(self):
        cfg = llama.llama_tiny(seq_axis="seq", num_experts=4,
                               moe_dispatch="grouped")
        with pytest.raises(NotImplementedError, match="A13b"):
            llama.apply({}, torch.zeros((1, 4), dtype=torch.long), cfg)

    def test_prefill_sequence_under_seq_names_a16c(self):
        cfg = llama.llama_tiny(seq_axis="seq")
        with pytest.raises(NotImplementedError, match="A16c"):
            llama.prefill_sequence({}, {}, torch.zeros(4, dtype=torch.long),
                                   0, cfg, None)

    def test_a_split_sequence_needs_the_ring(self):
        """A mesh splitting the rows' tokens under a config without
        ``seq_axis`` raises instead of attending within each block."""
        cfg = llama.llama_tiny()
        params = llama.init(torch.Generator().manual_seed(0), cfg)
        mesh = ProcessMesh(("data", "seq"), (1, 2))
        with ambient_mesh(mesh), pytest.raises(ValueError,
                                               match="seq_axis"):
            llama.apply(params, torch.zeros((1, 4), dtype=torch.long), cfg)

    def test_packed_rows_under_the_ring_need_global_positions(self):
        from dlrover_tpu_torch.ops.ring_attention import seq_positions

        mesh = ProcessMesh(("data", "seq"), (1, 2), rank=1)
        with ambient_mesh(mesh):
            assert seq_positions(1, 4, "seq", "cpu").tolist() == [
                [4, 5, 6, 7]]
            with pytest.raises(ValueError, match="positions"):
                seq_positions(1, 4, "seq", "cpu",
                              segment_ids=torch.zeros(1, 4))


def test_llama_seq_axis_without_a_seq_mesh_is_the_plain_model():
    """``seq_axis`` with no seq mesh around (one device) changes
    nothing: the flash path bit for bit."""
    cfg = llama.llama_tiny(use_flash=True, remat_policy="none")
    params = llama.init(torch.Generator().manual_seed(0), cfg)
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    a, _ = llama.apply(params, ids, dataclasses.replace(cfg,
                                                        seq_axis="seq"))
    b, _ = llama.apply(params, ids, cfg)
    assert torch.equal(a, b)
    assert fa.launch_counts()["flash_fwd"] == 0  # the CPU's plain version


def test_the_example_trains_with_a_ring_of_two():
    """``train_llama --ring 2`` on two gloo CPU ranks: one ring, the
    mesh (1, 1, 2), finite losses, the same on both ranks."""
    argv = ["--preset", "tiny", "--steps", "3", "--batch", "2", "--seq",
            "16", "--ring", "2", "--device", "cpu"]
    got = run_local(workers.example_ranks, 2, (argv,), timeout=TIMEOUT)
    for r in got:
        assert r["step"] == 3
        assert r["mesh"]["seq"] == 2 and r["mesh"]["data"] == 1
        assert len(r["losses"]) == 3 and np.all(np.isfinite(r["losses"]))
    assert got[0]["losses"] == got[1]["losses"]
