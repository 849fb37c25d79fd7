"""Meta-device init in the port against the JAX package's
``utils/meta_init.py``: abstract trees and their stats (equal to the
reference's ``param_stats(abstract_init(...))`` exactly, in parameters
and bytes), leaf-by-leaf materialization, a checkpoint loaded straight
into empty tensors (bit for bit), and the wrappers' meta path (empty
outputs of the right shapes, nothing launched, no plain version run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.utils import meta_init as jax_meta
from dlrover_tpu_torch.checkpoint import (
    CheckpointInterval,
    ElasticCheckpointManager,
)
from dlrover_tpu_torch.checkpoint.manager import state_tensors
from dlrover_tpu_torch.examples import train_llama as example
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import grouped_matmul as gm
from dlrover_tpu_torch.parallel.accelerate import TrainState, accelerate
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.utils.meta_init import (
    abstract_init,
    default_leaf_init,
    materialize_from_checkpoint,
    materialize_leaf_by_leaf,
    on_meta,
    param_stats,
)


def _init_fn(gen):
    return {
        "w": torch.randn(16, 8, generator=gen),
        "b": torch.zeros(8),
        "emb": torch.randn(32, 16, generator=gen, dtype=torch.bfloat16),
    }


def _jax_init_fn(rng):
    k1, k2 = jax.random.split(rng)
    return {"w": jax.random.normal(k1, (16, 8)), "b": jnp.zeros((8,)),
            "emb": jax.random.normal(k2, (32, 16), jnp.bfloat16)}


class TestAbstractInit:
    def test_no_allocation_and_stats(self):
        abstract = abstract_init(_init_fn)
        assert all(t.device.type == "meta" for t in tree_leaves(abstract))
        assert abstract["w"].shape == (16, 8)
        assert param_stats(abstract) == jax_meta.param_stats(
            jax_meta.abstract_init(_jax_init_fn))
        assert param_stats(abstract) == {
            "params": 16 * 8 + 8 + 32 * 16,
            "bytes": (16 * 8 + 8) * 4 + 32 * 16 * 2}

    @pytest.mark.parametrize("kw", [
        {}, {"num_experts": 4, "moe_top_k": 2},
        {"num_layers": 3, "num_kv_heads": 4},
    ], ids=["dense", "moe", "mha"])
    def test_llama_stats_equal_the_reference(self, kw):
        ours = param_stats(abstract_init(llama.make_init_fn(
            llama.llama_tiny(**kw))))
        theirs = jax_meta.param_stats(jax_meta.abstract_init(
            lambda r: jax_llama.init(r, jax_llama.llama_tiny(**kw))))
        assert ours == theirs
        assert ours["params"] == llama.param_count(llama.llama_tiny(**kw))

    def test_llama3_8b_costs_nothing(self):
        """Full width, all 32 layers: 8.03 B parameters, on meta."""
        cfg = llama.llama3_8b()
        abstract = abstract_init(llama.make_init_fn(cfg))
        stats = param_stats(abstract)
        assert stats["params"] == llama.param_count(cfg)
        assert stats["bytes"] == 4 * stats["params"]  # f32 params
        assert all(t.device.type == "meta" for t in tree_leaves(abstract))

    def test_a_train_state_and_its_optimizer_on_meta(self):
        cfg = llama.llama_tiny()
        batch = next(example.synthetic_batches(cfg.vocab_size, 2, 8)())
        result = accelerate(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                            example.adamw(), batch, device="cpu")
        state = abstract_init(result.init_fn, 0)
        assert isinstance(state, TrainState) and state.step == 0
        leaves = tree_leaves(state.params)
        assert all(t.device.type == "meta" and t.requires_grad
                   for t in leaves)
        group = state.opt_state.param_groups[0]["params"]
        assert [id(p) for p in group] == [id(p) for p in leaves]

    def test_moves_and_generators_stay_on_meta(self):
        gen = torch.Generator().manual_seed(0)
        state = gen.get_state().clone()
        with on_meta():
            t = torch.randn(4, 4, generator=gen, device="cpu")
            assert t.to("cpu").device.type == "meta"
            assert t.cpu().device.type == "meta"
            assert t.to(torch.float16).dtype == torch.float16
            assert torch.zeros(3).device.type == "meta"
        with on_meta(all_factories=False):
            assert torch.zeros(3).device.type == "cpu"
            assert torch.tensor(0.0, device="cpu").device.type == "cpu"
            assert torch.ones(2, device="cuda").device.type == "meta"
        # nothing was drawn from the generator
        assert torch.equal(state, gen.get_state())


class TestMaterialize:
    def test_leaf_by_leaf_shapes_and_dtypes(self):
        abstract = abstract_init(_init_fn)
        tree = materialize_leaf_by_leaf(abstract, device="cpu")
        assert tree["w"].shape == (16, 8) and tree["w"].device.type == "cpu"
        assert tree["emb"].dtype == torch.bfloat16
        assert float(tree["w"].abs().sum()) > 0  # matrices randomized
        assert float(tree["b"].abs().sum()) == 0  # vectors zeroed
        again = materialize_leaf_by_leaf(abstract, device="cpu")
        for a, b in zip(tree_leaves(tree), tree_leaves(again)):
            assert torch.equal(a, b)  # one explicit generator, seeded

    def test_the_generator_is_explicit(self):
        abstract = abstract_init(_init_fn)
        one = materialize_leaf_by_leaf(
            abstract, device="cpu",
            generator=torch.Generator().manual_seed(1))
        two = materialize_leaf_by_leaf(
            abstract, device="cpu",
            generator=torch.Generator().manual_seed(2))
        assert not torch.equal(one["w"], two["w"])

    def test_a_module_goes_through_to_empty(self):
        with on_meta():
            module = torch.nn.Sequential(torch.nn.Linear(8, 4),
                                         torch.nn.Linear(4, 2))
        assert next(module.parameters()).device.type == "meta"
        out = materialize_leaf_by_leaf(module, default_leaf_init,
                                       device="cpu")
        assert out is module
        assert module[0].weight.device.type == "cpu"
        assert float(module[0].bias.abs().sum()) == 0
        assert module(torch.ones(1, 8)).shape == (1, 2)

    def test_custom_leaf_init(self):
        abstract = abstract_init(_init_fn)
        tree = materialize_leaf_by_leaf(
            abstract, lambda gen, leaf: leaf.fill_(3), device="cpu")
        assert torch.all(tree["emb"] == 3)

    def test_from_checkpoint_bit_for_bit_with_no_init(self, tmp_path,
                                                      monkeypatch):
        cfg = llama.llama_tiny()
        batch = next(example.synthetic_batches(cfg.vocab_size, 2, 8)())
        trainer = ElasticTrainer(
            llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
            example.adamw(), batch, device="cpu", ckpt_dir=str(tmp_path),
            ckpt_interval=CheckpointInterval(steps=2))
        state = trainer.prepare()
        for _ in range(2):
            state, _ = trainer.step(state, batch)
        trainer.finalize()
        saved, _ = state_tensors(state)
        abstract = abstract_init(llama.make_init_fn(cfg))
        # no init runs: the model's initializer is off limits from here
        monkeypatch.setattr(llama, "init", _fail)
        manager = ElasticCheckpointManager(str(tmp_path), async_save=False)
        got = materialize_from_checkpoint(manager, abstract,
                                          example.adamw(), device="cpu")
        assert got.step == 2
        loaded, _ = state_tensors(got)
        assert sorted(loaded) == sorted(saved)
        for name in saved:
            a = saved[name].detach().reshape(-1)
            b = loaded[name].detach().reshape(-1)
            assert a.dtype == b.dtype and torch.equal(
                a.view(torch.uint8), b.view(torch.uint8)), name
        # it steps on from there
        got, metrics = trainer.accelerated.train_step(
            got, trainer.accelerated.shard_batch(batch),
            torch.Generator().manual_seed(0))
        assert np.isfinite(float(metrics["loss"]))
        empty = ElasticCheckpointManager(str(tmp_path / "none"),
                                         async_save=False)
        assert materialize_from_checkpoint(empty, abstract, example.adamw(),
                                           device="cpu") is None


def _fail(*args, **kwargs):
    raise AssertionError("a plain version ran on the meta device")


class TestWrappersOnMeta:
    def test_flash_returns_empty_outputs_and_runs_nothing(self,
                                                          monkeypatch):
        for name in ("flash_fwd_plain", "flash_bwd_dkv_plain",
                     "flash_bwd_dq_plain"):
            monkeypatch.setattr(fa, name, _fail)
        fa.reset_launch_counts()
        q = torch.empty(2, 8, 256, 64, device="meta", dtype=torch.bfloat16)
        k = torch.empty(2, 2, 256, 64, device="meta", dtype=torch.bfloat16)
        rows = torch.empty(2, 8, 256, device="meta")
        out, lse = fa.flash_fwd(q, k, k, True, 0.125)
        assert (out.shape, out.dtype, lse.shape, lse.dtype) == (
            q.shape, q.dtype, rows.shape, torch.float32)
        dk, dv = fa.flash_bwd_dkv(q, k, k, q, rows, rows, True, 0.125)
        assert dk.shape == dv.shape == k.shape
        assert fa.flash_bwd_dq(q, k, k, q, rows, rows, True,
                               0.125).shape == q.shape
        qg = q.float().requires_grad_()
        kg = k.float().requires_grad_()
        out, lse = fa.flash_attention_lse(qg, kg, kg, True)
        (out.sum() + lse.sum()).backward()
        assert qg.grad.shape == q.shape and kg.grad.shape == k.shape
        assert sum(fa.launch_counts().values()) == 0

    def test_grouped_returns_empty_outputs_and_runs_nothing(self,
                                                            monkeypatch):
        for name in ("grouped_matmul_fwd_plain", "grouped_matmul_dw_plain",
                     "grouped_matmul_fwd_quant_plain"):
            monkeypatch.setattr(gm, name, _fail)
        x = torch.empty(256, 16, device="meta", dtype=torch.bfloat16,
                        requires_grad=True)
        w = torch.empty(2, 16, 32, device="meta", dtype=torch.bfloat16,
                        requires_grad=True)
        te = torch.empty(2, device="meta", dtype=torch.int32)
        y = gm.grouped_matmul(x, w, te)
        assert y.shape == (256, 32) and y.dtype == torch.bfloat16
        y.sum().backward()
        assert x.grad.shape == x.shape and w.grad.shape == w.shape
        values = torch.empty(256, 16, device="meta",
                             dtype=torch.float8_e4m3fn)
        scales = torch.empty(256, 2, device="meta")
        yq = gm.grouped_matmul_fwd_quant(values, scales, w.float(), te)
        assert yq.shape == (256, 32) and yq.dtype == torch.float32
        assert sum(gm.launch_counts().values()) == 0


def test_default_leaf_init_matches_the_reference_rule():
    """Fan-in-scaled normal for matrices (std 1/sqrt(shape[-2])), zeros
    for vectors, as the reference's ``default_leaf_init``."""
    gen = torch.Generator().manual_seed(0)
    big = default_leaf_init(gen, torch.empty(4096, 64))
    assert float(big.std()) == pytest.approx(1 / 64, rel=0.02)
    ref = jax_meta.default_leaf_init(
        jax.random.PRNGKey(0), jax.ShapeDtypeStruct((4096, 64), jnp.float32))
    assert float(jnp.std(ref)) == pytest.approx(1 / 64, rel=0.02)
    assert torch.all(default_leaf_init(gen, torch.ones(7)) == 0)
