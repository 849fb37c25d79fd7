"""The port's GLM against the JAX package's, through ``interop``.

The JAX parameters (``glm.init`` from a PRNG key) are converted to the
port's tree; both packages then run the same token ids and prefix
lengths. ``glm_tiny`` computes in f32, so the tolerances are
summation-order ones: 2e-5 on logits, loss and gradients (absolute and
relative), 1e-6 on elementwise pieces, 1e-4 relative on a five-step
loss trajectory. On the flash path the JAX kernels run in Pallas
interpret mode and the port's wrappers take their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import common as jax_common
from dlrover_tpu.models import glm as jax_glm
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.examples import train_glm_prefix as example
from dlrover_tpu_torch.models import common, glm
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.parallel import strategy

TOL = 2e-5


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


def _jax_params(cfg, seed=0):
    return jax.device_get(jax_glm.init(jax.random.PRNGKey(seed), cfg))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _batch(mode, b=2, s=32, vocab=256, seed=0):
    """Token ids and labels, and the mode's extra: prefix lengths [10, 0]
    (one prompt row, one causal row), segment ids, or none."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, size=(b, s + 1))
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:].copy()}
    if mode == "prefix":
        batch["prefix_len"] = np.asarray([10, 0], np.int32)
        batch["labels"][0, :9] = -100  # the loss on the response only
    elif mode == "segments":
        seg = np.repeat(np.asarray([[0, 1, 2, 2], [5, 5, 6, 7]]), s // 4,
                        axis=1).astype(np.int32)
        batch["segment_ids"] = seg
        batch["labels"][:, :-1][seg[:, :-1] != seg[:, 1:]] = -100
    return batch


class TestPieces:
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                             ids=["f32", "bf16"])
    def test_layer_norm_matches(self, dtype):
        rs = np.random.RandomState(1)
        x = (3 + 2 * rs.randn(3, 64)).astype(np.float32)
        scale = (1 + 0.1 * rs.randn(64)).astype(np.float32)
        bias = (0.1 * rs.randn(64)).astype(np.float32)
        tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        out = common.layer_norm(torch.from_numpy(x).to(tdtype),
                                torch.from_numpy(scale),
                                torch.from_numpy(bias), 1e-5)
        ref = jax_common.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                                    jnp.asarray(bias), 1e-5)
        assert out.dtype == tdtype
        # f32: summation order; bf16: the same cast points, so at most
        # one bf16 rounding of each of the two products apart
        tol = 1e-6 if dtype == jnp.float32 else 2 ** -6
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32), rtol=tol,
                                   atol=tol)

    def test_positions_match_bitwise(self):
        prefix = np.asarray([0, 1, 17, 40], np.int32)
        pos, block = glm.glm_positions(40, torch.from_numpy(prefix))
        jpos, jblock = jax_glm.glm_positions(40, jnp.asarray(prefix))
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(block.numpy(), np.asarray(jblock))

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                             ids=["f32", "bf16"])
    def test_prefix_lm_bias_matches_bitwise(self, dtype):
        """In bf16 the reference's finfo(float32).min rounds to -inf;
        the port's bias holds the same bits."""
        prefix = np.asarray([0, 5, 24], np.int32)
        tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        bias = glm.prefix_lm_bias(24, torch.from_numpy(prefix), tdtype)
        ref = np.asarray(jax_glm.prefix_lm_bias(24, jnp.asarray(prefix),
                                                dtype), np.float32)
        assert bias.dtype == tdtype and bias.shape == (3, 1, 24, 24)
        np.testing.assert_array_equal(bias.float().numpy(), ref)
        if dtype == jnp.bfloat16:
            assert np.isneginf(ref).any()

    @pytest.mark.parametrize("name", ["glm_large", "glm_10b", "glm_tiny"])
    def test_param_count_matches(self, name):
        assert (glm.param_count(getattr(glm, name)())
                == jax_glm.param_count(getattr(jax_glm, name)()))


class TestInterop:
    def test_round_trip_is_bitwise_f32(self):
        tree = _jax_params(jax_glm.glm_tiny())
        back = interop.params_to_numpy(
            interop.params_from_numpy(tree, device="cpu"))
        flat, flat_back = _flatten(tree), _flatten(back)
        assert flat.keys() == flat_back.keys()
        for key, a in flat.items():
            assert flat_back[key].dtype == np.float32
            np.testing.assert_array_equal(flat_back[key], a)

    def test_layout_matches_the_reference(self):
        jax_shapes = {k: v.shape for k, v in
                      _flatten(_jax_params(jax_glm.glm_tiny())).items()}
        port = glm.init(torch.Generator().manual_seed(0), glm.glm_tiny())
        assert {k: tuple(v.shape) for k, v in _flatten(port).items()} \
            == jax_shapes

    def test_glm_rules_replicate_every_leaf(self):
        """On a data-parallel mesh (no fsdp axis to shard over) the glm
        rules replicate every leaf."""
        tree = _flatten(_jax_params(jax_glm.glm_tiny()))
        rules = strategy.Strategy(rule_set="glm").rules()
        sizes = {"data": 4, "fsdp": 1}
        assert not any(any(rules.spec_for(key.lstrip("/"), leaf.shape, sizes))
                       for key, leaf in tree.items())


class TestGLMAgainstJax:
    @pytest.mark.parametrize("mode", ["prefix", "causal", "segments"])
    @pytest.mark.parametrize("jax_flash", [False, True],
                             ids=["jax_reference_attn",
                                  "jax_flash_interpret"])
    def test_logits_loss_and_grads(self, mode, jax_flash):
        """The port's flash path (the plain versions of the kernels'
        three modes) against the JAX flash path in interpret mode and
        against the JAX reference path (in prefix mode its S x S bias):
        logits, the loss of ``make_loss_fn`` and every gradient."""
        jcfg = jax_glm.glm_tiny(use_flash=jax_flash, flash_interpret=True,
                                flash_block_q=16, flash_block_k=16)
        tree = _jax_params(jcfg)
        batch = _batch(mode)
        jparams = jax.tree.map(jnp.asarray, tree)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jlogits = jax_glm.apply(jparams, jbatch["input_ids"], jcfg,
                                prefix_len=jbatch.get("prefix_len"),
                                segment_ids=jbatch.get("segment_ids"))
        (jloss, _), jgrads = jax.value_and_grad(
            jax_glm.make_loss_fn(jcfg), has_aux=True)(
                jparams, jbatch, jax.random.PRNGKey(0))

        cfg = glm.glm_tiny(use_flash=True)
        params = interop.params_from_numpy(tree, device="cpu")
        for t in tree_leaves(params):
            t.requires_grad_()
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        fa.reset_launch_counts()
        logits = glm.apply(params, tbatch["input_ids"], cfg,
                           prefix_len=tbatch.get("prefix_len"),
                           segment_ids=tbatch.get("segment_ids"))
        assert logits.dtype == torch.float32
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=TOL, rtol=TOL)
        loss, aux = glm.make_loss_fn(cfg)(params, tbatch, None)
        assert aux == {}
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
        loss.backward()
        assert set(fa.launch_counts().values()) == {0}  # the CPU path
        flat_j = _flatten(jax.device_get(jgrads))
        flat_p = _flatten(params)
        assert flat_j.keys() == flat_p.keys()
        for key, jg in flat_j.items():
            np.testing.assert_allclose(
                flat_p[key].grad.numpy(), jg, atol=TOL, rtol=TOL,
                err_msg=key)

    def test_reference_path_matches_the_flash_path(self):
        """The port's own two paths on a prefix batch: the S x S bias
        over the reference attention against the prefix-LM flash mode."""
        cfg = glm.glm_tiny()
        params = glm.init(torch.Generator().manual_seed(2), cfg)
        tbatch = {k: torch.from_numpy(v)
                  for k, v in _batch("prefix", seed=3).items()}
        ref = glm.apply(params, tbatch["input_ids"], cfg,
                        prefix_len=tbatch["prefix_len"])
        flash = glm.apply(params, tbatch["input_ids"],
                          dataclasses.replace(cfg, use_flash=True),
                          prefix_len=tbatch["prefix_len"])
        np.testing.assert_allclose(flash.numpy(), ref.numpy(), atol=TOL,
                                   rtol=TOL)

    def test_prompt_does_not_see_the_response(self):
        """Changing a response token leaves the prompt's logits exactly
        as they were: the prompt attends within itself only."""
        cfg = glm.glm_tiny(use_flash=True, remat_policy="none")
        params = glm.init(torch.Generator().manual_seed(4), cfg)
        batch = _batch("prefix", seed=5)
        ids = torch.from_numpy(batch["input_ids"])
        p = torch.from_numpy(batch["prefix_len"])
        base = glm.apply(params, ids, cfg, prefix_len=p)
        moved_ids = ids.clone()
        moved_ids[0, 20] = (moved_ids[0, 20] + 1) % cfg.vocab_size
        moved = glm.apply(params, moved_ids, cfg, prefix_len=p)
        assert torch.equal(moved[0, :10], base[0, :10])
        assert not torch.equal(moved[0, 20:], base[0, 20:])

    def test_prefix_and_segments_together_raise(self):
        cfg = glm.glm_tiny()
        params = glm.init(torch.Generator().manual_seed(0), cfg)
        batch = _batch("segments")
        with pytest.raises(ValueError, match="mutually exclusive"):
            glm.apply(params, torch.from_numpy(batch["input_ids"]), cfg,
                      prefix_len=torch.tensor([3, 4]),
                      segment_ids=torch.from_numpy(batch["segment_ids"]))


class TestTrajectory:
    def test_five_steps_match_the_jax_example(self):
        """The examples' batch (``synth_instruction_batch``, seq 64,
        batch 8, seed 0), the same init (the JAX state's tree through
        interop) and Adam(2e-3) through each package's ``accelerate``:
        the per-step losses agree to 1e-4 relative (f32; Adam's
        normalised update can lift last-bit gradient differences near
        zero)."""
        steps, batch_rows, seq = 5, 8, 64
        batch = example.synth_instruction_batch(256, batch_rows, seq, 0)
        jcfg = jax_glm.glm_tiny(max_seq_len=seq, use_flash=True,
                                flash_interpret=True)
        result = jax_accelerate(
            jax_glm.make_init_fn(jcfg), jax_glm.make_loss_fn(jcfg),
            optax.adam(2e-3), {k: jnp.asarray(v) for k, v in batch.items()},
            strategy=JaxStrategy(mesh=JaxMeshPlan(data=-1), rule_set="glm"),
        )
        state = result.init_fn(jax.random.PRNGKey(0))
        tree = jax.device_get(state.params)
        sharded = result.shard_batch({k: jnp.asarray(v)
                                      for k, v in batch.items()})
        jlosses = []
        for step in range(steps):
            state, m = result.train_step(state, sharded,
                                         jax.random.PRNGKey(step))
            jlosses.append(float(m["loss"]))

        cfg = glm.glm_tiny(max_seq_len=seq, use_flash=True)
        losses = example.train(
            cfg, batch, steps, "cpu",
            init_fn=lambda gen: interop.params_from_numpy(tree, "cpu"))
        assert len(losses) == steps
        assert losses[-1] < losses[0]
        np.testing.assert_allclose(losses, jlosses, rtol=1e-4)

    def test_example_runs_on_the_cpu(self, capsys):
        losses = example.main(["--steps", "3", "--batch", "2", "--seq",
                               "16", "--device", "cpu"])
        assert len(losses) == 3
        assert all(np.isfinite(losses))
        assert "glm prefix-LM: loss" in capsys.readouterr().out


class TestRefusals:
    def test_sequence_parallelism_raises(self):
        cfg = glm.glm_tiny(seq_axis="seq")
        params = glm.init(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(NotImplementedError, match="A13"):
            glm.apply(params, torch.zeros(1, 8, dtype=torch.long), cfg)

    def test_pipelining_raises(self):
        with pytest.raises(NotImplementedError, match="A15"):
            glm.apply_pipelined({}, torch.zeros(1, 8, dtype=torch.long),
                                glm.glm_tiny(), 2, 2)

    def test_example_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main(["--steps", "1"])
