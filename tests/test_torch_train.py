"""Training with the port against the JAX package: one AdamW step against
optax, a 5-step loss trajectory of TrainExecutor + ElasticTrainer against
the JAX example's path, the fused multi-step call (``steps_per_call``)
against the synchronous loop and against the JAX package's, and the
control plane the slice copies (mesh plan, strategy, configuration,
launcher flags). Everything runs on the CPU in f32.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel import mesh as jax_mesh
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer.conf import build_configuration as jax_conf
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxTrainer
from dlrover_tpu.trainer.executor import TrainExecutor as JaxExecutor
from dlrover_tpu.trainer.executor import TrainHook as JaxHook
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.examples import train_llama as example
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.common import tree_leaves
from dlrover_tpu_torch.parallel import mesh
from dlrover_tpu_torch.parallel.accelerate import accelerate
from dlrover_tpu_torch.parallel.strategy import DtypePolicy, Strategy
from dlrover_tpu_torch.telemetry.events import recent_events
from dlrover_tpu_torch.trainer import run as launcher
from dlrover_tpu_torch.trainer.conf import Configuration, build_configuration
from dlrover_tpu_torch.trainer.data import stack_batches
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.executor import (
    NonFiniteLossError,
    TrainExecutor,
    TrainHook,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _torch_settings():
    """f32 results are compared: no TF32 in matmuls or convolutions. One
    CPU thread: these shapes are tiny, and the suite's other workers
    run timing-sensitive tests beside them."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.get_num_threads())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved[:2]
    torch.set_num_threads(saved[2])


def _jax_example():
    """The JAX package's example module (examples/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_llama", os.path.join(ROOT, "examples", "train_llama.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Losses:
    def after_step(self, step, metrics):
        self.losses.append(float(metrics["loss"]))


class JaxRecorder(_Losses, JaxHook):
    def __init__(self):
        self.losses = []


class Recorder(_Losses, TrainHook):
    def __init__(self):
        self.losses = []


class TestAdamW:
    def test_steps_match_optax(self):
        """torch AdamW with the example's settings against
        optax.adamw(3e-4, weight_decay=0.1), three steps so bias
        correction moves: f32, 1e-7 absolute / 1e-6 relative."""
        rs = np.random.RandomState(0)
        p0 = [rs.randn(4, 5).astype(np.float32),
              rs.randn(7).astype(np.float32)]
        grads = [[rs.randn(*p.shape).astype(np.float32) for p in p0]
                 for _ in range(3)]

        tx = optax.adamw(3e-4, weight_decay=0.1)
        jp = [jnp.asarray(p) for p in p0]
        state = tx.init(jp)
        for g in grads:
            updates, state = tx.update([jnp.asarray(x) for x in g], state,
                                       jp)
            jp = optax.apply_updates(jp, updates)

        tp = [torch.tensor(p, requires_grad=True) for p in p0]
        opt = example.adamw()(tp)
        for g in grads:
            for p, x in zip(tp, g):
                p.grad = torch.from_numpy(x)
            opt.step()
        for p, ref in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                       atol=1e-7, rtol=1e-6)


class TestTrajectory:
    def test_five_steps_match_the_jax_example(self):
        """Same init (the JAX tree through interop), same token stream
        (the examples' RandomState), same AdamW: the per-step losses of
        both executors agree to 1e-4 relative (f32; Adam's normalised
        update can lift last-bit gradient differences near zero)."""
        batch, seq, steps = 4, 32, 5
        jcfg = jax_llama.llama_tiny()
        jbatches = _jax_example().synthetic_batches(jcfg.vocab_size, batch,
                                                    seq)
        jrec = JaxRecorder()
        jtrainer = JaxTrainer(
            jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
            optax.adamw(3e-4, weight_decay=0.1), next(jbatches()),
            strategy=JaxStrategy(mesh=jax_mesh.single_device_plan(),
                                 rule_set="llama", remat_policy=""),
            devices=[jax.devices()[0]],
        )
        JaxExecutor(jtrainer, train_iter_fn=jbatches, hooks=[jrec],
                    conf=jax_conf({"train_steps": steps,
                                   "log_every_steps": 100})
                    ).train_and_evaluate()

        tree = jax.device_get(jax_llama.init(jax.random.PRNGKey(0), jcfg))
        cfg, _ = example.preset_config("tiny")
        batches = example.synthetic_batches(cfg.vocab_size, batch, seq)
        rec = Recorder()
        trainer = ElasticTrainer(
            lambda gen: interop.params_from_numpy(tree, device="cpu"),
            llama.make_loss_fn(cfg), example.adamw(), next(batches()),
            strategy=Strategy(mesh=mesh.single_device_plan(),
                              rule_set="llama", remat_policy=""),
            device="cpu",
        )
        out = TrainExecutor(trainer, train_iter_fn=batches, hooks=[rec],
                            conf=build_configuration({
                                "train_steps": steps,
                                "log_every_steps": 100})
                            ).train_and_evaluate()
        assert out["step"] == steps
        assert len(rec.losses) == len(jrec.losses) == steps
        np.testing.assert_allclose(rec.losses, jrec.losses, rtol=1e-4)

    def test_packed_rows_match_the_jax_example(self):
        """Packed rows (segment ids, a -1 pad tail, labels -100 across
        each boundary) through TrainExecutor + ElasticTrainer +
        accelerate: the ids reach the loss unchanged, and three steps'
        losses agree with the JAX executor's to 1e-4 relative."""
        batch, seq, steps = 2, 32, 3
        seg = np.stack([np.repeat([0, 1, 2], [10, 14, 8]),
                        np.repeat([3, 4, -1], [20, 7, 5])]).astype(np.int32)

        def host_batches():
            rng = np.random.RandomState(0)
            while True:
                ids = rng.randint(0, 256, size=(batch, seq + 1))
                labels = ids[:, 1:].copy()
                labels[:, :-1][seg[:, :-1] != seg[:, 1:]] = -100
                labels[seg == -1] = -100
                yield {"input_ids": ids[:, :-1], "labels": labels,
                       "segment_ids": seg}

        def jbatches():
            return ({k: jnp.asarray(v) for k, v in b.items()}
                    for b in host_batches())

        jcfg = jax_llama.llama_tiny()
        jrec = JaxRecorder()
        jtrainer = JaxTrainer(
            jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
            optax.adamw(3e-4, weight_decay=0.1), next(jbatches()),
            strategy=JaxStrategy(mesh=jax_mesh.single_device_plan(),
                                 rule_set="llama", remat_policy=""),
            devices=[jax.devices()[0]],
        )
        JaxExecutor(jtrainer, train_iter_fn=jbatches, hooks=[jrec],
                    conf=jax_conf({"train_steps": steps,
                                   "log_every_steps": 100})
                    ).train_and_evaluate()

        tree = jax.device_get(jax_llama.init(jax.random.PRNGKey(0), jcfg))
        cfg, _ = example.preset_config("tiny")
        seen = []
        loss_fn = llama.make_loss_fn(cfg)

        def recording_loss(params, batch, rng):
            if batch["segment_ids"].device.type != "meta":
                # the attribution capture runs the loss on the meta
                # device too: only the real steps are recorded
                seen.append(batch["segment_ids"])
            return loss_fn(params, batch, rng)

        rec = Recorder()
        trainer = ElasticTrainer(
            lambda gen: interop.params_from_numpy(tree, device="cpu"),
            recording_loss, example.adamw(), next(host_batches()),
            strategy=Strategy(mesh=mesh.single_device_plan(),
                              rule_set="llama", remat_policy=""),
            device="cpu",
        )
        TrainExecutor(trainer, train_iter_fn=host_batches, hooks=[rec],
                      conf=build_configuration({"train_steps": steps,
                                                "log_every_steps": 100})
                      ).train_and_evaluate()
        assert len(seen) == steps
        for ids in seen:
            assert ids.dtype == torch.int32
            np.testing.assert_array_equal(ids.numpy(), seg)
        np.testing.assert_allclose(rec.losses, jrec.losses, rtol=1e-4)

    def test_grad_accumulation_keeps_the_step(self):
        """Two microbatches sum then average their gradients: the same
        step as one full batch up to f32 summation order (1e-6)."""
        cfg = llama.llama_tiny()
        ids = np.random.RandomState(0).randint(0, 256, size=(4, 17))
        batch = {"input_ids": torch.from_numpy(ids[:, :-1]),
                 "labels": torch.from_numpy(ids[:, 1:])}
        results = []
        for accum in (1, 2):
            res = accelerate(
                llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                example.adamw(), batch,
                strategy=Strategy(grad_accum_steps=accum), device="cpu")
            state = res.init_fn(0)
            state, metrics = res.train_step(state, batch)
            results.append((metrics, state))
        (m1, s1), (m2, s2) = results
        np.testing.assert_allclose(m1["loss"].item(), m2["loss"].item(),
                                   rtol=1e-6)
        np.testing.assert_allclose(m1["grad_norm"].item(),
                                   m2["grad_norm"].item(), rtol=1e-5)
        assert s1.step == s2.step == 1
        emb1 = s1.params["embed_tokens"]["embedding"]
        emb2 = s2.params["embed_tokens"]["embedding"]
        torch.testing.assert_close(emb1, emb2, atol=1e-6, rtol=1e-6)

    def test_eval_step(self):
        cfg = llama.llama_tiny()
        ids = np.random.RandomState(0).randint(0, 256, size=(2, 9))
        batch = {"input_ids": torch.from_numpy(ids[:, :-1]),
                 "labels": torch.from_numpy(ids[:, 1:])}
        res = accelerate(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                         example.adamw(), batch, device="cpu")
        metrics = res.eval_step(res.init_fn(0), batch)
        assert np.isfinite(metrics["loss"].item())
        assert not metrics["loss"].requires_grad


def _trainer(loss_fn, cfg=None):
    cfg = cfg or llama.llama_tiny()
    batches = example.synthetic_batches(cfg.vocab_size, 2, 8)
    return ElasticTrainer(llama.make_init_fn(cfg), loss_fn, example.adamw(),
                          next(batches()), device="cpu"), batches


class TestExecutor:
    def _nan_loss(self):
        base = llama.make_loss_fn(llama.llama_tiny())

        def loss_fn(params, batch, rng):
            loss, aux = base(params, batch, rng)
            return loss * float("nan"), aux

        return loss_fn

    @pytest.mark.parametrize("policy", ["halt", "rollback"])
    def test_nonfinite_step_stops_the_run(self, policy):
        """"halt" stops at the first non-finite step; "rollback" with no
        checkpoint to restore escalates to a halt, as the reference's
        does, instead of restarting from a fresh init."""
        trainer, batches = _trainer(self._nan_loss())
        conf = Configuration({"train_steps": 3,
                              "check_finite_every_steps": 1,
                              "on_nonfinite": policy})
        executor = TrainExecutor(trainer, batches, conf=conf)
        match = "no.*checkpoint" if policy == "rollback" else "non-finite"
        with pytest.raises(NonFiniteLossError, match=match):
            executor.train_and_evaluate()

    def test_ignore_policy_runs_on(self):
        trainer, batches = _trainer(self._nan_loss())
        out = TrainExecutor(trainer, batches, conf=Configuration({
            "train_steps": 2, "check_finite_every_steps": 1,
            "on_nonfinite": "ignore"})).train_and_evaluate()
        assert out["step"] == 2

    def test_eval_and_window(self):
        trainer, batches = _trainer(
            llama.make_loss_fn(llama.llama_tiny()))
        evals = []

        def eval_fn(state):
            evals.append(state.step)
            return trainer.accelerated.eval_step(
                state, trainer.accelerated.shard_batch(next(batches())))

        rec = Recorder()
        out = TrainExecutor(trainer, batches, eval_fn=eval_fn, hooks=[rec],
                            conf=Configuration({
                                "train_steps": 4, "eval_every_steps": 2,
                                "train_window": 2})).train_and_evaluate()
        assert out["step"] == 4 and np.isfinite(out["loss"])
        assert evals == [2, 4]
        assert len(rec.losses) == 4

    def test_emits_events_spans_and_counters(self):
        from dlrover_tpu_torch.telemetry import get_registry, names, tracing
        from dlrover_tpu_torch.telemetry.events import recent_events

        steps_before = get_registry().get(names.TRAIN_STEPS)
        steps_before = steps_before.value if steps_before else 0.0
        trainer, batches = _trainer(llama.make_loss_fn(llama.llama_tiny()))
        TrainExecutor(trainer, batches, conf=Configuration(
            {"train_steps": 3})).train_and_evaluate()
        kinds = [e["kind"] for e in recent_events()]
        start = len(kinds) - 1 - kinds[::-1].index("train_start")
        assert kinds[start:] == ["train_start", "attribution_captured",
                                 "compile_first_step", "train_end"]
        assert get_registry().get(names.TRAIN_STEPS).value == \
            steps_before + 3
        assert get_registry().get(names.STEP_TIME).count >= 3
        dispatched = [s for s in tracing.snapshot()
                      if s[0] == "step_dispatch"]
        assert len(dispatched) >= 3

    def test_checkpointing_waits_for_its_slice(self, tmp_path):
        """A ``ckpt_dir`` that holds no checkpoint gives a fresh init:
        the same parameters as a trainer without one, at step 0."""
        cfg = llama.llama_tiny()
        batch = next(example.synthetic_batches(cfg.vocab_size, 2, 8)())
        states = [ElasticTrainer(llama.make_init_fn(cfg),
                                 llama.make_loss_fn(cfg), example.adamw(),
                                 batch, ckpt_dir=ckpt, device="cpu").prepare()
                  for ckpt in (str(tmp_path / "empty"), "")]
        assert states[0].step == 0 and not states[0].opt_state.state
        for a, b in zip(tree_leaves(states[0].params),
                        tree_leaves(states[1].params)):
            assert torch.equal(a, b)


class StepRecorder(TrainHook):
    """Each step's loss by step number; a step seen twice fails."""

    def __init__(self):
        self.losses = {}

    def after_step(self, step, metrics):
        assert step not in self.losses, f"step {step} materialized twice"
        self.losses[step] = float(metrics["loss"])


class TestMultiStep:
    """The fused multi-step call (``steps_per_call = K``): K optimizer
    steps in one call, bit for bit K calls of the step."""

    def _run(self, window, steps_per_call=1, train_steps=16):
        cfg = llama.llama_tiny()
        batches = example.synthetic_batches(cfg.vocab_size, 2, 8)
        trainer = ElasticTrainer(
            llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
            example.adamw(), next(batches()), device="cpu",
            steps_per_call=steps_per_call)
        rec = StepRecorder()
        executor = TrainExecutor(trainer, batches, hooks=[rec],
                                 conf=Configuration({
                                     "train_steps": train_steps,
                                     "log_every_steps": 0,
                                     "train_window": window}))
        return executor.train_and_evaluate(), executor, rec

    def test_window_and_multi_step_bitwise_parity_with_sync(self):
        """Windows 0 and 4, and K = 8 under window 4, over 16 steps:
        every per-step loss and every parameter bit equal."""
        out0, ex0, rec0 = self._run(window=0)
        out1, ex1, rec1 = self._run(window=4)
        out2, ex2, rec2 = self._run(window=4, steps_per_call=8)
        assert out0["step"] == out1["step"] == out2["step"] == 16
        assert sorted(rec2.losses) == list(range(1, 17))
        assert rec0.losses == rec1.losses == rec2.losses
        for ex in (ex1, ex2):
            for a, b in zip(tree_leaves(ex.state.params),
                            tree_leaves(ex0.state.params)):
                assert torch.equal(a, b)
        assert ex2.state.step == 16

    def test_partial_tail_group_dispatches_single_steps(self):
        """13 steps at K = 8: one fused call, then five single steps,
        every step once."""
        out, ex, rec = self._run(window=2, steps_per_call=8,
                                 train_steps=13)
        assert out["step"] == 13 and ex.state.step == 13
        assert sorted(rec.losses) == list(range(1, 14))
        start = [e for e in recent_events() if e["kind"] == "train_start"]
        assert start[-1]["steps_per_call"] == 8

    def test_multi_step_matches_the_jax_accelerate(self):
        """The reference's ``accelerate(..., steps_per_call=4)`` and the
        port's, two fused calls over the same tiny Llama, init and token
        stream: the eight per-step losses within 1e-4 relative (f32, as
        TestTrajectory)."""
        batch, seq, k = 4, 32, 4
        jcfg = jax_llama.llama_tiny()
        jb = _jax_example().synthetic_batches(jcfg.vocab_size, batch, seq)()
        groups = [[next(jb) for _ in range(k)] for _ in range(2)]
        jres = jax_accelerate(
            jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
            optax.adamw(3e-4, weight_decay=0.1), groups[0][0],
            strategy=JaxStrategy(mesh=jax_mesh.single_device_plan(),
                                 rule_set="llama", remat_policy=""),
            devices=[jax.devices()[0]], steps_per_call=k)
        jstate = jres.init_fn(jax.random.PRNGKey(0))
        tree = jax.device_get(jstate.params)
        want = []
        for i, group in enumerate(groups):
            stacked = jax.tree.map(lambda *xs: np.stack(xs), *group)
            rngs = jax.random.split(jax.random.PRNGKey(i), k)
            jstate, m = jres.train_step_multi(
                jstate, jres.shard_batch(stacked, stacked=True), rngs)
            want += [float(x) for x in np.asarray(m["loss"])]

        cfg, _ = example.preset_config("tiny")
        result = accelerate(
            lambda gen: interop.params_from_numpy(tree, device="cpu"),
            llama.make_loss_fn(cfg), example.adamw(), groups[0][0],
            strategy=Strategy(mesh=mesh.single_device_plan(),
                              rule_set="llama", remat_policy=""),
            device="cpu", steps_per_call=k)
        state, got = result.init_fn(0), []
        for group in groups:
            state, m = result.train_step_multi(
                state, result.shard_batch(stack_batches(group),
                                          stacked=True))
            assert m["loss"].shape == m["finite"].shape == (k,)
            got += m["loss"].tolist()
        assert state.step == 2 * k
        np.testing.assert_allclose(got, want, rtol=1e-4)

    def test_no_host_read_between_the_fused_steps(self, monkeypatch):
        """Nothing in the fused call reads a computed tensor on the host:
        with ``item``, ``tolist`` and ``bool`` made to raise on every
        tensor but AdamW's step counters (which torch keeps on the host
        by design), two fused calls run; off save steps the trainer
        reads nothing either."""
        cfg = llama.llama_tiny()
        batches = example.synthetic_batches(cfg.vocab_size, 2, 8)()
        trainer = ElasticTrainer(
            llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
            example.adamw(), next(batches), device="cpu", steps_per_call=3)
        state = trainer.prepare()
        state, _ = trainer.step_multi(state, [next(batches)
                                              for _ in range(3)])
        counters = {id(slots["step"])
                    for slots in state.opt_state.state.values()}
        assert counters

        def guarded(name):
            real = getattr(torch.Tensor, name)

            def read(self, *args, **kwargs):
                if id(self) not in counters:
                    raise AssertionError(f"{name} inside the fused call")
                return real(self, *args, **kwargs)

            return read

        group = [next(batches) for _ in range(3)]
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "__bool__"):
                m.setattr(torch.Tensor, name, guarded(name))
            state, metrics = trainer.step_multi(state, group)
        assert bool(metrics["finite"].all()) and state.step == 6

    def test_step_multi_takes_k_batches_or_one_stacked(self):
        cfg = llama.llama_tiny()
        batches = example.synthetic_batches(cfg.vocab_size, 2, 8)()
        group = [next(batches) for _ in range(2)]
        losses = []
        for given in (group, stack_batches(group)):
            trainer = ElasticTrainer(
                llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                example.adamw(), group[0], device="cpu", steps_per_call=2)
            state = trainer.prepare()
            state, metrics = trainer.step_multi(state, given)
            losses.append(metrics["loss"].tolist())
        assert losses[0] == losses[1]
        with pytest.raises(ValueError, match="exactly steps_per_call=2"):
            trainer.step_multi(state, group + group[:1])
        single = ElasticTrainer(llama.make_init_fn(cfg),
                                llama.make_loss_fn(cfg), example.adamw(),
                                group[0], device="cpu")
        state = single.prepare()
        with pytest.raises(RuntimeError, match="steps_per_call > 1"):
            single.step_multi(state, group)

    def test_launcher_flags_and_env_knobs(self, monkeypatch):
        """``--steps_per_call`` / ``--train_window`` of the launcher, and
        the Context's environment overrides they set."""
        from dlrover_tpu_torch.common.config import Context

        args = launcher.build_parser().parse_args(
            ["--nproc", "2", "--train_window", "2", "--steps_per_call", "8",
             "--", "t.py"])
        assert (args.train_window, args.steps_per_call) == (2, 8)
        monkeypatch.setenv("DLROVER_TPU_TRAIN_WINDOW", "7")
        monkeypatch.setenv("DLROVER_TPU_STEPS_PER_CALL", "3")
        monkeypatch.setenv("DLROVER_TPU_LIVE_RECOVERY", "0")
        ctx = Context()
        assert (ctx.train_window, ctx.steps_per_call) == (7, 3)
        assert ctx.live_recovery is False

    def test_example_takes_steps_per_call(self):
        rec = StepRecorder()
        out = example.main(["--preset", "tiny", "--steps", "6", "--batch",
                            "2", "--seq", "16", "--device", "cpu",
                            "--steps_per_call", "4"], hooks=[rec])
        assert out["step"] == 6 and sorted(rec.losses) == list(range(1, 7))


class TestDevice:
    def test_entry_points_default_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is usable")
        cfg = llama.llama_tiny()
        batch = next(example.synthetic_batches(cfg.vocab_size, 2, 8)())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ElasticTrainer(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                           example.adamw(), batch)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            accelerate(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                       example.adamw(), batch)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            interop.params_from_numpy({"w": np.zeros(2, np.float32)})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            example.main(["--steps", "1"])

    def test_multi_device_mesh_raises(self):
        cfg = llama.llama_tiny()
        batch = next(example.synthetic_batches(cfg.vocab_size, 2, 8)())
        with pytest.raises(ValueError):
            accelerate(llama.make_init_fn(cfg), llama.make_loss_fn(cfg),
                       example.adamw(), batch,
                       strategy=Strategy(mesh=mesh.MeshPlan(data=1, fsdp=2)),
                       device="cpu")


class TestExample:
    def test_runs_on_the_cpu(self):
        out = example.main(["--preset", "tiny", "--steps", "3", "--batch",
                            "2", "--seq", "16", "--device", "cpu"])
        assert out["step"] == 3

    def test_refuses_later_slices(self):
        # pipelining (A15); a ring needs as many ranks as its size (the
        # ring itself runs in tests/test_torch_seq.py)
        for argv in (["--pipe", "2"], ["--ring", "2"]):
            with pytest.raises(SystemExit):
                example.main(argv + ["--device", "cpu"])

    def test_same_tokens_as_the_jax_example(self):
        ours = example.synthetic_batches(256, 2, 8, seed=3)()
        theirs = _jax_example().synthetic_batches(256, 2, 8, seed=3)()
        for _ in range(3):
            a, b = next(ours), next(theirs)
            np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
            np.testing.assert_array_equal(a["labels"], b["labels"])


class TestControlPlane:
    @pytest.mark.parametrize("world", [1, 2, 4, 8, 6])
    def test_mesh_plan_matches_the_reference(self, world):
        for kw in ({"data": -1, "fsdp": 2}, {"data": -1}, {"fsdp": 4}):
            ours, theirs = mesh.MeshPlan(**kw), jax_mesh.MeshPlan(**kw)
            try:
                ref = theirs.adjust_to_world(world).axis_sizes()
            except ValueError:
                with pytest.raises(ValueError):
                    ours.adjust_to_world(world)
                continue
            assert ours.adjust_to_world(world).axis_sizes() == ref

    def test_strategy_json_round_trip(self):
        s = Strategy(mesh=mesh.MeshPlan(data=2, fsdp=4), rule_set="llama",
                     remat_policy="full", dtypes=DtypePolicy(),
                     grad_accum_steps=2, stage_depths=(1, 2),
                     global_batch_size=8)
        assert Strategy.from_json(s.to_json()) == s
        # the JSON is the reference's: it loads there too
        theirs = JaxStrategy.from_json(s.to_json())
        assert theirs.to_json() == s.to_json()
        assert s.adjust_to_world(4, prev_num_devices=8).grad_accum_steps \
            == theirs.adjust_to_world(4, prev_num_devices=8).grad_accum_steps

    def test_configuration_merges_like_the_reference(self):
        class Base:
            train_steps = 10
            opt = {"lr": 1.0, "b": 2}

        class Sub(Base):
            opt = {"lr": 3.0}

        sources = (Sub, {"log_every_steps": 5, "opt": {"c": 1}})
        ours = build_configuration(*sources, overrides={"train_steps": 7})
        theirs = jax_conf(*sources, overrides={"train_steps": 7})
        assert ours.to_dict() == theirs.to_dict()
        assert ours.opt.lr == 3.0 and ours.get("missing", 1) == 1


def test_partial_optimizer_factory_builds_adamw():
    opt = example.adamw()([torch.zeros(2, requires_grad=True)])
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["eps"]) == \
        (3e-4, 0.1, 1e-8)
    assert isinstance(example.adamw(), functools.partial)
