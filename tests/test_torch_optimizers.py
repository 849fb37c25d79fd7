"""The port's optimizers against the JAX package's
(``dlrover_tpu/optimizers/`` and ``tests/test_optimizers.py``): each
transform's updates against the optax transform's on the same inputs,
f32, within 1e-6; WSAM through ``accelerate`` against the reference's
accelerate on the same weights and batches; the grad scaler's states
step for step. All on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu import optimizers as jax_opt
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.optimizers import (
    DynamicGradScaler,
    all_finite,
    bf16_master_weights,
    clip_by_global_norm,
    clip_grads_,
    global_norm,
    wsam,
)
from dlrover_tpu_torch.parallel.accelerate import accelerate
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.strategy import Strategy

# updates of the same transform on the same f32 inputs
ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def sgd(lr, **kw):
    return functools.partial(torch.optim.SGD, lr=lr, **kw)


def _quadratic(w):
    # sharp in dim 0, flat in dim 1
    return 50.0 * w[0] ** 2 + 0.5 * w[1] ** 2


def _port_wsam_update(w0, **kw):
    """The change one WSAM step of the port makes to ``w0``."""
    w = torch.tensor(w0, requires_grad=True)
    opt = wsam(**kw)([w])
    w.grad = torch.autograd.grad(_quadratic(w), w)[0]

    def grad_fn():
        return [torch.autograd.grad(_quadratic(w), w)[0]]

    opt.update_with_grad_fn(grad_fn)
    return w.detach().numpy() - np.asarray(w0, np.float32)


def _jax_wsam_update(w0, **kw):
    w = jnp.asarray(w0, jnp.float32)
    opt = jax_opt.wsam(**kw)
    g = jax.grad(_quadratic)(w)
    updates, _ = opt.update_with_grad_fn(g, opt.init(w), w,
                                         jax.grad(_quadratic))
    return np.asarray(updates)


class TestWsam:
    @pytest.mark.parametrize("case", [
        dict(w=[1.0, 1.0], lr=0.1, rho=0.05, gamma=0.9, decouple=True),
        dict(w=[0.5, -0.3], lr=0.05, rho=0.1, gamma=0.8, decouple=False),
        dict(w=[0.7, -1.2], lr=0.05, rho=0.1, gamma=0.5, decouple=True,
             adaptive=True, max_norm=5.0),
        dict(w=[0.7, -1.2], lr=0.05, rho=0.1, gamma=0.5, decouple=False,
             adaptive=True, max_norm=5.0),
    ], ids=["decoupled", "coupled", "adaptive-clipped-decoupled",
            "adaptive-clipped-coupled"])
    def test_step_matches_the_reference(self, case):
        """One step on the quadratic: the port's weight change against
        the reference's updates (optax.sgd vs torch SGD), within 1e-6."""
        case = dict(case)
        w0, lr = case.pop("w"), case.pop("lr")
        kw = dict(case, learning_rate=lr if case["decouple"] else None)
        got = _port_wsam_update(w0, base=sgd(lr), **kw)
        want = _jax_wsam_update(w0, base_optimizer=optax.sgd(lr), **kw)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-6)

    def test_decoupled_step_matches_manual(self):
        """The reference's manual formula: -lr g - lr alpha (g_sam - g)."""
        w = np.array([1.0, 1.0], np.float32)
        lr, rho, gamma = 0.1, 0.05, 0.9
        alpha = gamma / (1 - gamma)
        got = _port_wsam_update(w, base=sgd(lr), rho=rho, gamma=gamma,
                                learning_rate=lr)
        g = np.array([100.0, 1.0])
        e_w = rho * g / np.linalg.norm(g)
        g_sam = np.array([100.0, 1.0]) * (w + e_w)
        expected = -lr * g - lr * alpha * (g_sam - g)
        np.testing.assert_allclose(got, expected, rtol=1e-5)

    def test_schedule_reads_the_step_count(self):
        """A learning-rate schedule is called with the steps taken, as
        the reference's count."""
        seen = []

        def schedule(count):
            seen.append(count)
            return 0.1

        w = torch.tensor([1.0, 1.0], requires_grad=True)
        opt = wsam(sgd(0.1), learning_rate=schedule)([w])
        for _ in range(3):
            w.grad = torch.autograd.grad(_quadratic(w), w)[0]
            opt.update_with_grad_fn(
                lambda: [torch.autograd.grad(_quadratic(w), w)[0]])
        assert seen == [0, 1, 2]

    def test_decouple_requires_learning_rate(self):
        with pytest.raises(ValueError):
            wsam(sgd(0.1))
        with pytest.raises(ValueError):
            wsam(sgd(0.1), rho=-1.0, learning_rate=0.1)

    def test_plain_step_refuses(self):
        w = torch.tensor([1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="update_with_grad_fn"):
            wsam(sgd(0.1), learning_rate=0.1)([w]).step()

    def test_accelerate_integration(self):
        """WSAM through ``accelerate``: 10 steps on a linear regression
        halve the loss (the reference's test), and the losses equal the
        reference's accelerate on the same weights and batch within
        1e-5 relative."""
        rs = np.random.RandomState(0)
        x = rs.randn(16, 4).astype(np.float32)
        w_true = rs.randn(4, 2).astype(np.float32)
        w0 = rs.randn(4, 2).astype(np.float32)
        batch = {"x": x, "y": x @ w_true}

        def jax_init(rng):
            return {"w": jnp.asarray(w0), "b": jnp.zeros((2,))}

        def jax_loss(params, b, rng):
            pred = b["x"] @ params["w"] + params["b"]
            return jnp.mean((pred - b["y"]) ** 2), {}

        ref = jax_accelerate(
            jax_init, jax_loss,
            jax_opt.wsam(optax.sgd(0.1), learning_rate=0.1), batch,
            strategy=JaxStrategy(mesh=JaxMeshPlan(data=1)),
            devices=jax.devices()[:1])
        state = ref.init_fn(jax.random.PRNGKey(1))
        sb = ref.shard_batch(batch)
        want = []
        for i in range(10):
            state, m = ref.train_step(state, sb, jax.random.PRNGKey(i))
            want.append(float(m["loss"]))

        def init(gen):
            return {"w": torch.from_numpy(w0.copy()),
                    "b": torch.zeros(2)}

        def loss_fn(params, b, rng):
            pred = b["x"] @ params["w"] + params["b"]
            return torch.mean((pred - b["y"]) ** 2), {}

        result = accelerate(init, loss_fn, wsam(sgd(0.1), learning_rate=0.1),
                            batch, strategy=Strategy(mesh=MeshPlan(data=1)),
                            device="cpu")
        state = result.init_fn(0)
        sb = result.shard_batch(batch)
        got = []
        for _ in range(10):
            state, m = result.train_step(state, sb)
            got.append(float(m["loss"]))
        assert got[-1] < got[0] * 0.5
        np.testing.assert_allclose(got, want, rtol=1e-5)


class TestBf16MasterWeights:
    def test_small_updates_accumulate_via_master(self):
        """Each update is far below bf16's resolution at 1.0; only the
        fp32 master keeps them: the master equals the reference's after
        100 steps, and the bf16 parameter moved."""
        p = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
        opt = bf16_master_weights(sgd(1.0))([p])
        jp = {"w": jnp.ones((4,), jnp.bfloat16)}
        jtx = jax_opt.bf16_master_weights(optax.sgd(1.0))
        jstate = jtx.init(jp)
        g = {"w": jnp.full((4,), 1e-4, jnp.bfloat16)}
        for _ in range(100):
            p.grad = torch.full((4,), 1e-4, dtype=torch.bfloat16)
            opt.step()
            updates, jstate = jtx.update(g, jstate, jp)
            jp = optax.apply_updates(jp, updates)
        master = opt.master[0]
        assert master.dtype == torch.float32
        want = np.asarray(jax.tree.leaves(jstate.master)[0])
        np.testing.assert_allclose(master.numpy(), want, atol=ATOL)
        np.testing.assert_allclose(master.numpy(), 1.0 - 1e-2, rtol=1e-3)
        assert float(p[0].detach()) < 1.0
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            np.asarray(jp["w"]).astype(np.float32))

    def test_fp32_params_pass_through(self):
        p = torch.ones(2, requires_grad=True)
        opt = bf16_master_weights(sgd(0.5))([p])
        p.grad = torch.ones(2)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), 0.5)
        assert opt.master[0] is p

    def test_momentum_on_bf16_matches_the_reference(self):
        """SGD with momentum on fp32 masters of bf16 parameters, five
        steps of random gradients: masters within 1e-6 of the reference's
        and the parameters bit for bit."""
        rs = np.random.RandomState(3)
        p0 = rs.randn(3, 8).astype(np.float32)
        grads = [rs.randn(3, 8).astype(np.float32) * 1e-2 for _ in range(5)]
        p = torch.tensor(p0).to(torch.bfloat16).requires_grad_()
        opt = bf16_master_weights(sgd(0.1, momentum=0.9))([p])
        jp = jnp.asarray(p0).astype(jnp.bfloat16)
        jtx = jax_opt.bf16_master_weights(optax.sgd(0.1, momentum=0.9))
        jstate = jtx.init(jp)
        for g in grads:
            p.grad = torch.tensor(g).to(torch.bfloat16)
            opt.step()
            updates, jstate = jtx.update(jnp.asarray(g).astype(jnp.bfloat16),
                                         jstate, jp)
            jp = optax.apply_updates(jp, updates)
        np.testing.assert_allclose(opt.master[0].numpy(),
                                   np.asarray(jstate.master), atol=ATOL)
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(jp).astype(np.float32))

    def test_state_by_parameter_holds_the_master(self):
        """A checkpoint reads ``opt.state[p]``: the base's slots of the
        master and the master itself; writing it back restores both."""
        p = torch.ones(4, dtype=torch.bfloat16, requires_grad=True)
        opt = bf16_master_weights(sgd(0.1, momentum=0.9))([p])
        p.grad = torch.full((4,), 0.5, dtype=torch.bfloat16)
        opt.step()
        slots = opt.state[p]
        assert set(slots) == {"momentum_buffer", "master"}
        saved = {k: v.clone() for k, v in slots.items()}
        p.grad = torch.full((4,), 0.5, dtype=torch.bfloat16)
        opt.step()
        opt.state[p] = saved
        assert torch.equal(opt.master[0], saved["master"])
        assert torch.equal(opt.state[p]["momentum_buffer"],
                           saved["momentum_buffer"])
        assert list(opt.state) == [p]


class TestGradScaler:
    def test_states_match_the_reference(self):
        """The same finite/overflow sequence through both scalers: every
        scale and growth count equal."""
        flags = [False, True, True, True, False, True, True, True, True]
        port = DynamicGradScaler(init_scale=8.0, growth_interval=2,
                                 max_scale=32.0)
        ref = jax_opt.DynamicGradScaler(init_scale=8.0, growth_interval=2,
                                        max_scale=32.0)
        s, rs = port.init(), ref.init()
        for finite in flags:
            s = port.update(s, torch.tensor(finite))
            rs = ref.update(rs, jnp.asarray(finite))
            assert float(s.scale) == float(rs.scale)
            assert int(s.growth_tracker) == int(rs.growth_tracker)

    def test_backoff_on_overflow_and_growth(self):
        scaler = DynamicGradScaler(init_scale=8.0, growth_interval=2)
        state = scaler.update(scaler.init(), torch.tensor(False))
        assert float(state.scale) == 4.0
        state = scaler.update(state, torch.tensor(True))
        state = scaler.update(state, torch.tensor(True))
        assert float(state.scale) == 8.0

    def test_scale_unscale_roundtrip(self):
        scaler = DynamicGradScaler(init_scale=1024.0)
        state = scaler.init()
        assert float(scaler.scale(torch.tensor(0.5), state)) == 512.0
        grads = {"w": torch.tensor([2048.0, 1024.0])}
        unscaled, finite = scaler.unscale(grads, state)
        np.testing.assert_allclose(unscaled["w"].numpy(), [2.0, 1.0])
        assert bool(finite)
        ref = jax_opt.DynamicGradScaler(init_scale=1024.0)
        want, _ = ref.unscale({"w": jnp.asarray([2048.0, 1024.0])},
                              ref.init())
        np.testing.assert_array_equal(unscaled["w"].numpy(),
                                      np.asarray(want["w"]))

    def test_detects_non_finite(self):
        assert not bool(all_finite({"g": torch.tensor([1.0, np.inf])}))
        assert not bool(all_finite({"g": torch.tensor([np.nan])}))
        assert bool(all_finite({"g": torch.tensor([1.0, 2.0])}))
        assert bool(all_finite({}))


class TestClip:
    def _tree(self, scale):
        rs = np.random.RandomState(4)
        return {"a": rs.randn(3, 5).astype(np.float32) * scale,
                "b": {"c": rs.randn(7).astype(np.float32) * scale}}

    def test_global_norm_matches_the_reference(self):
        tree = self._tree(1.0)
        got = global_norm({"a": torch.from_numpy(tree["a"]),
                           "b": {"c": torch.from_numpy(tree["b"]["c"])}})
        want = jax_opt.global_norm(jax.tree.map(jnp.asarray, tree))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    @pytest.mark.parametrize("scale", [10.0, 0.01],
                             ids=["clipped", "under-the-norm"])
    def test_clipped_updates_match_optax(self, scale):
        """``clip_by_global_norm(1.0, sgd(1.0))``'s step against
        ``optax.chain(clip_by_global_norm(1.0), sgd(1.0))``'s updates."""
        tree = self._tree(scale)
        leaves = [tree["a"], tree["b"]["c"]]
        params = [torch.zeros(x.shape, requires_grad=True) for x in leaves]
        opt = clip_by_global_norm(1.0, sgd(1.0))(params)
        for p, g in zip(params, leaves):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        tx = optax.chain(jax_opt.clip_by_global_norm(1.0), optax.sgd(1.0))
        jg = [jnp.asarray(g) for g in leaves]
        updates, _ = tx.update(jg, tx.init(jg), jg)
        for p, u in zip(params, updates):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(u),
                                       atol=ATOL)

    def test_clips_to_max_norm(self):
        g = [torch.tensor([3.0, 4.0])]
        norm = clip_grads_(g, 1.0)
        assert float(norm) == 5.0
        np.testing.assert_allclose(float(global_norm(g)), 1.0, rtol=1e-5)

    def test_norm_groups_must_match(self):
        with pytest.raises(ValueError, match="norm groups"):
            global_norm([torch.ones(2)], norm_groups=[None, None])
