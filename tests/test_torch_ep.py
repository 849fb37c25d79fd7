"""The port's expert-parallel MoE against the JAX package: four gloo
ranks on the CPU against a four-device JAX CPU mesh.

The port's ranks are spawned processes (``trainer.run.run_local``; the
rank functions are in ``tests/torch_ep_workers.py``), each run once per
module and checked for many cases. Weights and inputs come from numpy
and JAX's initialisers and go through ``interop``, each rank taking its
own block of experts.

Tolerances: the bf16 wire (no quantization) computes in f32 here, 1e-5
relative. The fp8 wires are held to 1e-2 relative norm error: a
one-ulp difference between the frameworks before a re-quantize can move
an element by one e4m3 step of its block. Within the port, fp8 equals
fp8_qdq bit for bit, forward and backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.ops import moe as jax_moe
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.sharding_rules import rank_coords
from dlrover_tpu_torch.trainer.run import run_local

import torch_ep_workers as workers

P, E, TOP_K = 4, 8, 2
CASES = [(p, c) for p in ("bf16", "fp8", "fp8_qdq") for c in (1, 2)]
TIMEOUT = 240


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / max(
        np.linalg.norm(want), 1e-30)


# -- one MoE layer -----------------------------------------------------------


@pytest.fixture(scope="module")
def moe_setup():
    """The reference test's sizes (tests/test_quantize.py): E=8, top-2,
    d=16, f=32, 32 tokens, 8 per rank."""
    params = jax_moe.init_moe_params(jax.random.PRNGKey(0), 16, 32, E)
    tree = jax.device_get(params)
    x = np.random.RandomState(0).randn(2, 16, 16).astype(np.float32)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:P]), ("expert",))
    want = {}
    for precision, chunks in CASES:
        cfg = jax_moe.MoEConfig(num_experts=E, top_k=TOP_K,
                                dispatch="grouped_ep", ep_axes=("expert",),
                                mesh=mesh, dispatch_chunks=chunks,
                                precision=precision, kernel_interpret=True)

        def loss(p, xx, cfg=cfg):
            o, a, m = jax_moe.moe_ffn(p, xx, cfg, train=False)
            return (o.astype(jnp.float32) ** 2).sum() + a, (o, a, m)

        (_, (o, a, m)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
        want[(precision, chunks)] = jax.device_get({
            "out": o.reshape(-1, 16), "aux": a, "x": gx.reshape(-1, 16),
            "router": gp["router"]["kernel"],
            "up": gp["experts"]["up"]["kernel"],
            "down": gp["experts"]["down"]["kernel"],
            "expert_load": m["expert_load"],
        })
    got_ranks = run_local(workers.moe_ranks, P,
                          (tree, x.reshape(-1, 16), E, TOP_K, CASES),
                          timeout=TIMEOUT)
    got = {}
    for case in CASES:
        rs = [r[case] for r in got_ranks]
        got[case] = {
            "out": np.concatenate([r["out"] for r in rs]),
            "x": np.concatenate([r["x"] for r in rs]),
            "up": np.concatenate([r["up"] for r in rs]),
            "down": np.concatenate([r["down"] for r in rs]),
            "router": rs[0]["router"], "aux": rs[0]["aux"],
            "expert_load": rs[0]["expert_load"],
            "dropped_frac": [r["dropped_frac"] for r in rs],
            "ranks": rs,
        }
    return tree, x, got, want


KEYS = ("out", "x", "router", "up", "down")


@pytest.mark.parametrize("precision,chunks", CASES,
                         ids=[f"{p}-C{c}" for p, c in CASES])
def test_grouped_ep_matches_the_reference(moe_setup, precision, chunks):
    """Output, aux loss, expert load and the gradients of the router,
    up, down and x against ``grouped_ep`` on the 4-device JAX mesh."""
    _, x, got, want = moe_setup
    g, w = got[(precision, chunks)], want[(precision, chunks)]
    tol = 1e-5 if precision == "bf16" else 1e-2
    for key in KEYS:
        assert g[key].shape == w[key].shape, key
        assert _rel(g[key], w[key]) <= tol, (key, _rel(g[key], w[key]))
    if precision == "bf16":
        for key in KEYS:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       atol=1e-5 * np.abs(w[key]).max(),
                                       err_msg=key)
    np.testing.assert_allclose(g["aux"], float(w["aux"]), rtol=1e-6)
    np.testing.assert_allclose(g["expert_load"], w["expert_load"],
                               atol=1e-6)
    assert g["dropped_frac"] == [0.0] * P


@pytest.mark.parametrize("chunks", [1, 2])
def test_fp8_wire_equals_the_qdq_reference_bitwise(moe_setup, chunks):
    """Quantize -> exchange -> dequant-in-kernel is bit for bit the
    local quantize -> dequantize with a full-precision wire, on every
    rank: output, aux and every gradient, forward and backward."""
    _, _, got, _ = moe_setup
    for a, b in zip(got[("fp8", chunks)]["ranks"],
                    got[("fp8_qdq", chunks)]["ranks"]):
        for key in KEYS + ("aux",):
            assert np.asarray(a[key]).tobytes() == \
                np.asarray(b[key]).tobytes(), key


def test_chunks_change_no_result(moe_setup):
    """C is a schedule knob: the ring in two chunks gives the one-shot
    exchange's numbers, bit for bit."""
    _, _, got, _ = moe_setup
    for precision in ("bf16", "fp8"):
        for a, b in zip(got[(precision, 1)]["ranks"],
                        got[(precision, 2)]["ranks"]):
            for key in KEYS:
                assert a[key].tobytes() == b[key].tobytes(), (precision, key)


def test_fp8_moves_within_its_quantization_error(moe_setup):
    """fp8 against the unquantized wire: a few percent, not zero."""
    _, _, got, _ = moe_setup
    err = _rel(got[("fp8", 1)]["out"], got[("bf16", 1)]["out"])
    assert 1e-4 < err < 0.1, err


# -- the trainer -------------------------------------------------------------


TRAIN_KW = dict(num_experts=E, moe_top_k=TOP_K, moe_dispatch="grouped_ep")
LR = 1e-2


@pytest.fixture(scope="module")
def train_setup():
    """llama_tiny with 8 experts, grouped_ep, three Adam steps on a
    global batch of 8 rows x 16 tokens: JAX's accelerate on
    MeshPlan(data=4) over four CPU devices, and the port over four gloo
    ranks."""
    jcfg = jax_llama.llama_tiny(**TRAIN_KW)
    ids = np.random.RandomState(0).randint(0, jcfg.vocab_size,
                                           size=(3, 8, 17))
    batches = [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]
    result = jax_accelerate(
        jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
        optax.adam(LR), batches[0],
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=P, fsdp=1),
                             rule_set="moe_ep"),
        devices=jax.devices()[:P])
    state = result.init_fn(jax.random.PRNGKey(0))
    tree = jax.device_get(state.params)
    want = []
    for i, batch in enumerate(batches):
        state, metrics = result.train_step(
            state, result.shard_batch(batch), jax.random.PRNGKey(i))
        want.append(jax.device_get(metrics))
    got = run_local(workers.train_ranks, P, (tree, batches, TRAIN_KW, LR),
                    timeout=TIMEOUT)
    return want, got


def test_three_steps_match_the_jax_accelerate(train_setup):
    """Global losses within 1e-4 relative; the loss falls; nothing
    drops; every rank reports the same global metrics."""
    want, got = train_setup
    losses = [float(m["loss"]) for m in want]
    for r in got:
        np.testing.assert_allclose([float(s["loss"]) for s in r["steps"]],
                                   losses, rtol=1e-4)
        for s, w in zip(r["steps"], want):
            assert float(s["moe_dropped_frac"]) == 0.0
            assert bool(s["finite"])
            np.testing.assert_allclose(s["grad_norm"], float(w["grad_norm"]),
                                       rtol=1e-3)
            np.testing.assert_allclose(s["moe_expert_load"],
                                       np.asarray(w["moe_expert_load"]),
                                       atol=1e-5)
    assert losses[-1] < losses[0]


def test_each_rank_holds_its_block_of_experts(train_setup):
    _, got = train_setup
    cfg = llama.llama_tiny(**TRAIN_KW)
    for r in got:
        assert r["up_shape"] == (cfg.num_layers, E // P,
                                 cfg.hidden_size, cfg.intermediate_size)


def test_rank_local_init_is_the_one_rank_init():
    """``llama.init(expert_shard=(r, P))`` draws only rank r's experts,
    and they equal experts [r E/P, (r+1) E/P) of the one-rank model from
    the same seed."""
    kw = dict(num_experts=E, moe_top_k=TOP_K, moe_dispatch="grouped_ep")
    full = llama.init(torch.Generator().manual_seed(5), llama.llama_tiny(**kw))
    ranks = run_local(workers.init_ranks, P, (kw,), timeout=TIMEOUT)
    for key in ("up", "down"):
        np.testing.assert_array_equal(
            np.concatenate([r[key] for r in ranks], axis=1),
            full["layers"]["experts"][key]["kernel"].numpy())
    shapes = llama.param_shapes(llama.llama_tiny(**kw), expert_shard=(1, P))
    assert shapes["layers"]["experts"]["up"]["kernel"][1] == E // P


def test_example_trains_grouped_ep_on_four_ranks():
    """The example's entry point under the launcher's environment: four
    gloo ranks, fp8 wire, two chunks; the row exchanges went over the
    ring."""
    argv = ["--preset", "tiny", "--steps", "2", "--batch", "4", "--seq",
            "16", "--moe_experts", "8", "--moe_top_k", "2",
            "--moe_dispatch", "grouped_ep", "--moe_precision", "fp8",
            "--dispatch_chunks", "2", "--device", "cpu", "--backend",
            "gloo"]
    out = run_local(workers.example_ranks, P, (argv,), timeout=TIMEOUT)
    assert [r["out"]["step"] for r in out] == [2] * P
    stats = out[0]["stats"]
    assert stats["ring_all_to_all"]["calls"] > 0
    assert stats["all_to_all"]["calls"] > 0  # the counts
    assert stats["all_reduce"]["calls"] > 0  # the gradients


def test_kernel_calls_per_layer_on_the_fp8_wire():
    """Per layer, forward and backward, under the default remat
    (dots_saveable): B6 runs the up-projection forward and again in the
    backward's recompute; B4 the down-projection twice the same way,
    then the backward's dequant-space replay (up, down) and the two dx;
    B5 the two dw. Every chunk runs its own products. chip_smoke.py
    pins these counts on the card."""
    kw = dict(num_experts=E, moe_top_k=TOP_K, moe_dispatch="grouped_ep",
              moe_precision="fp8")
    ids = np.random.RandomState(1).randint(0, 256, size=(4, 17))
    layers = llama.llama_tiny().num_layers
    for calls in run_local(workers.count_ranks, P, (kw, (1, 2), ids),
                           timeout=TIMEOUT):
        for chunks in (1, 2):
            assert calls[chunks] == {
                "grouped_matmul_fwd_quant": layers * 2 * chunks,
                "grouped_matmul_fwd": layers * 6 * chunks,
                "grouped_matmul_dw": layers * 2 * chunks}, (chunks, calls)


def test_launcher_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="planted failure on rank 1"):
        run_local(workers.failing_rank, P, timeout=TIMEOUT)


def test_mesh_builds_data_parallel_and_refuses_fsdp():
    """One rank has no group; a (data x fsdp) mesh lays its ranks out
    as the reference does (its groups need the process group: the four
    ranks are built in ``tests/test_torch_fsdp.py``); a tensor axis
    still raises."""
    mesh = MeshPlan(data=1, fsdp=1).build(1)
    assert mesh.group(("data", "fsdp")) is None
    fsdp = MeshPlan(data=2, fsdp=2).build(4)
    coords = [rank_coords(r, fsdp.sizes, fsdp.axis_names)
              for r in range(4)]
    assert [(c["data"], c["fsdp"]) for c in coords] \
        == [(0, 0), (0, 1), (1, 0), (1, 1)]
    with pytest.raises(RuntimeError, match="no process group"):
        fsdp.group(("fsdp",))
    with pytest.raises(NotImplementedError, match="tensor"):
        MeshPlan(data=2, tensor=2).build(4)
