"""FSDP in the port (``parallel.sharding_rules``, the ``(data x fsdp)``
meshes of ``parallel.mesh``, ``ops.ring``'s all-gather and
reduce-scatter, the sharded state of ``parallel.accelerate``, its
checkpoints and live reshard) against the JAX package's fsdp meshes.

The port's ranks are spawned gloo processes on the CPU
(``trainer.run.run_local``; the rank functions are in
``tests/torch_fsdp_workers.py``), each spawn run once per module and
checked by many tests. The JAX side runs on four of the eight virtual
CPU devices (``tests/conftest.py``) at the same mesh.

Tolerances (f32 on both sides, measured on the CPU):
  - specs, block shapes, layouts: equal;
  - the port against the reference, same init and batches, 3 AdamW
    steps at lr 1e-2: losses 1e-5 relative, final parameters 1e-4
    absolute (XLA's and torch's f32 sums differ in their last bits, and
    Adam's normalised update lifts such bits of a near-zero gradient
    toward a step of ``lr``; measured: 4.1e-5 on one element of 16384,
    the rest below 2e-5);
  - ``moe_ep`` at (2, 2): losses 1e-4 relative, as
    ``tests/test_torch_ep.py``;
  - the port at (1, 4) against the port at (4, 1): losses 1e-6
    relative (the sums run in another order);
  - ``grad_accum_steps=2`` against the full batch: losses 1e-6
    relative, parameters 1e-4 absolute (the same lift through Adam's
    normalised update; measured: 2.0e-5 on one element of 8192);
  - the one-rank init against the gathered init, a checkpoint's
    restores, a live reshard against its cold path, a retune's
    regrouped state: bit for bit;
  - the live reshard against the reference's: 1e-4 relative.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.checkpoint import ElasticCheckpointManager as JaxManager
from dlrover_tpu.checkpoint import abstract_like
from dlrover_tpu.models import glm as jax_glm
from dlrover_tpu.models import llama as jax_llama
from dlrover_tpu.parallel.accelerate import accelerate as jax_accelerate
from dlrover_tpu.parallel.mesh import MeshPlan as JaxMeshPlan
from dlrover_tpu.parallel.sharding_rules import _flatten_with_paths
from dlrover_tpu.parallel.strategy import RULE_SETS as JAX_RULE_SETS
from dlrover_tpu.parallel.strategy import Strategy as JaxStrategy
from dlrover_tpu.trainer.elastic import ElasticTrainer as JaxTrainer
from dlrover_tpu_torch import interop
from dlrover_tpu_torch.models import glm, llama
from dlrover_tpu_torch.parallel import sharding_rules
from dlrover_tpu_torch.parallel.mesh import MeshPlan
from dlrover_tpu_torch.parallel.strategy import RULE_SETS, Strategy
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.run import run_local

import torch_fsdp_workers as workers

P, TIMEOUT, LR = 4, 300, 1e-2
MESHES = [(1, 2), (2, 2), (1, 4), (4, 1), (1, 8), (2, 4)]
MOE_KW = dict(num_experts=8, moe_top_k=2, moe_dispatch="grouped_ep")


def _batches(vocab, n, seed, rows=8, seq=16):
    ids = np.random.RandomState(seed).randint(0, vocab,
                                              size=(n, rows, seq + 1))
    return [{"input_ids": b[:, :-1], "labels": b[:, 1:]} for b in ids]


def _sizes(data, fsdp):
    return {"pipe": 1, "data": data, "fsdp": fsdp, "seq": 1, "tensor": 1}


# -- the rule tables ------------------------------------------------------------


def _jax_trees():
    key = jax.random.PRNGKey(0)

    def shapes(init, config):
        return jax.eval_shape(lambda k: init(k, config), key)

    return {
        "dense": shapes(jax_llama.init, jax_llama.llama_tiny()),
        "dense4": shapes(jax_llama.init, jax_llama.llama_tiny(num_layers=4)),
        "moe": shapes(jax_llama.init, jax_llama.llama_tiny(**MOE_KW)),
        "glm": shapes(jax_glm.init, jax_glm.glm_tiny()),
    }


def _port_trees():
    gen = torch.Generator().manual_seed(0)
    return {
        "dense": llama.init(gen, llama.llama_tiny()),
        "dense4": llama.init(gen, llama.llama_tiny(num_layers=4)),
        "moe": llama.init(gen, llama.llama_tiny(**MOE_KW)),
        "glm": glm.init(gen, glm.glm_tiny()),
    }


_JAX_TREES, _PORT_TREES = {}, {}


def _trees():
    if not _JAX_TREES:
        _JAX_TREES.update(_jax_trees())
        _PORT_TREES.update(_port_trees())
    return _JAX_TREES, _PORT_TREES


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("rule_set", ["fsdp", "llama", "moe", "moe_ep",
                                      "glm"])
@pytest.mark.parametrize("tree", ["dense", "dense4", "moe", "glm"])
def test_specs_equal_the_reference(tree, rule_set, mesh):
    """``tree_specs`` gives every leaf the reference's ``spec_for``,
    spec for spec, path for path."""
    jax_trees, port_trees = _trees()
    sizes = _sizes(*mesh)
    theirs = JAX_RULE_SETS[rule_set]()
    want = {path: theirs.spec_for(path, leaf.shape, sizes)
            for path, leaf in _flatten_with_paths(jax_trees[tree])}
    got = sharding_rules.tree_specs(RULE_SETS[rule_set](), sizes,
                                    port_trees[tree])
    assert got == want


def test_the_layer_dim_shards_only_where_fsdp_divides_it():
    """The stacked [L, ...] layer dim goes on fsdp where L % fsdp == 0
    (2 layers over 2), and replicates otherwise (4 layers over 8). The
    norm scales shard under "fsdp" (FSDP_AUTO on every leaf) and
    replicate under "llama"."""
    _, trees = _trees()
    rules = RULE_SETS["llama"]()
    two = sharding_rules.tree_specs(rules, _sizes(1, 2), trees["dense"])
    four = sharding_rules.tree_specs(rules, _sizes(1, 8), trees["dense4"])
    assert two["layers/q_proj/kernel"] == ("fsdp", None, None)
    assert four["layers/q_proj/kernel"] == (None, None, None)
    assert two["layers/input_norm/scale"] == (None, None)
    auto = sharding_rules.tree_specs(RULE_SETS["fsdp"](), _sizes(1, 2),
                                     trees["dense"])
    assert auto["layers/input_norm/scale"] == (None, "fsdp")
    assert auto["norm/scale"] == ("fsdp",)


def test_rule_sets_and_their_refusals():
    """The ported rule sets carry the reference's names; the reference's
    others name the ROADMAP item of their model; the batch splits over
    (data, fsdp) as ``batch_sharding`` does there."""
    assert set(RULE_SETS) < set(JAX_RULE_SETS)
    for name in set(JAX_RULE_SETS) - set(RULE_SETS):
        with pytest.raises(NotImplementedError, match="ROADMAP A1[57]"):
            Strategy(rule_set=name).rules()
    with pytest.raises(ValueError, match="unknown rule set"):
        Strategy(rule_set="nope").rules()
    assert sharding_rules.batch_sharding() == (("data", "fsdp"),)


# -- the reference's runs -------------------------------------------------------


def _jax_blocks(state):
    """Device id -> {path: shard shape} of the params and Adam's mu."""
    out = {}
    for prefix, tree in (("params", state.params),
                         ("mu", state.opt_state[0].mu)):
        for path, leaf in _flatten_with_paths(tree):
            for shard in leaf.addressable_shards:
                out.setdefault(shard.device.id, {})[f"{prefix}/{path}"] = \
                    tuple(shard.data.shape)
    return out


def _jax_run(jcfg, mesh, batches, lr, rule_set="llama", accum=1):
    result = jax_accelerate(
        jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
        optax.adamw(lr, weight_decay=0.1) if rule_set == "llama"
        else optax.adam(lr), batches[0],
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=mesh[0], fsdp=mesh[1]),
                             rule_set=rule_set, grad_accum_steps=accum),
        devices=jax.devices()[:mesh[0] * mesh[1]])
    state = result.init_fn(jax.random.PRNGKey(0))
    tree = jax.device_get(state.params)
    losses, metrics = [], []
    for i, batch in enumerate(batches):
        state, m = result.train_step(state, result.shard_batch(batch),
                                     jax.random.PRNGKey(i))
        losses.append(float(m["loss"]))
        metrics.append(jax.device_get(m))
    return {"tree": tree, "losses": losses, "metrics": metrics,
            "params": jax.device_get(state.params),
            "blocks": _jax_blocks(state)}


def _orbax_state(tmp, jcfg, batches, lr):
    """A reference fsdp run at (2, 2), checkpointed by Orbax and read
    back: its state as numpy, and its losses over ``batches``."""
    trainer = JaxTrainer(
        jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
        optax.adamw(lr, weight_decay=0.1), batches[0],
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=2, fsdp=2),
                             rule_set="llama"),
        devices=jax.devices()[:P])
    state = trainer.prepare()
    for b in batches[:2]:
        state, _ = trainer.step(state, b)
    mgr = JaxManager(str(tmp / "orbax"), async_save=False)
    assert mgr.save(2, state, force=True)
    mgr.wait()
    state = mgr.restore(abstract_like(
        state, trainer.accelerated.state_sharding))["state"]
    mgr.close()
    host = jax.device_get(state)
    adam = host.opt_state[0]
    losses = []
    for b in batches[2:]:
        state, m = trainer.step(state, b)
        losses.append(float(m["loss"]))
    return {"step": int(host.step), "params": host.params, "lr": lr,
            "adam": {"count": np.asarray(adam.count), "mu": adam.mu,
                     "nu": adam.nu}}, losses


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    jcfg = jax_llama.llama_tiny()
    batches = _batches(jcfg.vocab_size, 3, 0)
    want = {mesh: _jax_run(jcfg, mesh, batches, LR)
            for mesh in ((1, 4), (2, 2))}
    tree = want[(2, 2)]["tree"]
    orbax_batches = _batches(jcfg.vocab_size, 4, 1)
    host, orbax_losses = _orbax_state(tmp, jcfg, orbax_batches, LR)
    ckpt = str(tmp / "ckpt")
    got = run_local(workers.dense_ranks, P,
                    (tree, {}, batches, LR, ckpt, host, orbax_batches[2:]),
                    timeout=TIMEOUT)
    mcfg = jax_llama.llama_tiny(**MOE_KW)
    moe_batches = _batches(mcfg.vocab_size, 3, 4)
    moe_want = _jax_run(mcfg, (1, 2), moe_batches, LR, "moe_ep", accum=2)
    restored = run_local(workers.restore_ranks, 2,
                         (tree, {}, batches[0], LR, ckpt, moe_want["tree"],
                          MOE_KW, moe_batches), timeout=TIMEOUT)
    return {"want": want, "got": got, "tree": tree, "batches": batches,
            "orbax": orbax_losses, "restored": restored, "ckpt": ckpt,
            "moe_accum": moe_want["losses"]}


def _params(arrays):
    return {k[len("params/"):]: v for k, v in arrays.items()
            if k.startswith("params/")}


class TestMeshAndLayout:
    def test_rank_layout_and_groups_equal_the_reference(self, dense):
        """The reference's device mesh for MeshPlan(data=2, fsdp=2) on
        four devices holds device r where the port puts rank r; the
        port's fsdp groups are its rows, its data groups its columns,
        and the group over both axes is the world."""
        devices = JaxMeshPlan(data=2, fsdp=2).build(
            jax.devices()[:P]).devices.reshape(2, 2)
        ids = np.vectorize(lambda d: d.id)(devices)
        for rank, r in enumerate(dense["got"]):
            i, j = r["groups"]["coords"]
            assert ids[i, j] == rank
            assert r["groups"]["fsdp"] == ids[i, :].tolist()
            assert r["groups"]["data"] == ids[:, j].tolist()
            assert r["groups"]["both"] == list(range(P))

    def test_a_rebuilt_mesh_reuses_its_groups(self, dense):
        """A second build of the same mesh over the same world hands out
        the groups of the first (no new communicators a build)."""
        for r in dense["got"]:
            assert r["groups"]["reused"]

    @pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                             ids=lambda m: f"{m[0]}x{m[1]}")
    def test_block_shapes_equal_the_reference_shards(self, dense, mesh):
        """Rank r's parameters and first moments have the shapes of the
        reference's shards on device r, leaf for leaf."""
        theirs = dense["want"][mesh]["blocks"]
        for rank, r in enumerate(dense["got"]):
            blocks = r["runs"][mesh]["blocks"]
            want = theirs[rank]
            for key, shape in want.items():
                kind, path = key.split("/", 1)
                ours = (f"params/{path}" if kind == "params"
                        else f"opt/{path}/exp_avg")
                assert blocks[ours] == shape, (rank, key)

    def test_each_rank_holds_a_quarter_or_half_of_the_sharded_leaves(
            self, dense):
        tree = dense["tree"]
        full = {p: np.shape(a) for p, a in
                zip(workers.leaf_paths(tree), _flat(tree))}
        for mesh, f in (((1, 4), 4), ((2, 2), 2)):
            for r in dense["got"]:
                run = r["runs"][mesh]
                assert run["sharded"]
                for path in run["sharded"]:
                    got = int(np.prod(run["blocks"][f"params/{path}"]))
                    assert got * f == int(np.prod(full[path])), path

    def test_specs_of_the_built_step(self, dense):
        r = dense["got"][0]["runs"]
        assert r[(2, 2)]["specs"]["layers/q_proj/kernel"] == \
            ("fsdp", None, None)
        assert r[(1, 4)]["specs"]["layers/q_proj/kernel"] == \
            (None, None, None)  # 2 layers over 4: replicated
        assert r[(1, 4)]["specs"]["lm_head/kernel"] == ("fsdp", None)
        assert r[(4, 1)]["sharded"] == []


def _flat(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flat(tree[k])]
    return [tree]


class TestDenseAgainstTheReference:
    @pytest.mark.parametrize("mesh", [(1, 4), (2, 2)],
                             ids=lambda m: f"{m[0]}x{m[1]}")
    def test_three_steps_match_the_jax_accelerate(self, dense, mesh):
        want = dense["want"][mesh]
        for r in dense["got"]:
            run = r["runs"][mesh]
            np.testing.assert_allclose(run["losses"], want["losses"],
                                       rtol=1e-5)
            ours = _params(run["state"])
            for path, leaf in zip(workers.leaf_paths(want["params"]),
                                  _flat(want["params"])):
                np.testing.assert_allclose(ours[path], leaf, rtol=0,
                                           atol=1e-4, err_msg=path)
        assert want["losses"][-1] < want["losses"][0]

    def test_fsdp_against_data_parallel(self, dense):
        """(1, 4) and (4, 1) in the port: the same losses to 1e-6
        relative (not bit for bit: the sums run in another order)."""
        for r in dense["got"]:
            runs = r["runs"]
            np.testing.assert_allclose(runs[(1, 4)]["losses"],
                                       runs[(4, 1)]["losses"], rtol=1e-6)
            np.testing.assert_allclose(runs[(2, 2)]["losses"],
                                       runs[(4, 1)]["losses"], rtol=1e-6)

    def test_every_rank_reports_the_same_global_loss(self, dense):
        for mesh in ((1, 4), (2, 2), (4, 1)):
            losses = {tuple(r["runs"][mesh]["losses"]) for r in dense["got"]}
            assert len(losses) == 1, mesh

    def test_grad_accumulation_equals_the_full_batch(self, dense):
        for r in dense["got"]:
            full = r["runs"][(2, 2)]
            np.testing.assert_allclose(r["accum"]["losses"], full["losses"],
                                       rtol=1e-6)
            for key, a in full["state"].items():
                np.testing.assert_allclose(r["accum"]["state"][key], a,
                                           rtol=0, atol=1e-4, err_msg=key)

    def test_microbatches_are_the_reference_s(self, dense):
        """With two microbatches a rank takes its block of each half of
        the global batch, as the reference cuts the global batch into
        microbatches before it splits them over the devices (rank r of
        4 holds rows r and 4 + r of 8)."""
        for rank, r in enumerate(dense["got"]):
            assert r["accum_rows"] == [rank, 4 + rank]

    @pytest.mark.parametrize("rows", ["global", "local"])
    @pytest.mark.parametrize("mesh", [(1, 2), (2, 1)],
                             ids=lambda m: f"{m[0]}x{m[1]}")
    def test_moe_ep_with_microbatches_matches_the_reference(self, dense,
                                                            mesh, rows):
        """``moe_ep`` with two microbatches a step on two ranks, fed the
        global rows or each process's own rows (the reference's
        process-local ``put_global_batch``): the load-balancing loss
        depends on which rows share a microbatch, so the losses agree
        with the reference's only when the rows do (1e-5 relative)."""
        key = "moe_accum" if rows == "global" else "moe_accum_local"
        for r in dense["restored"]:
            np.testing.assert_allclose(r[key][mesh], dense["moe_accum"],
                                       rtol=1e-5)

    def test_one_rank_init_equals_the_gathered_init(self, dense):
        want = llama.init(torch.Generator().manual_seed(0),
                          llama.llama_tiny())
        for r in dense["got"]:
            got = _params(r["init"])
            for path, leaf in zip(workers.leaf_paths(want), _flat(want)):
                assert got[path].tobytes() == leaf.numpy().tobytes(), path

    def test_global_and_process_local_rows_give_the_same_blocks(self,
                                                               dense):
        """With one microbatch and with two: with two, each process's
        rows are gathered into the global batch first, so a rank's
        microbatch blocks are the reference's either way."""
        for r in dense["got"]:
            assert r["batch_same"]
            assert r["accum_batch_same"]
            assert "takes the global batch (8 rows) or this process's " \
                   "rows (2" in r["batch_error"]

    def test_exchange_bytes_per_step(self, dense):
        """A step gathers each sharded leaf once and scatters its
        gradient once: both count the global leaf's bytes."""
        tree = dense["tree"]
        full = dict(zip(workers.leaf_paths(tree), _flat(tree)))
        for mesh in ((1, 4), (2, 2)):
            for r in dense["got"]:
                run = r["runs"][mesh]
                nbytes = sum(full[p].nbytes for p in run["sharded"])
                steps = len(run["losses"])
                for kind in ("all_gather", "reduce_scatter"):
                    assert run["stats"][kind]["calls"] == \
                        steps * len(run["sharded"])
                    assert run["stats"][kind]["bytes"] == steps * nbytes
        assert "all_gather" not in dense["got"][0]["runs"][(4, 1)]["stats"]


class TestExchanges:
    @pytest.mark.parametrize("group", ["world", "fsdp"])
    def test_gather_and_scatter_are_adjoint_in_f64(self, dense, group):
        """Forward values and the gradients of both exchanges against
        their sums in f64, and the adjoint identity."""
        for r in dense["got"]:
            x = r["exchanges"][group]
            assert x["gather_err"] == 0.0 and x["scatter_err"] < 1e-12
            assert x["x_grad_err"] < 1e-12 and x["y_grad_err"] == 0.0
            np.testing.assert_allclose(*x["adjoint"], rtol=1e-12)

    @pytest.mark.parametrize("group", ["world", "fsdp"])
    def test_stats_and_counted_bytes_follow_the_formula(self, dense, group):
        for r in dense["got"]:
            x = r["exchanges"][group]
            full = 3 * 2 * x["size"] * 5 * 8  # the gathered f64 tensor
            assert x["stats"]["all_gather"]["calls"] == 2
            assert x["stats"]["all_gather"]["bytes"] == 2 * full
            assert x["stats"]["reduce_scatter"]["calls"] == 3
            assert x["stats"]["reduce_scatter"]["bytes"] == 3 * full
            assert x["counted"] == {"all-gather": full,
                                    "reduce-scatter": full}
            assert x["meta_shape"] == (3, 2 * x["size"], 5)


class TestCheckpoint:
    def test_restores_at_four_ranks_data_parallel(self, dense):
        for r in dense["got"]:
            assert r["restored_step"] == 2
            assert sorted(r["restored_41"]) == sorted(r["saved"])
            for key, a in r["saved"].items():
                assert r["restored_41"][key].tobytes() == a.tobytes(), key

    def test_restores_at_one_by_two(self, dense):
        saved = dense["got"][0]["saved"]
        for r in dense["restored"]:
            assert r["step"] == 2
            for key, a in saved.items():
                assert r["restored"][key].tobytes() == a.tobytes(), key

    def test_restores_on_one_rank(self, dense):
        trainer = ElasticTrainer(
            lambda gen: interop.params_from_numpy(dense["tree"], "cpu"),
            llama.make_loss_fn(llama.llama_tiny()), workers._adamw(LR),
            dense["batches"][0], strategy=Strategy(
                mesh=MeshPlan(data=1, fsdp=1), rule_set="llama"),
            ckpt_dir=dense["ckpt"], device="cpu")
        state = trainer.prepare()
        trainer.finalize()
        assert state.step == 2
        got = workers.gathered(trainer.accelerated, state)
        for key, a in dense["got"][0]["saved"].items():
            assert got[key].tobytes() == a.tobytes(), key

    def test_each_block_is_saved_at_its_rank(self, dense):
        for r in dense["got"]:
            blocks = r["saved_blocks"]
            assert blocks["params/lm_head/kernel"] == (32, 256)
            assert blocks["opt/lm_head/kernel/exp_avg"] == (32, 256)
            assert blocks["params/norm/scale"] == (64,)

    def test_the_reference_checkpoint_resumes_in_the_port(self, dense):
        """An Orbax checkpoint of the reference's (2, 2) run, read back
        and cut to each rank's blocks by ``interop``, trains on in the
        port at (2, 2) to the reference's losses."""
        for r in dense["got"]:
            np.testing.assert_allclose(r["orbax"]["losses"], dense["orbax"],
                                       rtol=1e-5)


class TestRetuneAndAttribution:
    def test_prewarm_and_retune_take_fsdp_meshes(self, dense):
        for r in dense["got"]:
            x = r["retune"]
            assert x["prewarm_built"] is True
            assert x["mesh"] == {"data": 2, "fsdp": 2}
            assert x["same"]  # regrouped bit for bit
            assert x["blocks"]["params/layers/q_proj/kernel"] == (1, 64, 64)
            np.testing.assert_allclose(
                x["losses"], r["runs"][(4, 1)]["losses"][1:], rtol=1e-6)

    def test_exposed_comm_reads_the_exchanges_host_seconds(self):
        """Given the exchanges' host seconds, the exposed share is theirs,
        within the compute bound's; without them, the bound."""
        from dlrover_tpu_torch.telemetry.attribution import (
            AttributionRecord,
        )

        record = AttributionRecord(predicted_compute_s=0.25)
        assert record.exposed_comm_fraction(1.0) == 0.75
        assert record.exposed_comm_fraction(1.0, exchange_s=0.5) == 0.5
        assert record.exposed_comm_fraction(1.0, exchange_s=0.9) == 0.75
        assert record.exposed_comm_fraction(0.0, exchange_s=0.5) == 0.0

    def test_the_executor_s_gauge_is_the_exchanges_share(self, dense):
        """Through ``TrainExecutor`` on two gloo ranks at (1, 2): every
        measured step hands the gauge the seconds of ``ring.STATS``'s
        exchanges (all-gathers, reduce-scatters, all-reduces) in its
        window, and the gauge is their share of it, within the compute
        bound (~1 at a peak of 1e18 FLOP/s). The last window, drained at
        the end, holds no dispatch and so no exchange."""
        for r in dense["restored"]:
            seen = r["exposed"]
            assert len(seen) == 4
            for per_step, exchange_s, gauge, compute_s in seen:
                assert exchange_s is not None and exchange_s >= 0.0
                bound = min(max(1.0 - compute_s / per_step, 0.0), 1.0)
                assert gauge == pytest.approx(
                    min(exchange_s / per_step, bound), rel=1e-12)
            assert all(0.0 < g < 1.0 - c / p for p, _, g, c in seen[:-1])

    def test_capture_counts_gather_and_scatter_bytes(self, dense):
        """On the meta device at (1, 2): the all-gathers and
        reduce-scatters by kind, each the bytes of every sharded leaf;
        the matmul FLOPs those of the data-parallel step."""
        for r in dense["restored"]:
            fsdp, dp = r["counts"][(1, 2)], r["counts"][(2, 1)]
            assert fsdp["gathered_bytes"] > 0
            assert fsdp["collective"]["all-gather"] == \
                fsdp["gathered_bytes"]
            assert fsdp["collective"]["reduce-scatter"] == \
                fsdp["gathered_bytes"]
            assert "all-gather" not in dp["collective"]
            assert fsdp["matmul_flops"] == dp["matmul_flops"]


# -- expert parallel over (data x fsdp) -------------------------------------------


@pytest.fixture(scope="module")
def moe_ep():
    jcfg = jax_llama.llama_tiny(**MOE_KW)
    batches = _batches(jcfg.vocab_size, 3, 2)
    want = _jax_run(jcfg, (2, 2), batches, LR, rule_set="moe_ep")
    got = run_local(workers.moe_ep_ranks, P,
                    (want["tree"], MOE_KW, batches, LR), timeout=TIMEOUT)
    return want, got


class TestExpertParallel:
    def test_three_steps_match_the_reference_at_two_by_two(self, moe_ep):
        want, got = moe_ep
        losses = want["losses"]
        for r in got:
            np.testing.assert_allclose([float(s["loss"]) for s in r["steps"]],
                                       losses, rtol=1e-4)
            for s, w in zip(r["steps"], want["metrics"]):
                assert float(s["moe_dropped_frac"]) == 0.0
                np.testing.assert_allclose(s["grad_norm"],
                                           float(w["grad_norm"]), rtol=1e-3)

    def test_blocks_equal_the_reference_shards(self, moe_ep):
        """The experts split over all four ranks, the dense leaves over
        each fsdp pair, as the reference's shards."""
        want, got = moe_ep
        for rank, r in enumerate(got):
            assert r["consumed"] == ["layers/experts/down/kernel",
                                     "layers/experts/up/kernel"]
            for key, shape in want["blocks"][rank].items():
                kind, path = key.split("/", 1)
                ours = (f"params/{path}" if kind == "params"
                        else f"opt/{path}/exp_avg")
                assert r["blocks"][ours] == shape, (rank, key)


# -- a change of world: (2, 2) on four ranks to (1, 2) on two ------------------------


BEFORE = 2


def _jax_live_reshard(jcfg, rule_set, batches):
    trainer = JaxTrainer(
        jax_llama.make_init_fn(jcfg), jax_llama.make_loss_fn(jcfg),
        optax.adam(LR), batches[0],
        strategy=JaxStrategy(mesh=JaxMeshPlan(data=2, fsdp=2),
                             rule_set=rule_set),
        devices=jax.devices()[:P])
    state = trainer.prepare()
    tree = jax.device_get(state.params)
    losses = []
    for i, batch in enumerate(batches):
        if i == BEFORE:
            state = trainer.live_reshard(state, devices=jax.devices()[:2])
            mesh = trainer.accelerated.strategy.mesh
            assert (mesh.data, mesh.fsdp) == (1, 2)
        state, metrics = trainer.step(state, batch)
        losses.append(float(metrics["loss"]))
    return tree, losses


@pytest.fixture(scope="module", params=["llama", "moe_ep"])
def reshard(request):
    kw = MOE_KW if request.param == "moe_ep" else {}
    jcfg = jax_llama.llama_tiny(**kw)
    batches = _batches(jcfg.vocab_size, 2 * BEFORE, 3)
    tree, want = _jax_live_reshard(jcfg, request.param, batches)
    got = run_local(workers.reshard_ranks, P,
                    (tree, kw, batches, LR, BEFORE, request.param),
                    timeout=TIMEOUT)
    return request.param, want, got


class TestLiveReshard:
    def test_two_ranks_go_on_at_one_by_two(self, reshard):
        _, _, got = reshard
        assert [r.get("left", False) for r in got] == [False, False, True,
                                                       True]
        for r in got[:2]:
            assert r["world_after"] == 2
            assert r["mesh_after"] == {"data": 1, "fsdp": 2}
            assert r["accum_after"] == 2

    def test_survivors_hold_their_blocks_of_the_state_before(self, reshard):
        """Right after the change the gathered state is the one before
        it, bit for bit: every block moved to its new owner."""
        _, _, got = reshard
        for r in got[:2]:
            assert sorted(r["after"]) == sorted(got[0]["before"])
            for key, a in got[0]["before"].items():
                assert r["after"][key].tobytes() == a.tobytes(), key

    def test_live_path_equals_the_cold_path_bit_for_bit(self, reshard):
        _, _, got = reshard
        for r in got[:2]:
            assert r["live"] == r["cold"]
            for key, a in r["live_state"].items():
                assert r["cold_state"][key].tobytes() == a.tobytes(), key

    def test_losses_match_the_jax_live_reshard(self, reshard):
        _, want, got = reshard
        for r in got[:2]:
            np.testing.assert_allclose(r["losses"] + r["live"], want,
                                       rtol=1e-4)
