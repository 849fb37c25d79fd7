"""ElasticTrainer: owns the (strategy, train step, state) triple (port of
``dlrover_tpu/trainer/elastic.py``).

Ported: construction, ``prepare`` (a restore from ``ckpt_dir`` when it
holds a checkpoint, else a fresh init), ``step`` with its save cadence,
``restore_state``, ``snapshot``, ``save``, ``latest_checkpoint_step``
and ``finalize``, on one device or over the ranks of
``torch.distributed`` (the world ``trainer.bootstrap.init_worker``
joined). The MoE's ``dispatch_chunks`` and ``moe_precision`` are pinned
on the Context before the step is built, as the reference pins them
before it traces. The rng stream (the ``torch.Generator`` handed to the
loss each step) rides in each checkpoint's metadata, so a resumed run
draws what the uninterrupted one would have. Peer restore, live
reshard, prewarm, retune and ``step_multi`` come with a later slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.checkpoint import (
    CheckpointInterval,
    ElasticCheckpointManager,
    HostSnapshot,
)
from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.parallel.accelerate import (
    AccelerateResult,
    OptimizerFn,
    TrainState,
    _named_leaves,
    accelerate,
)
from dlrover_tpu_torch.parallel.mesh import topology_key
from dlrover_tpu_torch.parallel.strategy import (
    Strategy,
    is_sharded,
    shard_dim,
)

logger = get_logger("trainer.elastic")


class ElasticTrainer:
    """Usage::

        trainer = ElasticTrainer(init_fn, loss_fn, optimizer, example_batch,
                                 strategy, ckpt_dir="/ckpt")
        state = trainer.prepare()          # restores if a checkpoint exists
        for batch in loader:
            state, metrics = trainer.step(state, batch)
    """

    def __init__(
        self,
        init_fn: Callable,
        loss_fn: Callable,
        optimizer: OptimizerFn,
        example_batch: Any,
        strategy: Optional[Strategy] = None,
        ckpt_dir: str = "",
        ckpt_interval: Optional[CheckpointInterval] = None,
        device: DeviceLike = None,
        steps_per_call: Optional[int] = None,
        grad_precision: Optional[str] = None,
        dispatch_chunks: Optional[int] = None,
        moe_precision: Optional[str] = None,
    ):
        self._init_fn = init_fn
        self._loss_fn = loss_fn
        self._optimizer = optimizer
        self._example_batch = example_batch
        self._base_strategy = strategy or Strategy()
        self._device = resolve_device(device)
        ctx = get_context()
        if steps_per_call is None:
            steps_per_call = ctx.steps_per_call
        self.steps_per_call = max(1, int(steps_per_call))
        self.grad_precision = grad_precision
        # the grouped_ep row exchange's chunks and wire precision: the
        # model reads them from the Context at each call
        # (ops.moe.resolve_dispatch_chunks / resolve_moe_precision), so
        # _build pins the Context to this trainer's values
        if dispatch_chunks is None:
            dispatch_chunks = ctx.dispatch_chunks
        self.dispatch_chunks = max(1, int(dispatch_chunks))
        if moe_precision is None:
            moe_precision = ctx.moe_precision or "bf16"
        self.moe_precision = str(moe_precision)
        self._result: Optional[AccelerateResult] = None
        # handed to loss_fn each step (the reference splits a PRNG key
        # per step); the dense model draws nothing from it
        self._rng = torch.Generator(device="cpu").manual_seed(0)
        # host-side mirror of state.step
        self._host_step = 0
        self._ckpt: Optional[ElasticCheckpointManager] = None
        if ckpt_dir:
            self._ckpt = ElasticCheckpointManager(
                ckpt_dir, save_interval=ckpt_interval or CheckpointInterval()
            )

    @property
    def world(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def is_chief(self) -> bool:
        return not dist.is_initialized() or dist.get_rank() == 0

    @property
    def accelerated(self) -> AccelerateResult:
        if self._result is None:
            raise RuntimeError("call prepare() first")
        return self._result

    @property
    def device(self) -> torch.device:
        return self._device

    def _build(self) -> AccelerateResult:
        ctx = get_context()
        ctx.dispatch_chunks = self.dispatch_chunks
        ctx.moe_precision = self.moe_precision
        world = self.world
        strategy = self._base_strategy.adjust_to_world(world)
        result = accelerate(
            self._init_fn, self._loss_fn, self._optimizer,
            self._example_batch, strategy=strategy, device=self._device,
            steps_per_call=self.steps_per_call,
            grad_precision=self.grad_precision,
        )
        if self.is_chief:
            logger.info("built the train step for %s x %d ranks (c=%d, "
                        "p=%s)", topology_key([self._device]), world,
                        self.dispatch_chunks, self.moe_precision)
        return result

    def prepare(self, state: Optional[TrainState] = None) -> TrainState:
        """Build the step; return ``state`` as given, else the newest
        checkpoint restored (staging mirror, then storage, then an older
        step), else a fresh init."""
        if self._result is None:
            self._result = self._build()
        if state is not None:
            self._host_step = int(state.step)
            return state
        state = self._result.init_fn(0)
        self._host_step = 0
        if self._ckpt is not None:
            # the fresh init is the restore's target: it is filled in
            # place, so the optimizer holds the restored tensors
            restored = self._try_restore(state)
            if restored is not None:
                return restored
        return state

    def _shard_dims(self, state: TrainState) -> Optional[Dict[str, int]]:
        """The leaves this rank holds only its part of, with the dim
        they are split on."""
        if self.world == 1:
            return None
        rules = self._result.strategy.rule_set
        return {path: shard_dim(p.dim())
                for path, p in _named_leaves(state.params)
                if is_sharded(rules, path)}

    def _try_restore(self, state: TrainState) -> Optional[TrainState]:
        out = self._ckpt.restore(state, shard_dims=self._shard_dims(state))
        if out is None:
            return None
        rng = out["meta"].get("rng")
        if rng is not None:
            self._rng.set_state(torch.tensor(rng, dtype=torch.uint8))
        self._host_step = int(out["step"])
        logger.info("resumed from step %d", out["step"])
        return out["state"]

    def restore_state(self, state: Optional[TrainState] = None
                      ) -> Optional[TrainState]:
        """Restore the latest checkpoint onto the built step — the
        rollback path. With ``state`` (the live one) its tensors are
        filled in place, so no second copy of the model is made; else a
        fresh init is the target. None without a checkpoint."""
        if self._result is None or self._ckpt is None:
            return None
        if state is None:
            state = self._result.init_fn(0)
        return self._try_restore(state)

    @property
    def checkpoint_manager(self) -> Optional[ElasticCheckpointManager]:
        return self._ckpt

    def restore_snapshot(self, state: TrainState,
                         snapshot: HostSnapshot) -> TrainState:
        """Put ``snapshot`` (of this trainer, ``snapshot()``) back into
        the live ``state`` in place, with the rng stream and host step
        it was taken at."""
        snapshot.restore(state)
        self._rng.set_state(torch.tensor(snapshot.meta["rng"],
                                         dtype=torch.uint8))
        self._host_step = int(snapshot.meta["host_step"])
        return state

    def snapshot(self, state: TrainState) -> HostSnapshot:
        """Host-DRAM copy of the live state (one device-to-host copy a
        leaf, then one sync); its meta holds the strategy, the rng
        stream and the host step, so it is a complete resume point."""
        return HostSnapshot.take(
            state, strategy=self._result.strategy.to_json()
            if self._result else "",
            rng=self._rng.get_state().tolist(),
            host_step=int(self._host_step),
        )

    def step(self, state: TrainState, batch: Any) -> Tuple[TrainState, Dict]:
        state, metrics = self._result.train_step(
            state, self._result.shard_batch(batch), self._rng)
        self._host_step += 1
        step = self._host_step
        if self._ckpt is not None and self._ckpt.interval.should_save(step):
            # never checkpoint a NaN-poisoned state: it would corrupt the
            # rollback/restore target (the one device sync this costs
            # happens only on save steps)
            if "finite" not in metrics or bool(metrics["finite"]):
                self.save(state)
            else:
                logger.warning(
                    "skipping checkpoint at step %d: non-finite state", step
                )
        return state, metrics

    # -- checkpoint ----------------------------------------------------------

    def latest_checkpoint_step(self) -> Optional[int]:
        """Newest restorable step, flushing any in-flight async save
        first; None when no checkpointing is configured or nothing has
        been committed yet (the executor's rollback precondition)."""
        if self._ckpt is None:
            return None
        try:
            self._ckpt.wait()
        except Exception:  # noqa: BLE001
            logger.exception("flushing async checkpoint failed")
        return self._ckpt.latest_step()

    def save(self, state: TrainState, force: bool = True):
        if self._ckpt is None:
            return
        self._ckpt.save(
            int(state.step),
            state,
            metadata={"strategy": self._result.strategy.to_json(),
                      "rng": self._rng.get_state().tolist(),
                      "host_step": int(self._host_step)},
            force=force,
            shard_dims=self._shard_dims(state),
        )

    def finalize(self) -> bool:
        """Flush + close checkpointing. Returns True when a staging
        mirror timed out (``ElasticCheckpointManager.wait``), so exit
        paths (the preemption drain) can report that the host-DRAM
        mirror never committed."""
        timed_out = False
        if self._ckpt is not None:
            timed_out = bool(self._ckpt.wait())
            self._ckpt.close()
        return timed_out
