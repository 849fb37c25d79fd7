"""ElasticTrainer: owns the (strategy, train step, state) triple (port of
``dlrover_tpu/trainer/elastic.py``).

This slice ports construction, ``prepare`` with a fresh init, ``step``
and ``finalize``, on one device or over the ranks of
``torch.distributed`` (the world ``trainer.bootstrap.init_worker``
joined). The MoE's ``dispatch_chunks`` and ``moe_precision`` are pinned
on the Context before the step is built, as the reference pins them
before it traces. Restore, snapshot, live reshard, prewarm and retune
come with the checkpoint slice; a ``ckpt_dir`` raises until then.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.parallel.accelerate import (
    AccelerateResult,
    OptimizerFn,
    TrainState,
    accelerate,
)
from dlrover_tpu_torch.parallel.mesh import topology_key
from dlrover_tpu_torch.parallel.strategy import Strategy

logger = get_logger("trainer.elastic")


class ElasticTrainer:
    """Usage::

        trainer = ElasticTrainer(init_fn, loss_fn, optimizer, example_batch,
                                 strategy)
        state = trainer.prepare()
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
        device: DeviceLike = None,
        steps_per_call: Optional[int] = None,
        grad_precision: Optional[str] = None,
        dispatch_chunks: Optional[int] = None,
        moe_precision: Optional[str] = None,
    ):
        if ckpt_dir:
            raise NotImplementedError("checkpointing is not ported yet "
                                      "(the checkpoint/restore slice)")
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
        """Build the step; return ``state`` as given, or a fresh init."""
        if self._result is None:
            self._result = self._build()
        if state is not None:
            return state
        return self._result.init_fn(0)

    def step(self, state: TrainState, batch: Any) -> Tuple[TrainState, Dict]:
        return self._result.train_step(
            state, self._result.shard_batch(batch), self._rng)

    def finalize(self) -> bool:
        """Flush and close checkpointing; returns True when a staging
        mirror timed out. Nothing to flush in this slice."""
        return False
