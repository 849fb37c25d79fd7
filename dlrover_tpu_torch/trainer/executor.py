"""TrainExecutor: ``train_and_evaluate`` over an ElasticTrainer (port of
``dlrover_tpu/trainer/executor.py``).

This slice ports the step loop with its dispatch window (up to
``train_window`` steps in flight before the oldest one's metrics are
read on the host, so the host does not wait on the device every step),
``log_every_steps``, evaluation, hooks, and the non-finite guardrail
with its policies. Over several ranks only rank 0 logs. Master hooks,
preemption, failover, live reshard and retune come with later slices.
"""

from __future__ import annotations

import collections
import json
import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.telemetry import (
    EventKind,
    SpanName,
    emit_event,
    get_registry,
    names as tm,
    span,
)
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

logger = get_logger("trainer.executor")


class NonFiniteLossError(RuntimeError):
    """A training step produced a non-finite loss or gradient norm and
    the policy (``on_nonfinite``) says to stop."""


@dataclass
class _Inflight:
    last_step: int
    metrics: Dict[str, Any]


class TrainHook:
    def begin(self, executor: "TrainExecutor"):
        pass

    def before_step(self, step: int):
        pass

    def after_step(self, step: int, metrics: Dict[str, Any]):
        pass

    def after_evaluate(self, step: int, metrics: Dict[str, Any]):
        pass

    def end(self, executor: "TrainExecutor"):
        pass


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.item() if value.numel() == 1 else value.tolist()
    return value


class TrainExecutor:
    """Args:
      trainer: an ElasticTrainer (prepared or not).
      train_iter_fn: () -> iterable of host batches.
      eval_fn: optional (state) -> metrics dict.
      conf: Configuration with (all optional) ``train_steps``,
        ``eval_every_steps``, ``log_every_steps``,
        ``check_finite_every_steps``, ``train_window``, ``on_nonfinite``.
    """

    def __init__(
        self,
        trainer: ElasticTrainer,
        train_iter_fn: Callable[[], Iterable],
        eval_fn: Optional[Callable[[Any], Dict]] = None,
        hooks: Optional[List[TrainHook]] = None,
        conf: Optional[Configuration] = None,
    ):
        self._trainer = trainer
        self._train_iter_fn = train_iter_fn
        self._eval_fn = eval_fn
        self._hooks = list(hooks or [])
        conf = conf or Configuration()
        ctx = get_context()
        self._train_steps = int(conf.get("train_steps", 0))
        self._eval_every = int(conf.get("eval_every_steps", 0))
        self._log_every = int(conf.get("log_every_steps", 50))
        self._check_finite_every = int(conf.get(
            "check_finite_every_steps", ctx.check_finite_every_steps))
        self._train_window = max(0, int(conf.get(
            "train_window", ctx.train_window)))
        self._on_nonfinite = str(conf.get("on_nonfinite", ctx.on_nonfinite))
        if self._on_nonfinite == "rollback":
            raise NotImplementedError(
                "on_nonfinite='rollback' restores the last checkpoint, which "
                "comes with the checkpoint/restore slice (ROADMAP A8); use "
                "'halt' or 'ignore'")
        if self._on_nonfinite not in ("halt", "ignore"):
            raise ValueError(f"on_nonfinite={self._on_nonfinite!r}: expected "
                             f"'halt' or 'ignore'")
        self._window: "collections.deque[_Inflight]" = collections.deque()
        reg = get_registry()
        self._h_step_time = reg.histogram(
            tm.STEP_TIME, help="per-optimizer-step wall time, observed at "
                               "(lagged) materialization")
        self._h_dispatch = reg.histogram(
            tm.STEP_DISPATCH_TIME,
            help="host time dispatching one train-step call")
        self._h_host_sync = reg.histogram(
            tm.STEP_HOST_SYNC_TIME,
            help="host time blocked reading the oldest in-flight step")
        self._c_steps = reg.counter(
            tm.TRAIN_STEPS, help="optimizer steps materialized")
        self._c_nonfinite = reg.counter(
            tm.NONFINITE_STEPS, help="non-finite steps detected")
        self._h_eval = reg.histogram(tm.EVAL_TIME, help="eval_fn wall time")
        self._last_log = time.monotonic()
        self._last_materialize = time.monotonic()
        self._started: Optional[float] = None
        self._last_metrics: Optional[Dict[str, Any]] = None
        self.state: Any = None
        self.eval_metrics: Dict[str, Any] = {}
        self._last_eval_step = -1

    # -- non-finite guardrail ---------------------------------------------

    @staticmethod
    def _step_is_finite(metrics: Dict[str, Any]) -> bool:
        if "finite" in metrics:
            return bool(metrics["finite"])
        try:
            return math.isfinite(float(metrics.get("loss", 0.0)))
        except (TypeError, ValueError):
            return True

    def _report_nonfinite(self, step: int, metrics: Dict[str, Any]) -> str:
        detail = json.dumps({
            "step": step,
            "loss": repr(metrics.get("loss")),
            "grad_norm": repr(metrics.get("grad_norm")),
            "reason": "non-finite loss/gradients",
        })
        logger.error("non-finite training step: %s", detail)
        self._c_nonfinite.inc()
        emit_event(EventKind.NONFINITE_STEP, error_code="NONFINITE",
                   step=step, policy=self._on_nonfinite)
        return detail

    def _handle_nonfinite(self, step: int, metrics: Dict[str, Any]) -> None:
        detail = self._report_nonfinite(step, metrics)
        if self._on_nonfinite == "halt":
            raise NonFiniteLossError(detail)

    # -- loop ---------------------------------------------------------------

    def _materialize_oldest(self) -> None:
        """Read the oldest in-flight step's metrics on the host (the one
        device sync of the loop) and run the lagged consumers: hooks,
        the finite check, the speed log."""
        entry = self._window.popleft()
        t_sync = time.monotonic()
        with span(SpanName.HOST_SYNC, step=entry.last_step):
            host = {k: _to_host(v) for k, v in entry.metrics.items()}
        now = time.monotonic()
        self._h_host_sync.observe(now - t_sync)
        if self._started is not None:
            emit_event(EventKind.COMPILE_FIRST_STEP, step=entry.last_step,
                       seconds=round(now - self._started, 3))
            self._started = None
        self._h_step_time.observe(now - self._last_materialize)
        self._last_materialize = now
        self._c_steps.inc()
        s = entry.last_step
        self._last_metrics = host
        for hook in self._hooks:
            hook.after_step(s, host)
        if (self._check_finite_every and s % self._check_finite_every == 0
                and not self._step_is_finite(host)):
            self._handle_nonfinite(s, host)
        if (self._log_every and s % self._log_every == 0
                and self._trainer.is_chief):
            dt = now - self._last_log
            self._last_log = now
            logger.info("step %d loss=%.4f (%.2f steps/s)", s,
                        float(host.get("loss", float("nan"))),
                        self._log_every / max(dt, 1e-9))

    def _trim_window(self, limit: int) -> None:
        while len(self._window) > limit:
            self._materialize_oldest()

    def train_and_evaluate(self) -> Dict[str, Any]:
        self.state = self._trainer.prepare(self.state)
        for hook in self._hooks:
            hook.begin(self)
        step = int(self.state.step)
        self._window.clear()
        self._last_log = self._last_materialize = time.monotonic()
        self._started = time.monotonic()
        emit_event(EventKind.TRAIN_START, step=step,
                   train_window=self._train_window, steps_per_call=1)
        data_iter = iter(self._train_iter_fn())
        while not (self._train_steps and step >= self._train_steps):
            try:
                batch = next(data_iter)
            except StopIteration:
                break  # data source exhausted
            for hook in self._hooks:
                hook.before_step(step + 1)
            t_disp = time.monotonic()
            with span(SpanName.STEP_DISPATCH, step=step + 1):
                self.state, metrics = self._trainer.step(self.state, batch)
            self._h_dispatch.observe(time.monotonic() - t_disp)
            step += 1
            self._window.append(_Inflight(step, metrics))
            self._trim_window(self._train_window)
            if self._eval_every and step % self._eval_every == 0:
                self._trim_window(0)
                self._evaluate(step)
        self._trim_window(0)
        return self._finish(step)

    def _evaluate(self, step: int):
        if self._eval_fn is None or step == self._last_eval_step:
            return
        self._last_eval_step = step
        t0 = time.monotonic()
        with span(SpanName.EVALUATE, step=step):
            self.eval_metrics = {k: _to_host(v) for k, v in
                                 self._eval_fn(self.state).items()}
        self._h_eval.observe(time.monotonic() - t0)
        if self._trainer.is_chief:
            logger.info("eval @%d: %s", step, self.eval_metrics)
        for hook in self._hooks:
            hook.after_evaluate(step, self.eval_metrics)

    def _finish(self, step: int) -> Dict[str, Any]:
        if self._eval_fn is not None:
            self._evaluate(step)
        if (self._last_metrics is not None
                and not self._step_is_finite(self._last_metrics)):
            # the NaN landed between check cadences, or the policy let
            # it pass: report it, and under "halt" fail the run
            detail = self._report_nonfinite(step, self._last_metrics)
            if self._on_nonfinite == "halt":
                raise NonFiniteLossError(f"final step non-finite: {detail}")
        self._trainer.finalize()
        emit_event(EventKind.TRAIN_END, step=step)
        for hook in self._hooks:
            hook.end(self)
        return {"step": step, **self.eval_metrics}
