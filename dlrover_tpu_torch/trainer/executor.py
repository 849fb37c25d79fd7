"""TrainExecutor: ``train_and_evaluate`` over an ElasticTrainer (port of
``dlrover_tpu/trainer/executor.py``).

Ported: the step loop with its dispatch window (up to ``train_window``
steps in flight before the oldest one's metrics are read on the host,
so the host does not wait on the device every step),
``log_every_steps``, evaluation, hooks, the non-finite guardrail with
its policies (``rollback`` restores the newest checkpoint onto the built
trainer, at most ``max_nonfinite_rollbacks`` times), the final forced
save, and the preemption drain (SIGTERM: materialize the in-flight
steps, save, end cleanly). Over several ranks only rank 0 logs. Master
hooks and reports, failover, live reshard and retune come with later
slices.
"""

from __future__ import annotations

import collections
import json
import math
import signal
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
        ``check_finite_every_steps``, ``train_window``, ``on_nonfinite``,
        ``max_nonfinite_rollbacks`` (3), ``preemption_grace`` (True).
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
        if self._on_nonfinite not in ("halt", "ignore", "rollback"):
            raise ValueError(f"on_nonfinite={self._on_nonfinite!r}: expected "
                             f"'halt', 'ignore' or 'rollback'")
        self._max_rollbacks = int(conf.get("max_nonfinite_rollbacks", 3))
        self._rollbacks = 0
        # preemption grace: bound lost work by an emergency save, not by
        # the periodic cadence
        self._preempt_grace = bool(conf.get("preemption_grace", True))
        self._preempted: Optional[int] = None
        self._prev_handlers: Dict[int, Any] = {}
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
        self._c_rollbacks = reg.counter(
            tm.NONFINITE_ROLLBACKS, help="checkpoint rollbacks taken")
        self._c_preempt = reg.counter(
            tm.PREEMPT_NOTICES, help="preemption notices received")
        self._h_eval = reg.histogram(tm.EVAL_TIME, help="eval_fn wall time")
        self._last_log = time.monotonic()
        self._last_materialize = time.monotonic()
        self._started: Optional[float] = None
        self._last_metrics: Optional[Dict[str, Any]] = None
        self.state: Any = None
        self.eval_metrics: Dict[str, Any] = {}
        self._last_eval_step = -1

    # -- preemption grace ---------------------------------------------------

    def install_preemption_handler(self, signals=None):
        """SIGTERM = a preemption notice (the scheduler's grace window):
        finish the in-flight steps, save, then end the run cleanly —
        lost work <= 1 step instead of the periodic save cadence.

        Installed by ``train_and_evaluate`` when the conf knob
        ``preemption_grace`` is true (default); a no-op off the main
        thread (signal handlers are main-thread-only in Python).

        One-shot: the first notice re-arms the previous disposition, so
        a second SIGTERM kills the process the ordinary way.
        """
        if signals is None:
            signals = (signal.SIGTERM,)

        def _handler(signum, _frame):
            # flag only: the save runs in the loop, after the step
            self._preempted = signum
            self._restore_signal_dispositions()
            logger.warning(
                "preemption notice (signal %d): emergency checkpoint "
                "after the in-flight steps", signum,
            )

        try:
            for s in signals:
                self._prev_handlers[s] = signal.signal(s, _handler)
        except ValueError:
            logger.warning(
                "preemption handler unavailable off the main thread"
            )

    def _restore_signal_dispositions(self):
        """Re-arm whatever handled the signals before install (default:
        terminate), from the handler itself and from run teardown."""
        for s, prev in self._prev_handlers.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):
                pass
        self._prev_handlers = {}

    def _finish_preempted(self, step: int) -> Dict[str, Any]:
        """Emergency save + clean end. The grace window bounds us
        externally (SIGKILL follows)."""
        logger.warning("preempted at step %d: flushing emergency "
                       "checkpoint", step)
        t0 = time.monotonic()
        try:
            # the periodic path's guard: a NaN-poisoned state must never
            # become the newest restore target
            if self._last_metrics is not None and not self._step_is_finite(
                self._last_metrics
            ):
                logger.error(
                    "skipping emergency checkpoint: non-finite state at "
                    "step %d (an older finite checkpoint remains the "
                    "restore target)", step,
                )
            else:
                self._trainer.save(self.state, force=True)
            saved = self._trainer.latest_checkpoint_step()  # flush
            logger.warning(
                "emergency checkpoint committed at step %s in %.1f s",
                saved, time.monotonic() - t0,
            )
        except Exception:  # noqa: BLE001 — still exit cleanly in grace
            logger.exception("emergency checkpoint failed")
        mirror_timed_out = False
        try:
            # close the manager even when the save above failed: an
            # earlier in-flight save must be waited on before exit
            mirror_timed_out = bool(self._trainer.finalize())
        except Exception:  # noqa: BLE001
            logger.exception("checkpoint finalize failed")
        if mirror_timed_out:
            logger.error(
                "[CKPT_MIRROR_TIMEOUT] preemption drain: the host-DRAM "
                "staging mirror never committed before exit; a storage-"
                "outage restore will fall back to an older staged step"
            )
        emit_event(
            EventKind.PREEMPT_DRAIN_DONE,
            error_code="CKPT_MIRROR_TIMEOUT" if mirror_timed_out else "",
            step=step,
            drain_seconds=round(time.monotonic() - t0, 3),
        )
        out = dict(self._last_metrics or {})
        out["preempted"] = True
        out["mirror_timed_out"] = mirror_timed_out
        out["step"] = step
        for hook in self._hooks:
            hook.end(self)
        return out

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

    def _handle_nonfinite(self, step: int, metrics: Dict[str, Any]) -> bool:
        """Report the failure and apply the policy. Returns True when the
        loop must re-enter (rollback restored an older state)."""
        detail = self._report_nonfinite(step, metrics)
        if self._on_nonfinite == "rollback":
            latest = self._trainer.latest_checkpoint_step()
            if latest is None:
                # no checkpoint manager or nothing saved yet: "rollback"
                # would silently restart from a fresh init — escalate
                raise NonFiniteLossError(
                    "on_nonfinite=rollback but no checkpoint exists to "
                    f"restore; halting. {detail}"
                )
            self._rollbacks += 1
            if self._rollbacks > self._max_rollbacks:
                raise NonFiniteLossError(
                    f"non-finite step persisted through {self._max_rollbacks}"
                    f" rollbacks; halting. {detail}"
                )
            logger.warning(
                "rolling back to the last checkpoint after non-finite step "
                "(%d/%d)", self._rollbacks, self._max_rollbacks,
            )
            # same world: restore into the live state on the built step
            restored = self._trainer.restore_state(self.state)
            self.state = (restored if restored is not None
                          else self._trainer.prepare(None))
            self._c_rollbacks.inc()
            emit_event(EventKind.ROLLBACK_RESTORED, step=step,
                       restored_step=int(self.state.step),
                       rollback=self._rollbacks)
            return True
        if self._on_nonfinite == "ignore":
            return False
        raise NonFiniteLossError(detail)

    # -- loop ---------------------------------------------------------------

    def _materialize_oldest(self, handle_nonfinite: bool = True) -> bool:
        """Read the oldest in-flight step's metrics on the host (the one
        device sync of the loop) and run the lagged consumers: hooks,
        the finite check, the speed log. Returns True when a non-finite
        step triggered a rollback (the remaining in-flight steps descend
        from the poisoned state, so the window is discarded)."""
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
        if (handle_nonfinite and self._check_finite_every
                and s % self._check_finite_every == 0
                and not self._step_is_finite(host)):
            if self._handle_nonfinite(s, host):
                self._window.clear()
                return True
        if (self._log_every and s % self._log_every == 0
                and self._trainer.is_chief):
            dt = now - self._last_log
            self._last_log = now
            logger.info("step %d loss=%.4f (%.2f steps/s)", s,
                        float(host.get("loss", float("nan"))),
                        self._log_every / max(dt, 1e-9))
        return False

    def _trim_window(self, limit: int, handle_nonfinite: bool = True) -> bool:
        """Materialize down to ``limit`` steps in flight; True when a
        rollback happened."""
        while len(self._window) > limit:
            if self._materialize_oldest(handle_nonfinite):
                return True
        return False

    def train_and_evaluate(self) -> Dict[str, Any]:
        if self._preempt_grace:
            self.install_preemption_handler()
        try:
            return self._train()
        finally:
            self._restore_signal_dispositions()

    def _train(self) -> Dict[str, Any]:
        self.state = self._trainer.prepare(self.state)
        for hook in self._hooks:
            hook.begin(self)
        step = int(self.state.step)
        self._window.clear()
        self._last_log = self._last_materialize = time.monotonic()
        self._started = time.monotonic()
        emit_event(EventKind.TRAIN_START, step=step,
                   train_window=self._train_window, steps_per_call=1)
        while True:
            # one pass over a fresh iterator; a rollback re-enters with
            # the restored state and a fresh iterator
            data_iter = iter(self._train_iter_fn())
            restarted = False
            while not (self._train_steps and step >= self._train_steps):
                try:
                    batch = next(data_iter)
                except StopIteration:
                    break  # data source exhausted
                for hook in self._hooks:
                    hook.before_step(step + 1)
                t_disp = time.monotonic()
                with span(SpanName.STEP_DISPATCH, step=step + 1):
                    self.state, metrics = self._trainer.step(self.state,
                                                             batch)
                self._h_dispatch.observe(time.monotonic() - t_disp)
                step += 1
                self._window.append(_Inflight(step, metrics))
                if self._trim_window(self._train_window):
                    restarted = True
                    break
                if self._preempted is not None:
                    self._c_preempt.inc()
                    emit_event(EventKind.PREEMPT_NOTICE,
                               error_code="PREEMPTED", step=step,
                               signum=int(self._preempted))
                    # drain first: the emergency save covers the last
                    # materialized step, and its finite guard needs the
                    # host metrics
                    self._trim_window(0, handle_nonfinite=False)
                    return self._finish_preempted(step)
                if self._eval_every and step % self._eval_every == 0:
                    if self._trim_window(0):
                        restarted = True
                        break
                    self._evaluate(step)
            if not restarted and self._trim_window(0):
                restarted = True
            if restarted:
                step = int(self.state.step)
                continue
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
        if self._last_metrics is None or self._step_is_finite(
            self._last_metrics
        ):
            self._trainer.save(self.state, force=True)
        else:
            # the final state is NaN-poisoned (the NaN landed between
            # check cadences, or the policy let it pass): a forced save
            # would make it the newest restore target. Report it, and
            # under "halt" fail the run
            detail = self._report_nonfinite(step, self._last_metrics)
            logger.warning(
                "skipping final checkpoint: last step was non-finite"
            )
            if self._on_nonfinite == "halt":
                raise NonFiniteLossError(f"final step non-finite: {detail}")
        self._trainer.finalize()
        emit_event(EventKind.TRAIN_END, step=step)
        for hook in self._hooks:
            hook.end(self)
        return {"step": step, **self.eval_metrics}
