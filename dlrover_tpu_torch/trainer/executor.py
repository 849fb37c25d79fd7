"""TrainExecutor: ``train_and_evaluate`` over an ElasticTrainer (port of
``dlrover_tpu/trainer/executor.py``).

Ported: the step loop with its dispatch window (up to ``train_window``
steps in flight before the oldest call's metrics are read on the host,
so the host does not wait on the device every step), the fused
multi-step call (a group of ``steps_per_call`` batches dispatches as
one ``step_multi`` and enters the window as one call of K steps; a
short tail dispatches as single steps), ``log_every_steps``,
evaluation, hooks, the non-finite guardrail with its policies
(``rollback`` restores the newest checkpoint onto the built trainer, at
most ``max_nonfinite_rollbacks`` times), the final forced save, the
preemption drain (SIGTERM: materialize the in-flight steps, save, end
cleanly), and the requests applied at the next loop boundary once the
window has drained: ``request_live_reshard`` (a change of world in the
process), ``request_retune`` (new knobs of the step, and the window)
and ``request_restart`` (the rebuild of ``on_world_change``). With a
master client, ``trainer.failover.TrainingFailover`` watches for
membership changes and makes those requests. The window, the
non-finite check, the drains and evaluation count steps, not calls.
Over several ranks only rank 0 logs. The master's reports, plan ids
and the peer replication hook come with ROADMAP A12.

Performance attribution (ROADMAP A11): at train start, and again after
a reshard, retune or restart, the executor fetches the
trainer's attribution record (counted on the meta device, once per
built step) and sets the static gauges; at each measured step it sets
the live MFU and the exposed-comm share (on a gloo world the exchanges'
host seconds, ``ops.ring.STATS``, within the bound; the bound on NCCL),
gauges that exist only from the first measured step on (absent, never
0). The capture's own stall is
kept out of the next step's time. Recovery paths (the non-finite
policy, a reshard, retune or restart) run under one incident trace id
each (``telemetry.trace_context``).
"""

from __future__ import annotations

import collections
import json
import math
import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.ops import ring
from dlrover_tpu_torch.telemetry import (
    EventKind,
    SpanName,
    emit_event,
    get_registry,
    names as tm,
    span,
)
from dlrover_tpu_torch.telemetry.trace_context import (
    TRACE_ID_ENV,
    trace_scope,
)
from dlrover_tpu_torch.trainer.conf import Configuration
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer
from dlrover_tpu_torch.trainer.failover import (
    FailoverClient,
    TrainingFailover,
)
from dlrover_tpu_torch.utils import prof

logger = get_logger("trainer.executor")


class NonFiniteLossError(RuntimeError):
    """A training step produced a non-finite loss or gradient norm and
    the policy (``on_nonfinite``) says to stop."""


@dataclass
class _Inflight:
    last_step: int
    count: int  # steps the call ran (K for step_multi)
    metrics: Dict[str, Any]  # stacked [K, ...] when count > 1


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


def _ring_seconds() -> float:
    """The host seconds of every ``ops.ring`` exchange so far."""
    return sum(e["seconds"] for e in ring.STATS.values())


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
        ``max_nonfinite_rollbacks`` (3), ``preemption_grace`` (True),
        ``live_recovery`` (the Context's).
      master_client: starts the failover monitor (any object with the
        reference master client's methods; the port's comes with A12).
      failover_client: the PS version handshake of that monitor.
      reshard_world_fn: () -> the ranks of the current world that form
        the next one (or None), called when a live reshard was requested
        without them.

    ``train_iter_fn`` is called again after a rollback and after each
    applied request: a source that resumes where it stopped (one
    iterator, returned each time) feeds every step once.
    """

    def __init__(
        self,
        trainer: ElasticTrainer,
        train_iter_fn: Callable[[], Iterable],
        eval_fn: Optional[Callable[[Any], Dict]] = None,
        hooks: Optional[List[TrainHook]] = None,
        conf: Optional[Configuration] = None,
        master_client=None,
        failover_client: Optional[FailoverClient] = None,
        reshard_world_fn: Optional[Callable[[], Optional[List[int]]]] = None,
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
        # performance attribution: the trainer's record of the active
        # step, fetched at train start and after each rebuild
        self._attr_enabled = bool(conf.get("attribution_enabled",
                                           ctx.attribution_enabled))
        self._attr_record: Optional[Any] = None
        self._attr_pending = self._attr_enabled
        self._g_attr_mfu: Optional[Any] = None
        self._g_attr_exposed: Optional[Any] = None
        # ops.ring's exchange seconds at the last measured step, and
        # the measured step's own (None where they are not the whole
        # exchange: ``_exchange_seconds``)
        self._ring_s = 0.0
        self._step_exchange_s: Optional[float] = None
        self._attr_mfu_scale = 0.0
        self._last_log = time.monotonic()
        self._last_materialize = time.monotonic()
        self._started: Optional[float] = None
        self._last_metrics: Optional[Dict[str, Any]] = None
        # boundary requests (applied by _maybe_restart once the window
        # has drained)
        self._live_recovery = bool(conf.get("live_recovery",
                                            ctx.live_recovery))
        self._restart_requested = False
        self._reshard_requested = False
        self._reshard_devices: Optional[List[int]] = None
        self._retune_request: Optional[Dict[str, Any]] = None
        self._reshard_world_fn = reshard_world_fn
        self._failover: Optional[TrainingFailover] = None
        if master_client is not None:
            if failover_client is not None:
                failover_client.init_version()
            self._failover = TrainingFailover(
                master_client, self.request_restart,
                failover_client=failover_client,
                on_reshard=(self.request_live_reshard
                            if self._live_recovery else None))
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
        loop must re-enter (rollback restored an older state). The
        failure and its recovery run under one fresh incident trace id,
        so NONFINITE_STEP and ROLLBACK_RESTORED correlate."""
        with trace_scope():
            return self._handle_nonfinite_scoped(step, metrics)

    def _handle_nonfinite_scoped(self, step: int,
                                 metrics: Dict[str, Any]) -> bool:
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

    # -- boundary requests ---------------------------------------------------

    def request_restart(self):
        """Membership changed: drain, then rebuild through the trainer's
        ``on_world_change`` at the next loop boundary."""
        self._restart_requested = True

    def request_live_reshard(self, devices: Optional[List[int]] = None):
        """A survivable change of world: at the next loop boundary drain
        the window, then ``live_reshard`` in the process. ``devices``:
        the ranks of the current world that stay (None: ask
        ``reshard_world_fn``, else the world as it is then)."""
        self._reshard_devices = (list(devices) if devices is not None
                                 else None)
        self._reshard_requested = True

    def request_retune(self, steps_per_call: Optional[int] = None,
                       train_window: Optional[int] = None,
                       dispatch_chunks: Optional[int] = None,
                       moe_precision: Optional[str] = None,
                       prewarm: bool = True):
        """New knobs at the next loop boundary: ``train_window`` is set
        in place, and the step's knobs swap through the trainer's cache
        (``prewarm`` first builds the step there, ``retune`` switches to
        it). No restart."""
        self._retune_request = {
            "steps_per_call": steps_per_call, "train_window": train_window,
            "dispatch_chunks": dispatch_chunks,
            "moe_precision": moe_precision, "prewarm": bool(prewarm),
        }

    def _requested(self) -> bool:
        return (self._restart_requested or self._reshard_requested
                or self._retune_request is not None)

    def _maybe_restart(self):
        """Apply the pending request (the window is drained), under one
        incident trace id; the step it leaves may be another, so the
        attribution record is fetched again."""
        with trace_scope():
            self._apply_request()
        self._refresh_attribution()

    def _apply_request(self):
        if self._reshard_requested:
            self._reshard_requested = False
            devices, self._reshard_devices = self._reshard_devices, None
            if devices is None and self._reshard_world_fn is not None:
                devices = self._reshard_world_fn()
            if devices is None and not self._trainer.world_changed():
                # no new coordinates and the same group: a reshard onto
                # the identical world would be churn, not recovery
                logger.info("live reshard requested but the world is "
                            "unchanged; skipping (no new coordinates)")
                return
            self.state = self._trainer.live_reshard(
                self.state, devices=devices, reason="executor")
            return
        if self._retune_request is not None:
            req, self._retune_request = self._retune_request, None
            self._apply_retune(req)
            return
        if not self._restart_requested:
            return
        self._restart_requested = False
        logger.info("rebuilding the training session (membership change)")
        self.state = self._trainer.on_world_change(self.state)

    def _apply_retune(self, req: Dict[str, Any]):
        trainer = self._trainer
        k, w = req["steps_per_call"], req["train_window"]
        ch, mp = req["dispatch_chunks"], req["moe_precision"]
        if k is not None and int(k) == trainer.steps_per_call:
            k = None
        if ch is not None and int(ch) == trainer.dispatch_chunks:
            ch = None
        if mp is not None and str(mp) == trainer.moe_precision:
            mp = None
        t0 = time.monotonic()
        if k is not None or ch is not None or mp is not None:
            compiles = trainer.compile_count
            if req["prewarm"]:
                trainer.prewarm(steps_per_call=k, dispatch_chunks=ch,
                                moe_precision=mp)
            self.state = trainer.retune(self.state, steps_per_call=k,
                                        dispatch_chunks=ch, moe_precision=mp)
            logger.info("retuned in %.2fs (K=%d, c=%d, p=%s; %d built)",
                        time.monotonic() - t0, trainer.steps_per_call,
                        trainer.dispatch_chunks, trainer.moe_precision,
                        trainer.compile_count - compiles)
        if w is not None:
            self._train_window = max(0, int(w))
        # the stall must not count as the next step's time
        self._last_materialize = time.monotonic()
        self._ring_s = _ring_seconds()

    # -- performance attribution ----------------------------------------------

    def _refresh_attribution(self):
        """The active step may have changed (a reshard, retune or
        restart): drop the record and re-arm the lazy fetch."""
        self._attr_record = None
        self._attr_pending = self._attr_enabled

    def _set_headroom(self):
        """Free device memory as the driver reports it (the card only:
        absent on the CPU, never a fake 0)."""
        device = self._trainer.device
        if device.type != "cuda":
            return
        free, _ = torch.cuda.mem_get_info(device)
        get_registry().gauge(
            tm.ATTR_HBM_HEADROOM_MB,
            help="free device memory (MB), torch.cuda.mem_get_info",
        ).set(free / (1024 * 1024))

    def _fetch_attribution(self):
        """Fetch the trainer's record of the active step (the trainer
        caches it by program key) and export the static gauges. Gauges
        are created here, not in __init__, so a job that never captured
        a record never exports a misleading 0."""
        attribution = getattr(self._trainer, "attribution", None)
        if attribution is None:
            return
        try:
            record = attribution()
        except Exception:  # noqa: BLE001 — observation only: a capture
            # failure must never take the step loop down
            logger.warning("attribution fetch failed", exc_info=True)
            record = None
        if record is None:
            return
        self._attr_record = record
        # mfu = flops / (step_s * peak) = (flops / peak) / step_s: the
        # same derived_mfu formula, folded to one multiply per step
        self._attr_mfu_scale = (
            record.flops_per_step / record.peak_flops_per_s
            if record.peak_flops_per_s > 0 else 0.0)
        reg = get_registry()
        reg.gauge(tm.ATTR_FLOPS_PER_STEP,
                  help="counted per-device FLOPs per optimizer step",
                  ).set(record.flops_per_step)
        reg.gauge(tm.ATTR_ARITH_INTENSITY,
                  help="counted FLOPs / bytes (memory-bound when low)",
                  ).set(record.arithmetic_intensity)
        reg.gauge(tm.ATTR_PEAK_HBM_MB,
                  help="per-device peak memory (MB), "
                       "torch.cuda.max_memory_allocated",
                  ).set(record.peak_hbm_bytes / (1024 * 1024))
        reg.gauge(tm.ATTR_COMM_PREDICTED_S,
                  help="predicted per-step exchange seconds (all kinds)",
                  ).set(record.predicted_comm_total_s)
        self._set_headroom()
        # the capture is a one-off stall: it must not count as the next
        # step's time
        self._last_materialize = time.monotonic()
        self._ring_s = _ring_seconds()

    def _exchange_seconds(self, steps: int) -> Optional[float]:
        """The host seconds a step spent in ``ops.ring``'s exchanges
        since the last call (``ring.STATS``), where those seconds are
        the whole exchange: a gloo world of several ranks, whose
        collectives hold the host until they are done. None on NCCL,
        whose host seconds are the enqueue only, and on one rank."""
        total = _ring_seconds()
        # a reset_stats since the last call restarts the count
        spent = total - self._ring_s if total >= self._ring_s else total
        self._ring_s = total
        if not (dist.is_initialized() and dist.get_world_size() > 1
                and dist.get_backend() == "gloo"):
            return None
        return spent / steps

    def _observe_attribution(self, per_step: float):
        """Fuse one measured per-step time (and the step's exchange
        seconds, ``_step_exchange_s``) with the record into the derived
        gauges."""
        if self._attr_pending:
            self._attr_pending = False
            self._fetch_attribution()
        if self._attr_record is None or per_step <= 0:
            return
        if self._g_attr_mfu is None:
            reg = get_registry()
            self._g_attr_mfu = reg.gauge(
                tm.ATTR_MFU,
                help="live model-FLOPs utilization (counted FLOPs/step "
                     "over measured step time x device peak)")
            self._g_attr_exposed = reg.gauge(
                tm.ATTR_EXPOSED_COMM_FRAC,
                help="un-overlapped comm share of the step: the "
                     "exchanges' host seconds over the step's on gloo, "
                     "within the bound 1 - ideal compute s / measured "
                     "step s (the bound alone on NCCL)")
            # the first measured step has run: the peak covers a step
            if self._trainer.device.type == "cuda":
                peak = prof.compiled_peak_bytes(self._trainer.device)
                self._attr_record.peak_hbm_bytes = peak
                reg.gauge(tm.ATTR_PEAK_HBM_MB).set(peak / (1024 * 1024))
                self._set_headroom()
        inv = 1.0 / per_step
        self._g_attr_mfu.set(self._attr_mfu_scale * inv)
        self._g_attr_exposed.set(self._attr_record.exposed_comm_fraction(
            per_step, self._step_exchange_s))

    # -- loop ---------------------------------------------------------------

    def _materialize_oldest(self, handle_nonfinite: bool = True) -> bool:
        """Read the oldest in-flight call's metrics on the host (the one
        device sync of the loop) and run the lagged consumers for each
        step it ran: hooks, the finite check, the speed log. Returns
        True when a non-finite step triggered a rollback (the remaining
        in-flight steps descend from the poisoned state, so the window
        is discarded)."""
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
            # an incident id inherited through the environment covers
            # the recovery (start-up to the first step), not the rest of
            # the process's life
            os.environ.pop(TRACE_ID_ENV, None)
        # a fused call's steps share its time evenly
        per_step = (now - self._last_materialize) / entry.count
        self._last_materialize = now
        self._step_exchange_s = self._exchange_seconds(entry.count)
        self._observe_attribution(per_step)
        for i in range(entry.count):
            s = entry.last_step - entry.count + 1 + i
            sub = (host if entry.count == 1 else
                   {k: v[i] if isinstance(v, list) else v
                    for k, v in host.items()})
            self._h_step_time.observe(per_step)
            self._c_steps.inc()
            self._last_metrics = sub
            for hook in self._hooks:
                hook.after_step(s, sub)
            if (handle_nonfinite and self._check_finite_every
                    and s % self._check_finite_every == 0
                    and not self._step_is_finite(sub)):
                if self._handle_nonfinite(s, sub):
                    self._window.clear()
                    return True
            if (self._log_every and s % self._log_every == 0
                    and self._trainer.is_chief):
                dt = now - self._last_log
                self._last_log = now
                logger.info("step %d loss=%.4f (%.2f steps/s)", s,
                            float(sub.get("loss", float("nan"))),
                            self._log_every / max(dt, 1e-9))
                if self._attr_record is not None:
                    self._set_headroom()
        return False

    def _trim_window(self, limit: int, handle_nonfinite: bool = True) -> bool:
        """Materialize the oldest calls until at most ``limit`` steps
        are in flight; True when a rollback happened."""
        while sum(e.count for e in self._window) > limit:
            if self._materialize_oldest(handle_nonfinite):
                return True
        return False

    @staticmethod
    def _take_batches(data_iter: Iterator, n: int) -> List[Any]:
        out: List[Any] = []
        for _ in range(n):
            try:
                out.append(next(data_iter))
            except StopIteration:
                break
        return out

    def train_and_evaluate(self) -> Dict[str, Any]:
        if self._preempt_grace:
            self.install_preemption_handler()
        if self._failover is not None:
            self._failover.start()
        try:
            return self._train()
        finally:
            self._restore_signal_dispositions()
            if self._failover is not None:
                self._failover.stop()

    def _dispatch(self, step: int, group: List[Any], k: int) -> int:
        """Dispatch ``group``: one ``step_multi`` when it holds K > 1
        batches, else a step each. Returns the step reached."""
        if k > 1 and len(group) == k:
            for i in range(k):
                for hook in self._hooks:
                    hook.before_step(step + 1 + i)
            t_disp = time.monotonic()
            with span(SpanName.STEP_DISPATCH, step=step + k, k=k):
                self.state, metrics = self._trainer.step_multi(self.state,
                                                               group)
            self._h_dispatch.observe(time.monotonic() - t_disp)
            self._window.append(_Inflight(step + k, k, metrics))
            return step + k
        for batch in group:
            for hook in self._hooks:
                hook.before_step(step + 1)
            t_disp = time.monotonic()
            with span(SpanName.STEP_DISPATCH, step=step + 1):
                self.state, metrics = self._trainer.step(self.state, batch)
            self._h_dispatch.observe(time.monotonic() - t_disp)
            step += 1
            self._window.append(_Inflight(step, 1, metrics))
        return step

    def _train(self) -> Dict[str, Any]:
        self.state = self._trainer.prepare(self.state)
        # prepare may have built another step; a second run re-reads
        # the trainer's record
        self._refresh_attribution()
        for hook in self._hooks:
            hook.begin(self)
        step = int(self.state.step)
        self._window.clear()
        self._last_log = self._last_materialize = time.monotonic()
        self._ring_s = _ring_seconds()
        self._started = time.monotonic()
        emit_event(EventKind.TRAIN_START, step=step,
                   train_window=self._train_window,
                   steps_per_call=self._trainer.steps_per_call)
        # the record now, before the first dispatch: its capture lands
        # in the first step's set-up window, not in a measured step
        if self._attr_pending:
            self._attr_pending = False
            self._fetch_attribution()
        while True:
            # one pass over the data source; a rollback or an applied
            # request re-enters with the state, knobs and window as they
            # are then, and calls train_iter_fn again
            window = self._train_window
            k = self._trainer.steps_per_call
            data_iter = iter(self._train_iter_fn())
            restarted = False
            while True:
                take = k
                if self._train_steps:
                    take = min(take, self._train_steps - step)
                group = self._take_batches(data_iter, take)
                if not group:
                    break  # data source exhausted, or train_steps reached
                step = self._dispatch(step, group, k)
                if self._trim_window(window):
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
                if self._eval_every and (step // self._eval_every
                                         > (step - len(group))
                                         // self._eval_every):
                    if self._trim_window(0):
                        restarted = True
                        break
                    self._evaluate(step)
                if self._requested():
                    if self._trim_window(0):
                        restarted = True
                        break
                    self._maybe_restart()
                    if self.state is None:
                        return self._leave(step)
                    restarted = True
                    break
            if not restarted and self._trim_window(0):
                restarted = True
            if restarted:
                step = int(self.state.step)
                continue
            return self._finish(step)

    def _leave(self, step: int) -> Dict[str, Any]:
        """This rank left the world in a live reshard: end without a
        save (the survivors hold the state)."""
        logger.info("left the world at step %d; ending", step)
        self._trainer.finalize()
        emit_event(EventKind.TRAIN_END, step=step, left_world=True)
        for hook in self._hooks:
            hook.end(self)
        return {"step": step, "left_world": True}

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
