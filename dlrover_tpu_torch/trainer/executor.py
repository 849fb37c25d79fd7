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
Over several ranks only rank 0 logs.

Runtime-optimizer plans: ``OptimizerPlanHook`` polls the master's
broadcast config and hands an unseen plan to ``request_retune`` (its
``steps_per_call``, ``train_window``, mesh, ``dispatch_chunks``,
``moe_precision`` and ``fsdp_precision``, with the plan id). The plan is
applied at a drained boundary (``_apply_plan_scoped``): prewarm, then
retune through the trainer's cache. A plan that asks for a wire
precision the device's fp8 probe would degrade to bf16, or that fails
to apply, is acked negatively (``_report_trainer_config(...,
apply_failed=True)``), so the master does not choose it again; an
applied one is acked with the config the trainer runs. The realized
speed-up measurement and the peer replication hook come with ROADMAP
A12.

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

Input wait (ROADMAP A7): each ``next(data_iter)`` is timed into the
``INPUT_WAIT_TIME`` histogram; at each materialization the fetch
seconds since the last one over the window's wall time set the
``INPUT_WAIT_FRAC`` gauge, which exists only once a window held a fetch
(absent, never 0); the run's total rides the train-end record
(``input_wait_s``).
"""

from __future__ import annotations

import collections
import json
import math
import os
import signal
import threading
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


class OptimizerPlanHook(TrainHook):
    """Poll the master for a runtime-optimizer plan and apply it live
    (the reference's hook). A daemon thread polls
    ``get_parallel_config`` every ``poll_secs`` (0: only ``poll_once``);
    a plan id not seen before goes to ``executor.request_retune``, or to
    ``request_restart`` when the plan asks for one. A plan whose knobs
    are all serving ones is left to the serving worker, and over several
    ranks a plan that changes the step is acked negatively (each rank
    polls on its own clock, so an in-place swap is not synchronized)."""

    def __init__(self, master_client, poll_secs: Optional[float] = None):
        self._client = master_client
        self._poll = float(poll_secs if poll_secs is not None
                           else get_context().plan_poll_secs)
        self._executor: Optional["TrainExecutor"] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seen_plan = ""

    def begin(self, executor: "TrainExecutor"):
        self._executor = executor
        if self._poll <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._poll_loop,
                                        name="optimizer-plan-poll",
                                        daemon=True)
        self._thread.start()

    def end(self, executor: "TrainExecutor"):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _poll_loop(self):
        while not self._stop.wait(self._poll):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the master briefly
                # away: poll again at the next cadence
                logger.warning("optimizer plan poll failed (%s: %s)",
                               type(e).__name__, e)

    def poll_once(self):
        """Fetch the broadcast config and hand an unseen plan on."""
        if self._executor is None:
            return
        cfg = self._client.get_parallel_config()
        plan_id = getattr(cfg, "plan_id", "") or ""
        if not plan_id or plan_id == self._seen_plan:
            return
        self._seen_plan = plan_id
        k = int(getattr(cfg, "steps_per_call", 0) or 0)
        w = int(getattr(cfg, "train_window", -1))
        mesh = getattr(cfg, "mesh_shape", None) or None
        ch = int(getattr(cfg, "dispatch_chunks", 0) or 0)
        mp = getattr(cfg, "moe_precision", "") or ""
        fp = getattr(cfg, "fsdp_precision", "") or ""
        restart = bool(getattr(cfg, "restart", False))
        serving = (getattr(cfg, "serve_slots", 0)
                   or getattr(cfg, "serve_prefill_chunk", 0)
                   or getattr(cfg, "serve_prefix_pool_pages", -1) >= 0)
        if serving and not (k or mesh or w >= 0 or ch or mp or fp
                            or restart):
            return  # a serving worker's plan
        if restart:
            logger.info("optimizer plan %s requests a restart", plan_id)
            self._executor.request_restart()
            return
        trace_id = getattr(cfg, "trace_id", "") or ""
        if (k or mesh or ch or mp or fp) and dist.is_initialized() \
                and dist.get_world_size() > 1:
            logger.warning("optimizer plan %s changes the step; in-place "
                           "swaps are not synchronized across ranks yet, "
                           "applying only train_window", plan_id)
            if w >= 0:
                self._executor.request_retune(train_window=w,
                                              trace_id=trace_id)
            self._executor._report_trainer_config(plan_id=plan_id,
                                                  apply_failed=True)
            return
        if getattr(cfg, "moe_dispatch", ""):
            logger.warning("optimizer plan %s carries moe_dispatch=%s, "
                           "which cannot be applied live; ignoring that "
                           "knob", plan_id, cfg.moe_dispatch)
        self._executor.request_retune(
            steps_per_call=k or None,
            train_window=w if w >= 0 else None,
            mesh_shape=dict(mesh) if mesh else None,
            dispatch_chunks=ch or None, moe_precision=mp or None,
            fsdp_precision=fp or None, plan_id=plan_id, trace_id=trace_id,
            predicted_speedup=float(getattr(cfg, "predicted_speedup", 0.0)
                                    or 0.0),
            prewarm=bool(getattr(cfg, "prewarm", True)))


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
        # data plane: host time blocked in next(data_iter) fetching the
        # batch for a dispatch. The INPUT_WAIT_FRAC gauge is created at
        # the first measured materialization window (absent, never 0)
        self._h_input_wait = reg.histogram(
            tm.INPUT_WAIT_TIME,
            help="host time blocked waiting for the next host batch")
        self._g_input_wait: Optional[Any] = None
        self._input_wait_total = 0.0
        self._input_wait_count = 0
        self._input_wait_mark = 0.0
        self._input_wait_count_mark = 0
        self._input_wait_run_start = 0.0
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
        self._master_client = master_client
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
                       mesh_shape: Optional[Dict[str, int]] = None,
                       dispatch_chunks: Optional[int] = None,
                       moe_precision: Optional[str] = None,
                       fsdp_precision: Optional[str] = None,
                       plan_id: str = "", trace_id: str = "",
                       predicted_speedup: float = 0.0,
                       prewarm: bool = True):
        """New knobs at the next loop boundary (a runtime-optimizer plan,
        ``OptimizerPlanHook``): ``train_window`` is set in place, and
        the step's knobs (``steps_per_call``, a mesh of the same ranks,
        ``dispatch_chunks``, ``moe_precision``, ``fsdp_precision``) swap
        through the trainer's cache (``prewarm`` first builds the step
        there, ``retune`` switches to it). No restart. ``plan_id``: the
        plan acked to the master once applied (or negatively)."""
        self._retune_request = {
            "steps_per_call": steps_per_call, "train_window": train_window,
            "mesh_shape": dict(mesh_shape) if mesh_shape else None,
            "dispatch_chunks": dispatch_chunks,
            "moe_precision": moe_precision,
            "fsdp_precision": fsdp_precision, "plan_id": plan_id,
            "trace_id": trace_id,
            "predicted_speedup": float(predicted_speedup or 0.0),
            "prewarm": bool(prewarm),
        }

    def _requested(self) -> bool:
        return (self._restart_requested or self._reshard_requested
                or self._retune_request is not None)

    def _maybe_restart(self):
        """Apply the pending request (the window is drained), under one
        incident trace id (a plan's own when it brings one); the step it
        leaves may be another, so the attribution record is fetched
        again."""
        trace_id = (self._retune_request or {}).get("trace_id") or None
        with trace_scope(trace_id):
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
            self._apply_plan_scoped(req, req.get("plan_id", ""))
            return
        if not self._restart_requested:
            return
        self._restart_requested = False
        logger.info("rebuilding the training session (membership change)")
        self.state = self._trainer.on_world_change(self.state)

    def _mesh_override_from(self, mesh_shape) -> Optional[Any]:
        """The MeshPlan a plan's ``mesh_shape`` asks for; None when it is
        the mesh the trainer runs (an identical override would only
        churn the cache key)."""
        if not mesh_shape:
            return None
        from dlrover_tpu_torch.parallel.mesh import MESH_AXES, MeshPlan

        wanted = {a: int(mesh_shape.get(a, 1)) for a in MESH_AXES}
        try:
            current = self._trainer.accelerated.strategy.mesh.axis_sizes()
        except RuntimeError:
            current = None
        if current is not None and {a: int(v) for a, v in
                                    current.items()} == wanted:
            return None
        return MeshPlan(**wanted)

    def _wire_degraded(self, plan_id: str, knob: str,
                       precision: Optional[str]) -> bool:
        """Whether the trainer would run ``precision`` as another (the
        device fails the fp8 probe); such a plan is acked negatively, so
        the master does not mark a wire applied that never runs."""
        if precision is None:
            return False
        effective = self._trainer._effective_precision(precision)
        if effective == precision:
            return False
        logger.warning("optimizer plan %s wants %s=%s but the device runs "
                       "%s (fp8 probe failed); acking it negatively",
                       plan_id, knob, precision, effective)
        self._report_trainer_config(plan_id=plan_id, apply_failed=True)
        return True

    def _apply_plan_scoped(self, req: Dict[str, Any], plan_id: str):
        """Apply one request at a drained boundary: ``train_window`` in
        place, the step's knobs through the trainer's cache (prewarmed
        first, so the swap builds nothing). A failure keeps the previous
        step running and acks the plan negatively."""
        trainer = self._trainer
        k, w = req.get("steps_per_call"), req.get("train_window")
        ch, mp = req.get("dispatch_chunks"), req.get("moe_precision")
        fp = req.get("fsdp_precision")
        mesh = self._mesh_override_from(req.get("mesh_shape"))
        if k is not None and int(k) == trainer.steps_per_call:
            k = None
        if ch is not None and int(ch) == trainer.dispatch_chunks:
            ch = None
        if (self._wire_degraded(plan_id, "moe_precision", mp)
                or self._wire_degraded(plan_id, "fsdp_precision", fp)):
            return
        if mp is not None and str(mp) == trainer.moe_precision:
            mp = None
        if fp is not None and str(fp) == trainer.fsdp_precision:
            fp = None
        t0 = time.monotonic()
        knobs = dict(steps_per_call=k, mesh=mesh, dispatch_chunks=ch,
                     moe_precision=mp, fsdp_precision=fp)
        try:
            if any(v is not None for v in knobs.values()):
                compiles = trainer.compile_count
                if req.get("prewarm", True):
                    trainer.prewarm(**knobs)
                self.state = trainer.retune(self.state, **knobs)
                logger.info("retuned in %.2fs (K=%d, c=%d, p=%s, fp=%s; %d "
                            "built)", time.monotonic() - t0,
                            trainer.steps_per_call, trainer.dispatch_chunks,
                            trainer.moe_precision, trainer.fsdp_precision,
                            trainer.compile_count - compiles)
            if w is not None:
                self._train_window = max(0, int(w))
        except Exception:  # noqa: BLE001 — a bad plan must not end the
            # run: the previous step keeps running
            logger.exception("optimizer plan %s failed to apply; going on "
                             "with the previous config", plan_id or "-")
            self._report_trainer_config(plan_id=plan_id, apply_failed=True)
            return
        finally:
            # the stall must not count as the next step's time
            self._last_materialize = time.monotonic()
            self._ring_s = _ring_seconds()
        emit_event(EventKind.OPTIMIZER_APPLY_DONE, plan_id=plan_id,
                   seconds=round(time.monotonic() - t0, 3),
                   train_window=self._train_window,
                   steps_per_call=trainer.steps_per_call,
                   dispatch_chunks=trainer.dispatch_chunks,
                   moe_precision=trainer.moe_precision,
                   fsdp_precision=trainer.fsdp_precision)
        self._report_trainer_config(
            plan_id=plan_id,
            predicted_speedup=req.get("predicted_speedup", 0.0))

    def _report_trainer_config(self, plan_id: str = "",
                               predicted_speedup: float = 0.0,
                               apply_failed: bool = False):
        """Tell the master what this worker runs (the runtime
        optimizer's view and a plan's ack), when the master client has
        the call; a failed report is logged, never raised."""
        client = self._master_client
        if client is None or not hasattr(client, "report_trainer_config"):
            return
        trainer = self._trainer
        try:
            result = trainer.accelerated
            client.report_trainer_config(
                world=int(result.world),
                mesh_shape={a: int(v) for a, v in
                            result.strategy.mesh.axis_sizes().items()},
                train_window=int(self._train_window),
                steps_per_call=int(trainer.steps_per_call),
                dispatch_chunks=int(trainer.dispatch_chunks),
                moe_precision=str(trainer.moe_precision),
                fsdp_precision=str(trainer.fsdp_precision),
                grad_precision=str(trainer.grad_precision),
                global_batch=int(result.strategy.global_batch_size or 0),
                plan_id=plan_id,
                predicted_speedup=float(predicted_speedup or 0.0),
                apply_failed=bool(apply_failed))
        except Exception:  # noqa: BLE001 — a dead master must not stop
            # the run
            logger.debug("trainer config report failed", exc_info=True)

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
        window_s = now - self._last_materialize
        per_step = window_s / entry.count
        self._last_materialize = now
        self._step_exchange_s = self._exchange_seconds(entry.count)
        self._observe_attribution(per_step)
        self._observe_input_wait(window_s)
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

    def _take_batches(self, data_iter: Iterator, n: int) -> List[Any]:
        out: List[Any] = []
        for _ in range(n):
            t0 = time.monotonic()
            try:
                batch = next(data_iter)
            except StopIteration:
                break
            # with the dispatch window keeping the device busy, host time
            # spent here is the data pipeline failing to stay ahead
            waited = time.monotonic() - t0
            self._input_wait_total += waited
            self._input_wait_count += 1
            self._h_input_wait.observe(waited)
            out.append(batch)
        return out

    def _observe_input_wait(self, window_s: float):
        """The input-wait share of the materialization window just
        closed: fetch seconds since the previous materialization over
        the window's wall time. With a deep dispatch window the fetches
        belong to newer steps than the one materializing, so the share
        is a windowed average."""
        waited = self._input_wait_total - self._input_wait_mark
        fetches = self._input_wait_count - self._input_wait_count_mark
        self._input_wait_mark = self._input_wait_total
        self._input_wait_count_mark = self._input_wait_count
        if window_s <= 0 or self._input_wait_count == 0:
            return  # nothing measured yet: the gauge stays absent
        if fetches == 0:
            # a window with no fetch (the drain's tail) says nothing of
            # the input pipeline: keep the last measured share
            return
        if self._g_input_wait is None:
            self._g_input_wait = get_registry().gauge(
                tm.INPUT_WAIT_FRAC,
                help="fraction of the last materialization window the "
                     "host spent blocked waiting for the next batch")
        frac = waited / window_s
        self._g_input_wait.set(min(1.0, max(0.0, frac)))

    @property
    def input_wait_seconds(self) -> float:
        """Host seconds blocked fetching batches in this run."""
        return self._input_wait_total - self._input_wait_run_start

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
        self._input_wait_mark = self._input_wait_total
        self._input_wait_count_mark = self._input_wait_count
        self._input_wait_run_start = self._input_wait_total
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
        # the run's input-wait seconds ride the train-end record
        emit_event(EventKind.TRAIN_END, step=step,
                   input_wait_s=round(self.input_wait_seconds, 3))
        for hook in self._hooks:
            hook.end(self)
        return {"step": step, **self.eval_metrics}
