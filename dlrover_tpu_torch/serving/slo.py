"""The serving worker's runtime report hook (port of
``dlrover_tpu/serving/slo.py``).

``ServeRuntimeReportHook`` pushes node-tagged snapshots of the worker's
instruments (the decode-step histogram's cumulative bucket counts,
decode steps and tokens so far, slot occupancy, the local queue's
depth, the speculative drafted / accepted totals) through the client's
``report_node_runtime(**fields)`` with ``node_type="serve"``, the call
the reference's ``MasterClient`` makes; the master diffs consecutive
reports into windows.

The decode loop only snapshots and enqueues. The call and the RSS read
(``/proc/self/status``) run on a daemon sender thread behind a queue of
two: a full queue drops the report (the next cumulative one supersedes
it), and the send rate is floored by wall time, so a fast loop cannot
flood the master.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.config import get_context
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.telemetry import get_registry, names as tm
from dlrover_tpu_torch.telemetry.metrics import LATENCY_BUCKETS

logger = get_logger("serving.slo")

FLUSH_JOIN_S = 5.0  # flush waits this long for the sender, at most


def rss_mb() -> float:
    """This process's resident set in MiB (``VmRSS``), 0.0 where
    ``/proc`` has none."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        logger.debug("no /proc/self/status", exc_info=True)
    return 0.0


class ServeRuntimeReportHook:
    """Push the serve worker's runtime snapshot every ``every_steps``
    decode steps, no more often than every ``min_interval_s`` seconds
    (defaults: the ``runtime_report_steps`` and
    ``seconds_interval_to_report`` knobs)."""

    def __init__(self, master_client, every_steps: Optional[int] = None,
                 registry=None, min_interval_s: Optional[float] = None):
        ctx = get_context()
        self._client = master_client
        self._every = int(every_steps if every_steps is not None
                          else getattr(ctx, "runtime_report_steps", 32))
        self._min_interval = float(
            min_interval_s if min_interval_s is not None
            else getattr(ctx, "seconds_interval_to_report", 15))
        self._last_send = 0.0
        # steps at the last send: a run of no steps skips the flush too
        self._last_steps_sent = 0.0
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._sender: Optional[threading.Thread] = None
        reg = registry if registry is not None else get_registry()
        self._h_step = reg.histogram(tm.SERVE_STEP_TIME,
                                     buckets=LATENCY_BUCKETS)
        self._c_decode = reg.counter(tm.SERVE_DECODE_STEPS)
        self._c_tokens = reg.counter(tm.SERVE_TOKENS)
        self._g_occupancy = reg.gauge(tm.SERVE_SLOT_OCCUPANCY)
        self._c_spec_drafted = reg.counter(tm.SERVE_SPEC_DRAFTED)
        self._c_spec_accepted = reg.counter(tm.SERVE_SPEC_ACCEPTED)
        self._c_sent = get_registry().counter(
            tm.NODE_RUNTIME_REPORTS,
            help="node runtime snapshots pushed to the master")
        self._c_failed = get_registry().counter(
            tm.NODE_RUNTIME_REPORT_FAILURES,
            help="runtime snapshots the master never acked")

    def after_step(self, step: int, queue_len: int = 0,
                   slots: int = 0) -> None:
        """After each decode step: snapshot and enqueue at the cadence."""
        if self._every <= 0 or step % self._every:
            return
        now = time.monotonic()
        if now - self._last_send < self._min_interval:
            return
        self._last_send = now
        self._enqueue(step, queue_len, slots)

    def flush(self, queue_len: int = 0, slots: int = 0) -> None:
        """One last snapshot whatever the cadence, but only when steps
        landed since the last send (an empty window would become the
        node's latest sample); then stop the sender once the queue
        drains, waiting FLUSH_JOIN_S at most (a dead master must not
        hang the exit)."""
        if self._every > 0 and \
                float(self._c_decode.value) != self._last_steps_sent:
            self._enqueue(int(self._c_decode.value), queue_len, slots)
        if self._sender is None or not self._sender.is_alive():
            return
        try:
            self._queue.put_nowait(None)
        except queue.Full:  # the sender is wedged
            logger.debug("serve report queue full at flush")
            return
        self._sender.join(timeout=FLUSH_JOIN_S)
        self._sender = None

    def _enqueue(self, step: int, queue_len: int, slots: int) -> None:
        bounds = getattr(self._h_step, "bounds", None)  # None when off
        counts = self._h_step.snapshot_counts()
        self._last_steps_sent = float(self._c_decode.value)
        payload = dict(
            node_type="serve",
            step=int(step),
            steps_total=float(self._c_decode.value),
            bounds=list(bounds) if bounds else None,
            step_time_counts=list(counts) if counts else None,
            serve_tokens_total=float(self._c_tokens.value),
            serve_queue_len=float(queue_len),
            serve_slot_occupancy=float(self._g_occupancy.value),
            serve_slots=float(slots),
            # cumulative: the master diffs them into a windowed rate
            serve_spec_drafted_total=float(self._c_spec_drafted.value),
            serve_spec_accepted_total=float(self._c_spec_accepted.value),
        )
        if self._sender is None or not self._sender.is_alive():
            self._sender = threading.Thread(
                target=self._send_loop, name="serve-runtime-report",
                daemon=True)
            self._sender.start()
        try:
            self._queue.put_nowait(payload)
        except queue.Full:
            # the sender is behind: drop this one, the next supersedes it
            self._c_failed.inc()

    def _send_loop(self):
        while True:
            payload = self._queue.get()
            if payload is None:
                return
            try:
                payload["rss_mb"] = round(rss_mb(), 1)
                self._client.report_node_runtime(**payload)
                self._c_sent.inc()
            except Exception:  # noqa: BLE001 — a dead master must not
                # kill the decode loop; the gap is counted
                self._c_failed.inc()
                logger.debug("serve runtime report failed", exc_info=True)
