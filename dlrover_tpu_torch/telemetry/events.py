"""Lifecycle event timeline (the subset of
``dlrover_tpu/telemetry/events.py`` the trainer calls): each record goes
to a bounded in-memory ring and, when ``DLROVER_TPU_EVENTS_FILE`` (or
the Context knob ``telemetry_events_file``) names a file, as one JSON
line appended to it. Inside ``trace_context.trace_scope`` (or with
``DLROVER_TPU_TRACE_ID`` set) each record carries the ambient
``trace_id``."""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Deque, Dict, List

from dlrover_tpu_torch.telemetry.trace_context import current_trace_id

EVENTS_FILE_ENV = "DLROVER_TPU_EVENTS_FILE"

_ring: Deque[Dict] = collections.deque(maxlen=4096)
_lock = threading.Lock()


def _events_path() -> str:
    from dlrover_tpu_torch.common.config import get_context

    return (os.environ.get(EVENTS_FILE_ENV, "")
            or get_context().telemetry_events_file)


def emit_event(kind: str, error_code: str = "", **fields) -> Dict:
    from dlrover_tpu_torch.common.config import get_context

    record = {"kind": kind, "ts": time.time(), "mono": time.monotonic(),
              "pid": os.getpid(), "error_code": error_code}
    # the ambient incident id, as the reference stamps it
    tid = current_trace_id()
    if tid:
        record["trace_id"] = tid
    record.update(fields)
    if not get_context().telemetry_enabled:
        return record
    with _lock:
        _ring.append(record)
        path = _events_path()
        if path:
            with open(path, "a") as f:
                f.write(json.dumps(record, default=str) + "\n")
    return record


def clear_ring() -> None:
    with _lock:
        _ring.clear()


def recent_events(n: int = 0) -> List[Dict]:
    with _lock:
        events = list(_ring)
    return events[-n:] if n else events
