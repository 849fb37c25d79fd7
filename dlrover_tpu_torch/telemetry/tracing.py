"""Host spans (the subset of ``dlrover_tpu/telemetry/tracing.py`` the
trainer calls): ``span(name)`` records (name, start, duration) into a
bounded ring, two clock reads and one append when telemetry is on."""

from __future__ import annotations

import collections
import time
from contextlib import contextmanager
from typing import Deque, List, Tuple

_spans: Deque[Tuple] = collections.deque(maxlen=16384)


@contextmanager
def span(name: str, **args):
    from dlrover_tpu_torch.common.config import get_context

    if not get_context().telemetry_enabled:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        _spans.append((name, t0 // 1000,
                       (time.perf_counter_ns() - t0) // 1000, args or None))


def snapshot() -> List[Tuple]:
    return list(_spans)
