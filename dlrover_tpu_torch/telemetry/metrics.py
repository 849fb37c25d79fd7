"""Counters and fixed-bucket histograms (the subset of
``dlrover_tpu/telemetry/metrics.py`` the trainer calls).

``get_registry()`` hands back a null registry when the Context knob
``telemetry_enabled`` is off, so call sites hold handles with one API
either way.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

# seconds, 0.5 ms .. 60 s, roughly log-spaced
DURATION_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Counter:
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DURATION_BUCKETS):
        self.name, self.help = name, help
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets))
        # per-bucket counts, the +Inf bucket last
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count, self.sum = 0, 0.0

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class _NullMetric:
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


class MetricsRegistry:
    """Name -> metric; creation is idempotent and thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            metric = self._metrics.get(name)
            if metric is None:
                metric = self._metrics[name] = cls(name, help, **kwargs)
        if type(metric) is not cls:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{metric.kind}")
        return metric

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DURATION_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)


class NullRegistry:
    _NULL = _NullMetric()

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return self._NULL

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DURATION_BUCKETS) -> _NullMetric:
        return self._NULL

    def get(self, name: str):
        return None


_REGISTRY = MetricsRegistry()
_NULL_REGISTRY = NullRegistry()


def get_registry():
    from dlrover_tpu_torch.common.config import get_context

    if not get_context().telemetry_enabled:
        return _NULL_REGISTRY
    return _REGISTRY
