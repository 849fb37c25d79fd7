"""Counters, gauges and fixed-bucket histograms (the subset of
``dlrover_tpu/telemetry/metrics.py`` the trainer calls), with the
reference's Prometheus text rendering: the same metrics render the same
text in both packages.

``get_registry()`` hands back a null registry when the Context knob
``telemetry_enabled`` is off, so call sites hold handles with one API
either way; ``process_registry()`` is the real one regardless.
"""

from __future__ import annotations

import math
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


class Gauge:
    """A value that goes up and down."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help, self.value = name, help, 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


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
    kind = "null"
    name = ""
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, v: float = 1.0) -> None:
        pass

    def dec(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
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

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DURATION_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._metrics)

    def reset(self) -> None:
        """Drop every metric (tests, A/B runs)."""
        with self._lock:
            self._metrics.clear()

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4, line for line the
        reference's for unlabeled series."""
        lines: List[str] = []
        for name, m in sorted(self.snapshot().items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for i, bound in enumerate(m.bounds):
                    cum += m.counts[i]
                    lines.append(f'{name}_bucket{{le="{_fmt(bound)}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {_fmt(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class NullRegistry:
    _NULL = _NullMetric()

    def counter(self, name: str, help: str = "") -> _NullMetric:
        return self._NULL

    def gauge(self, name: str, help: str = "") -> _NullMetric:
        return self._NULL

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DURATION_BUCKETS) -> _NullMetric:
        return self._NULL

    def get(self, name: str):
        return None

    def snapshot(self) -> Dict[str, object]:
        return {}

    def reset(self) -> None:
        pass

    def render_prometheus(self) -> str:
        return ""


_REGISTRY = MetricsRegistry()
_NULL_REGISTRY = NullRegistry()


def get_registry():
    from dlrover_tpu_torch.common.config import get_context

    if not get_context().telemetry_enabled:
        return _NULL_REGISTRY
    return _REGISTRY


def process_registry() -> MetricsRegistry:
    """The real registry regardless of the enable knob (what an
    exposition path dumps)."""
    return _REGISTRY
