"""Observability for the port: metrics registry, event timeline, host
spans, trace ids and the attribution plane (the part of
``dlrover_tpu.telemetry`` the trainer calls; ``attribution`` is imported
as a module of its own)."""

from dlrover_tpu_torch.telemetry import names
from dlrover_tpu_torch.telemetry.events import emit_event, recent_events
from dlrover_tpu_torch.telemetry.metrics import get_registry
from dlrover_tpu_torch.telemetry.names import EventKind, SpanName
from dlrover_tpu_torch.telemetry.trace_context import trace_scope
from dlrover_tpu_torch.telemetry.tracing import span

__all__ = ["names", "EventKind", "SpanName", "emit_event", "recent_events",
           "get_registry", "span", "trace_scope"]
