"""Incident/trace-ID propagation (a copy of
``dlrover_tpu/telemetry/trace_context.py``).

A trace id is minted at failure detection (the executor seeing a
non-finite step, a change of world, a retune) and rides two channels so
every event record of the incident can be stitched back into one
causally ordered view:

  in-process    a ``contextvars.ContextVar``: ``emit_event`` stamps
                the ambient id onto every record it writes
  cross-restart the worker environment (``DLROVER_TPU_TRACE_ID``): a
                process relaunched as part of an incident inherits the
                id of the incident it recovers from

The gRPC metadata channel (``TRACE_ID_METADATA_KEY``) is the reference's
master RPC layer, which the port's workers reach with ROADMAP A12.
"""

from __future__ import annotations

import contextvars
import os
import uuid
from contextlib import contextmanager
from typing import Iterator, Optional

TRACE_ID_ENV = "DLROVER_TPU_TRACE_ID"
# gRPC metadata keys must be lowercase
TRACE_ID_METADATA_KEY = "dlrover-trace-id"

_ambient: contextvars.ContextVar[str] = contextvars.ContextVar(
    "dlrover_tpu_trace_id", default=""
)


def new_trace_id() -> str:
    """A fresh incident id (short, log-greppable, globally unique
    enough for one job's timeline)."""
    return "inc-" + uuid.uuid4().hex[:16]


def current_trace_id() -> str:
    """The ambient incident id: the context variable when set, else the
    environment (a worker relaunched as part of an incident inherits
    the id from the agent); "" when no incident is open."""
    tid = _ambient.get()
    if tid:
        return tid
    return os.environ.get(TRACE_ID_ENV, "")


def set_trace_id(trace_id: str) -> "contextvars.Token[str]":
    """Set the ambient id; returns the token for ``reset_trace_id``."""
    return _ambient.set(trace_id)


def reset_trace_id(token: "contextvars.Token[str]") -> None:
    _ambient.reset(token)


def clear_trace_id() -> None:
    """Drop the ambient id unconditionally (incident recovered)."""
    _ambient.set("")


@contextmanager
def trace_scope(trace_id: Optional[str] = None) -> Iterator[str]:
    """Run the body under ``trace_id`` (minting one when None); the
    previous ambient id is restored on exit."""
    tid = trace_id or new_trace_id()
    token = _ambient.set(tid)
    try:
        yield tid
    finally:
        _ambient.reset(token)
