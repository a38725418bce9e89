"""Trace spans of the port's what-if engine.

The part of the JAX package's ``runtime/tracing.py`` that
``decision/whatif.py`` uses: ``start_trace`` opens a trace, ``span``
times a step inside it, ``end_trace`` closes it with a status
("whatif", "error") and keeps it in a bounded ring of closed traces
(``traces()``). A trace closed with a status other than "ok" bumps
``tracing.traces_<status>``, so what-if round trips never enter the
convergence statistics, as in the reference.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Optional

from openr_tpu_torch.runtime.counters import counters

# ring of closed traces kept for traces()
MAX_CLOSED_TRACES = 256


class TraceContext:
    """One open trace: its root's name and attributes, and its spans."""

    __slots__ = ("trace_id", "name", "attributes", "started", "spans")

    def __init__(self, trace_id: int, name: str, attributes: dict):
        self.trace_id = trace_id
        self.name = name
        self.attributes = attributes
        self.started = time.monotonic()
        self.spans: list[dict] = []


class _Span:
    def __init__(self, ctx: TraceContext, name: str, attributes: dict):
        self._ctx = ctx
        self._span = {"name": name, "attributes": attributes}

    def __enter__(self) -> "_Span":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._span["duration_ms"] = (time.monotonic() - self._t0) * 1e3
        if exc_type is not None:
            self._span["attributes"]["error"] = exc_type.__name__
        if self._ctx is not None:
            self._ctx.spans.append(self._span)
        return False


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._closed: collections.deque = collections.deque(
            maxlen=MAX_CLOSED_TRACES)

    def start_trace(self, name: str, **attributes) -> TraceContext:
        return TraceContext(next(self._seq), name, dict(attributes))

    def span(self, ctx: Optional[TraceContext], name: str,
             **attributes) -> _Span:
        """``with tracer.span(ctx, "whatif.snapshot"): ...`` (recorded
        nowhere when ctx is None)."""
        return _Span(ctx, name, dict(attributes))

    def end_trace(self, ctx: Optional[TraceContext], status: str = "ok",
                  **attributes) -> None:
        if ctx is None:
            return
        ctx.attributes.update(attributes)
        with self._lock:
            self._closed.append({
                "trace_id": ctx.trace_id, "name": ctx.name,
                "status": status, "attributes": ctx.attributes,
                "duration_ms": (time.monotonic() - ctx.started) * 1e3,
                "spans": ctx.spans,
            })
        counters.increment("tracing.traces_closed" if status == "ok"
                           else f"tracing.traces_{status}")

    def traces(self, limit: int = 20) -> list[dict]:
        """The last ``limit`` closed traces, oldest first."""
        with self._lock:
            return list(self._closed)[-max(1, limit):]


tracer = Tracer()
