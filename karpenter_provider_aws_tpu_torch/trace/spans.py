"""Monotonic-clock span recorder: the flight-recorder core.

Design constraints (designs/tracing.md):

- **Steady-state safe.** Completed spans land in a bounded ring buffer
  (``collections.deque(maxlen=...)``); a controller loop running for weeks
  can never grow memory through the recorder.
- **Near-zero when disabled.** ``tracer.span(...)`` returns one shared
  no-op context manager and allocates nothing — call sites never branch
  on whether tracing is on.
- **Exception safe.** ``__exit__`` always pops the thread-local stack and
  stamps an ``error`` attr; a raising solve leaves no dangling parent for
  the next span on the thread.
- **Nestable across threads.** The span stack is thread-local, so the
  Manager's per-controller threads and the launch worker pool each get
  correct parent/child edges; ids are process-unique.

The clock is ``time.perf_counter_ns`` — monotonic, immune to NTP steps,
and the same family the solver's existing stage timings use, so span
durations and ``TPUSolver.timings`` agree.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

_ids = itertools.count(1)


@dataclass
class Span:
    name: str
    t0_ns: int                  # perf_counter_ns at __enter__
    dur_ns: int = 0             # filled at __exit__
    tid: int = 0                # thread ident (Chrome export lane)
    span_id: int = 0
    parent_id: int = 0          # 0 = root
    attrs: dict = field(default_factory=dict)

    @property
    def duration_ms(self) -> float:
        return self.dur_ns / 1e6

    @property
    def duration_s(self) -> float:
        return self.dur_ns / 1e9


class _NoopSpan:
    """Shared do-nothing context manager for the disabled path — one
    module-level instance, so a disabled-tracer call site allocates
    nothing and costs one attribute check + one method call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NoopSpan":
        return self


_NOOP = _NoopSpan()


class _SpanCtx:
    """One live span: context manager handed out by ``Tracer.span``."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def set(self, **attrs) -> "_SpanCtx":
        self.span.attrs.update(attrs)
        return self

    def __enter__(self) -> "_SpanCtx":
        stack = self._tracer._stack()
        if stack:
            self.span.parent_id = stack[-1].span_id
        stack.append(self.span)
        self.span.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.span.dur_ns = time.perf_counter_ns() - self.span.t0_ns
        stack = self._tracer._stack()
        # pop OUR span even if an inner span leaked (belt and braces: a
        # generator-held span abandoned mid-iteration must not corrupt
        # every later parent edge on this thread)
        while stack:
            top = stack.pop()
            if top is self.span:
                break
        if exc_type is not None:
            self.span.attrs["error"] = exc_type.__name__
        self._tracer._finish(self.span)
        return False


class Tracer:
    """Span recorder with a bounded ring buffer and finish hooks.

    ``capacity`` bounds retained completed spans (the flight recorder's
    tape length); ``on_finish`` callbacks run synchronously at span end —
    the metrics bridge (export.py) rides this to feed histograms with no
    second timing layer. Callback failures are swallowed: observability
    must never take down the path it observes.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        self._buf: deque[Span] = deque(maxlen=capacity)
        self._enabled = enabled
        self._local = threading.local()
        self._callbacks: list[Callable[[Span], None]] = []

    # -- state -------------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    # -- recording ---------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager for one timed region. ``with tracer.span("x")
        as s: s.set(k=v)``; returns the shared no-op when disabled."""
        if not self._enabled:
            return _NOOP
        return _SpanCtx(
            self, Span(
                name=name, t0_ns=0, tid=threading.get_ident(),
                span_id=next(_ids), attrs=attrs,
            )
        )

    def traced(self, name: Optional[str] = None, **attrs):
        """Decorator form: ``@tracer.traced("solve.decode")``."""

        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label, **attrs):
                    return fn(*a, **kw)

            return wrapper

        return deco

    def annotate(self, **attrs) -> None:
        """Attach attrs to the INNERMOST live span on this thread (no-op
        without one) — how deep layers add detail (e.g. the AWS retry
        count) without threading a span object through every signature."""
        if not self._enabled:
            return
        stack = getattr(self._local, "stack", None)
        if stack:
            stack[-1].attrs.update(attrs)

    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def _finish(self, span: Span) -> None:
        self._buf.append(span)
        for cb in self._callbacks:
            try:
                cb(span)
            except Exception:
                pass

    # -- consumption -------------------------------------------------------

    def snapshot(self) -> list[Span]:
        """Completed spans, oldest first (non-destructive)."""
        return list(self._buf)

    def drain(self) -> list[Span]:
        """Snapshot and clear the tape."""
        out = list(self._buf)
        self._buf.clear()
        return out

    def clear(self) -> None:
        self._buf.clear()

    def on_finish(self, cb: Callable[[Span], None]) -> Callable[[Span], None]:
        self._callbacks.append(cb)
        return cb

    def remove_on_finish(self, cb: Callable[[Span], None]) -> None:
        if cb in self._callbacks:
            self._callbacks.remove(cb)


# The process-wide default tracer. Enabled by default: the per-span cost is
# two perf_counter_ns reads + one small object, paid a handful of times per
# reconcile/solve — and the metrics bridge depends on it. ``TRACER.disable()``
# turns every instrumentation point into the shared no-op.
TRACER = Tracer()


def span(name: str, **attrs):
    return TRACER.span(name, **attrs)


def traced(name: Optional[str] = None, **attrs):
    return TRACER.traced(name, **attrs)


def annotate(**attrs) -> None:
    TRACER.annotate(**attrs)
