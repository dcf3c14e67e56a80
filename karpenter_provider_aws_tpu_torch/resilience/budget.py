"""Per-reconcile deadline budgets, propagated ambiently.

A reconcile that is allowed to take forever starves every other control
loop behind it. The Manager opens one ``Budget`` per reconcile pass (N x
the controller's interval by default) and installs it in a thread-local
scope; the expensive seams consult it without plumbing a parameter
through every call site:

- ``SolverClient._call`` shrinks its RPC timeout to the remaining budget
  (instead of the flat 120 s default) — a solve dispatched with 4 s of
  reconcile budget left gets a 4 s deadline, not two minutes;
- ``Session._retrying`` stops its retry ladder (and Retry-After sleeps)
  when the budget is exhausted, surfacing ``retry_reason="budget"``.

Time accounting is ``max(clock elapsed, charged)``: under a RealClock the
clock dominates; under a FakeClock (or a Session with a no-op sleep) the
explicit ``charge()`` calls from skipped sleeps keep the arithmetic
honest without any wall-time dependence — deterministic under chaos.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

from ..utils.clock import Clock, RealClock

_tls = threading.local()


class Budget:
    """A monotonic deadline: ``total_s`` seconds from construction."""

    def __init__(self, total_s: float, clock: Optional[Clock] = None):
        self.total_s = float(total_s)
        self._clock = clock or RealClock()
        self._t0 = self._clock.now()
        self._charged = 0.0
        self._lock = threading.Lock()

    def charge(self, seconds: float) -> None:
        """Explicitly spend budget (for sleeps a fake clock swallows)."""
        with self._lock:
            self._charged += max(float(seconds), 0.0)

    def elapsed(self) -> float:
        with self._lock:
            charged = self._charged
        return max(self._clock.now() - self._t0, charged)

    def remaining(self) -> float:
        return max(0.0, self.total_s - self.elapsed())

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0


@contextmanager
def scope(budget: Budget):
    """Install ``budget`` as the ambient deadline for this thread."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(budget)
    try:
        yield budget
    finally:
        stack.pop()


def current() -> Optional[Budget]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def remaining() -> Optional[float]:
    """Seconds left in the ambient budget, or None when no scope is
    active (callers fall back to their own flat timeouts)."""
    b = current()
    return None if b is None else b.remaining()


def charge(seconds: float) -> None:
    """Charge the ambient budget, if any (no-op outside a scope)."""
    b = current()
    if b is not None:
        b.charge(seconds)
