"""Injectable clock so controllers/caches are deterministic under test."""

from __future__ import annotations

import threading
import time
from typing import Protocol


class Clock(Protocol):
    def now(self) -> float: ...
    def sleep(self, seconds: float) -> None: ...


class RealClock:
    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock:
    """Manually-advanced clock for hermetic tests.

    Sub-tick interpolation (opt-in via :meth:`enable_subtick`): every
    ``now()`` read between two ``advance()`` calls returns a slightly
    later timestamp (``tick + reads * resolution``, capped below
    ``cap_s``), so events recorded inside one harness step — e.g. fifty
    pods bound by one reconcile pass — land on *distinct* timestamps
    instead of all snapping to the tick. Without it, SLI histograms
    driven by a stepped clock degenerate to p50 == p99 == the step size.

    The interpolated value is a function of the read COUNT since the last
    advance, so it is deterministic exactly when the clock's readers are
    — single-threaded drivers (the fleet simulator, the SLI bench, every
    ``reconcile_all_once`` loop) replay byte-identically per seed.
    Returned time never decreases, even when an ``advance()`` smaller
    than the accumulated sub-tick offset lands. Default off: tests that
    assert exact tick values see the historical behavior unchanged.
    """

    def __init__(self, start: float = 0.0):
        self._t = start
        self._lock = threading.Lock()
        self._subtick_s = 0.0
        self._subtick_cap_s = 0.0
        self._reads = 0
        self._last = start

    def now(self) -> float:
        with self._lock:
            if self._subtick_s <= 0.0:
                # max with _last: after a disable_subtick() the plain path
                # must not step BEHIND timestamps already handed out under
                # interpolation (when subtick was never enabled, _last
                # tracks _t exactly and this is the historical value)
                self._last = max(self._last, self._t)
                return self._last
            self._reads += 1
            t = self._t + min(self._reads * self._subtick_s, self._subtick_cap_s)
            self._last = max(self._last, t)
            return self._last

    def enable_subtick(self, resolution_s: float = 0.001, cap_s: float = 2.0) -> None:
        """Turn on sub-tick read interpolation. ``cap_s`` must stay below
        the smallest ``advance()`` the harness uses, or late reads in a
        busy tick flatten onto the cap (still monotonic, merely less
        discriminating)."""
        with self._lock:
            self._subtick_s = float(resolution_s)
            self._subtick_cap_s = float(cap_s)
            self._reads = 0

    def disable_subtick(self) -> None:
        with self._lock:
            self._subtick_s = 0.0
            self._subtick_cap_s = 0.0
            self._reads = 0

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._t += seconds
            self._reads = 0
            self._last = max(self._last, self._t)
