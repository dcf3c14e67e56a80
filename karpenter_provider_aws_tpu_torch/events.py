"""Event recorder: the kube-Event analogue for operational visibility.

Parity: the reference publishes an event for every interruption message,
disruption decision, launch, and unschedulable pod through the core
events.Recorder (upstream `pkg/controllers/interruption/controller.go:219-238`
uses recorder.Publish; the core decorates it with dedupe). Here the sink is
an in-memory ring with TTL dedupe + a counter metric — the control plane has
no apiserver, so "publishing" means: queryable by operators/tests, counted
in metrics, logged once per dedupe window.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger("karpenter.tpu.events")

NORMAL = "Normal"
WARNING = "Warning"


@dataclass(frozen=True)
class Event:
    kind: str        # object kind: NodeClaim | Pod | Node | NodePool
    name: str        # object name
    type: str        # Normal | Warning
    reason: str      # CamelCase machine key (Launched, Disrupted, ...)
    message: str
    at: float = 0.0
    count: int = 1   # occurrences within the dedupe window


class EventRecorder:
    """Thread-safe bounded event sink with per-(object, reason, message)
    TTL dedupe — repeats within the window bump a count instead of
    appending (the core recorder's dedupe semantics)."""

    def __init__(self, clock=None, dedupe_ttl_s: float = 120.0, capacity: int = 4096):
        self.clock = clock
        self.dedupe_ttl_s = dedupe_ttl_s
        self._lock = threading.Lock()
        self._ring: deque[Event] = deque(maxlen=capacity)
        self._last: dict[tuple, list] = {}  # key -> [first_at, Event, count]
        self._next_sweep = 0.0

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        import time

        return time.monotonic()

    def publish(
        self,
        kind: str,
        name: str,
        reason: str,
        message: str,
        type: str = NORMAL,
    ) -> bool:
        """Record one event; returns False when deduped into a prior one."""
        key = (kind, name, reason, message)
        now = self._now()
        with self._lock:
            hit = self._last.get(key)
            if hit is not None and now - hit[0] < self.dedupe_ttl_s:
                # count in place — no ring mutation (a deque.remove scan per
                # hot deduped event would serialize publishers)
                hit[2] += 1
                return False
            ev = Event(kind, name, type, reason, message, at=now)
            self._last[key] = [now, ev, 1]
            self._ring.append(ev)
            # opportunistic eviction: the dedupe map would otherwise grow
            # one entry per unique (object, reason, message) forever (claim
            # names are unique per launch — weeks of churn = a leak).
            # Time-gated to at most one O(map) sweep per half-TTL, so an
            # event storm cannot make every publish pay a rebuild under the
            # lock, and expired storm entries are reclaimed within ~TTL/2
            # of expiring instead of lingering behind a growth ratchet.
            if len(self._last) > 2 * self._ring.maxlen and now >= self._next_sweep:
                self._sweep_locked(now)
        try:
            from .metrics import EVENTS

            EVENTS.inc(type=type, reason=reason)
        except Exception:
            pass
        log.info("%s %s/%s: %s (%s)", type, kind, name, reason, message)
        return True

    def _sweep_locked(self, now: float) -> int:
        """Drop expired dedupe entries (caller holds the lock). Before an
        entry goes, its live repeat count is written back onto the ring
        Event it shadows, so ``events()`` keeps reporting the true count
        after the dedupe map forgets the key."""
        cutoff = now - self.dedupe_ttl_s
        expired = [k for k, v in self._last.items() if v[0] < cutoff]
        for k in expired:
            v = self._last.pop(k)
            if v[2] != v[1].count:
                object.__setattr__(v[1], "count", v[2])
        self._next_sweep = now + self.dedupe_ttl_s / 2
        return len(expired)

    def sweep(self, now: Optional[float] = None) -> int:
        """Idle-cluster memory hygiene: evict expired dedupe entries even
        when no new events arrive (publish only sweeps opportunistically,
        so a quiet cluster after an event storm would otherwise hold the
        whole map until the NEXT storm). Called from the obs/ engine tick;
        returns the number of entries dropped."""
        now = self._now() if now is None else now
        with self._lock:
            return self._sweep_locked(now)

    def query(
        self,
        kind: Optional[str] = None,
        name: Optional[str] = None,
        reason: Optional[str] = None,
    ) -> list[Event]:
        """Filterable accessor over the retained ring (the ``obs explain``
        CLI's join surface) — alias of :meth:`events` with the filter
        semantics spelled out: every non-None argument must match."""
        return self.events(kind=kind, name=name, reason=reason)

    def events(
        self,
        kind: Optional[str] = None,
        name: Optional[str] = None,
        reason: Optional[str] = None,
    ) -> list[Event]:
        with self._lock:
            out = []
            for e in self._ring:
                hit = self._last.get((e.kind, e.name, e.reason, e.message))
                n = hit[2] if hit is not None and hit[1] is e else e.count
                out.append(e if n == e.count else Event(
                    e.kind, e.name, e.type, e.reason, e.message, at=e.at, count=n
                ))
        if kind is not None:
            out = [e for e in out if e.kind == kind]
        if name is not None:
            out = [e for e in out if e.name == name]
        if reason is not None:
            out = [e for e in out if e.reason == reason]
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._last.clear()
            self._next_sweep = 0.0


_default = EventRecorder()


def default_recorder() -> EventRecorder:
    return _default
