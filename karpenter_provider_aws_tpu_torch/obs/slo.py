"""SLO engine: declarative objectives + multi-window burn-rate alerting.

An ``SLOSpec`` declares what the control plane promises (pod time-to-bind,
nodeclaim time-to-ready, ...) as a target ratio over a compliance window
plus Google-SRE-style multi-window burn rules: a rule fires only when the
error-budget burn rate exceeds its factor over BOTH the long and the short
window — fast enough to page on a real regression, immune to a single bad
minute.

The engine is fed discrete SLI events (good/bad, clock-stamped) by the
lifecycle observer and controllers, evaluates inside the liveness loop
(``Obs.tick``), exports ``karpenter_slo_error_budget_remaining{slo}`` /
``karpenter_slo_burn_rate{slo,window}`` gauges, and publishes a Warning
event per newly-firing fast burn. All time comes from the injected clock,
so chaos scenarios exercise burn alerts deterministically.

Spec format (JSON-ready, ``SLOSpec.from_dict``)::

    {"name": "pod-time-to-bind", "objective": 0.99, "window_s": 3600,
     "threshold_s": 300, "description": "...",
     "burn_rules": [{"long_s": 3600, "short_s": 300, "factor": 14.4},
                    {"long_s": 21600, "short_s": 1800, "factor": 6.0}]}
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

# Default burn rules: the classic 2%-of-budget-in-1h page and the
# 5%-in-6h ticket (SRE workbook chapter 5), scaled to our windows.
DEFAULT_BURN_RULES = ((3600.0, 300.0, 14.4), (21600.0, 1800.0, 6.0))

EVENTS_PER_SLO = 8192  # bounded per-SLO event history


@dataclass(frozen=True)
class BurnRule:
    long_s: float
    short_s: float
    factor: float

    def as_dict(self) -> dict:
        return {"long_s": self.long_s, "short_s": self.short_s, "factor": self.factor}


@dataclass
class SLOSpec:
    """One declared objective. ``threshold_s`` classifies latency samples
    (good iff <= threshold); ratio-style SLIs skip it and record
    good/bad directly."""

    name: str
    objective: float = 0.99            # target good-ratio
    window_s: float = 3600.0           # compliance window for the budget gauge
    threshold_s: Optional[float] = None
    description: str = ""
    burn_rules: tuple = tuple(BurnRule(*r) for r in DEFAULT_BURN_RULES)

    @property
    def budget(self) -> float:
        """Allowed error ratio (never 0: a 1.0 objective would make any
        single bad event an infinite burn)."""
        return max(1.0 - self.objective, 1e-9)

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "objective": self.objective,
            "window_s": self.window_s,
            "threshold_s": self.threshold_s,
            "description": self.description,
            "burn_rules": [r.as_dict() for r in self.burn_rules],
        }

    @staticmethod
    def from_dict(d: dict) -> "SLOSpec":
        rules = tuple(
            BurnRule(float(r["long_s"]), float(r["short_s"]), float(r["factor"]))
            for r in d.get("burn_rules", [])
        ) or tuple(BurnRule(*r) for r in DEFAULT_BURN_RULES)
        return SLOSpec(
            name=str(d["name"]),
            objective=float(d.get("objective", 0.99)),
            window_s=float(d.get("window_s", 3600.0)),
            threshold_s=(
                float(d["threshold_s"]) if d.get("threshold_s") is not None else None
            ),
            description=str(d.get("description", "")),
            burn_rules=rules,
        )


def default_slos() -> list[SLOSpec]:
    """The control plane's shipped promises (docs/observability.md)."""
    return [
        SLOSpec(
            name="pod-time-to-bind",
            objective=0.99,
            window_s=3600.0,
            threshold_s=300.0,
            description="99% of pods bind within 5 minutes of going pending",
        ),
        SLOSpec(
            name="nodeclaim-time-to-ready",
            objective=0.99,
            window_s=3600.0,
            threshold_s=900.0,
            description="99% of nodeclaims are initialized within 15 minutes "
                        "of creation (liveness reaps count as misses)",
        ),
        SLOSpec(
            name="solve-success",
            objective=0.999,
            window_s=3600.0,
            description="99.9% of solve passes place every pod they were "
                        "handed (a pass leaving pods unschedulable is a miss)",
        ),
    ]


class SLOEngine:
    """Event store + evaluator. Thread-safe; all timestamps come from the
    injected clock (or the event producers' own stamps)."""

    def __init__(self, clock=None, recorder=None, specs=None):
        self.clock = clock
        self.recorder = recorder
        self._lock = threading.Lock()
        self._specs: dict[str, SLOSpec] = {}
        self._events: dict[str, deque] = {}   # slo -> deque[(t, good)]
        self._firing: set[tuple[str, float]] = set()  # (slo, long_s) active burns
        for spec in (specs if specs is not None else default_slos()):
            self.configure(spec)

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        import time

        return time.monotonic()

    # -- spec management ---------------------------------------------------
    def configure(self, spec: SLOSpec) -> SLOSpec:
        """Install or replace one SLO spec (history is kept — re-declaring
        a target mid-flight re-judges the same events)."""
        with self._lock:
            self._specs[spec.name] = spec
            self._events.setdefault(spec.name, deque(maxlen=EVENTS_PER_SLO))
        return spec

    def spec(self, name: str) -> Optional[SLOSpec]:
        with self._lock:
            return self._specs.get(name)

    def specs(self) -> list[SLOSpec]:
        with self._lock:
            return list(self._specs.values())

    # -- SLI feed ----------------------------------------------------------
    def record(self, slo: str, good: bool, at: Optional[float] = None) -> None:
        at = self._now() if at is None else at
        with self._lock:
            q = self._events.get(slo)
            if q is None:  # undeclared SLO: auto-register with defaults
                self._specs[slo] = SLOSpec(name=slo)
                q = self._events[slo] = deque(maxlen=EVENTS_PER_SLO)
            q.append((at, bool(good)))

    def record_latency(self, slo: str, seconds: float, at: Optional[float] = None) -> None:
        """Judge one latency sample against the spec's threshold (specs
        without a threshold treat every sample as good)."""
        spec = self.spec(slo)
        thr = spec.threshold_s if spec is not None else None
        self.record(slo, thr is None or seconds <= thr, at=at)

    def record_bad(self, slo: str, at: Optional[float] = None) -> None:
        self.record(slo, False, at=at)

    # -- evaluation --------------------------------------------------------
    def _ratio(self, events, t0: float, now: float) -> tuple[int, int]:
        """(bad, total) within (t0, now]."""
        bad = total = 0
        for t, good in events:
            if t0 < t <= now:
                total += 1
                if not good:
                    bad += 1
        return bad, total

    @staticmethod
    def _windower(events):
        """Build an O(log n) window counter over one spec's events.

        Returns ``window(t0, now) -> (bad, total)`` equivalent to
        :meth:`_ratio`. Events almost always arrive in time order (they
        are stamped by a monotonic clock), so a prefix-bad-count array +
        two bisects answers each window query without rescanning the
        whole deque — the difference between O(events) and O(log events)
        per window matters once a fleet-simulator day has pushed the
        per-SLO history to its 8192 cap and every liveness tick evaluates
        five windows per spec. Falls back to the exact linear scan when
        the history is out of order."""
        import bisect

        times = [t for t, _ in events]
        for i in range(1, len(times)):
            if times[i] < times[i - 1]:
                return None  # unsorted: caller uses the linear scan
        bad_prefix = [0]
        for _, good in events:
            bad_prefix.append(bad_prefix[-1] + (0 if good else 1))

        def window(t0: float, now: float) -> tuple[int, int]:
            hi = bisect.bisect_right(times, now)
            lo = bisect.bisect_right(times, t0)
            return bad_prefix[hi] - bad_prefix[lo], hi - lo

        return window

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass: refresh gauges, fire/clear burn alerts.
        Returns the JSON-ready snapshot /debug/slo serves."""
        from ..metrics import SLO_BUDGET_REMAINING, SLO_BURN_RATE

        now = self._now() if now is None else now
        with self._lock:
            work = [
                (spec, list(self._events.get(spec.name, ())))
                for spec in self._specs.values()
            ]
        out: dict = {"at": round(now, 3), "slos": []}
        for spec, events in work:
            win = self._windower(events)
            if win is None:
                win = lambda t0, t1: self._ratio(events, t0, t1)  # noqa: E731
            bad, total = win(now - spec.window_s, now)
            err = bad / total if total else 0.0
            remaining = max(0.0, 1.0 - err / spec.budget)
            SLO_BUDGET_REMAINING.set(remaining, slo=spec.name)
            rules_out = []
            for rule in spec.burn_rules:
                bad_l, tot_l = win(now - rule.long_s, now)
                bad_s, tot_s = win(now - rule.short_s, now)
                burn_l = (bad_l / tot_l / spec.budget) if tot_l else 0.0
                burn_s = (bad_s / tot_s / spec.budget) if tot_s else 0.0
                SLO_BURN_RATE.set(
                    burn_l, slo=spec.name, window=f"{int(rule.long_s)}s"
                )
                firing = burn_l >= rule.factor and burn_s >= rule.factor
                key = (spec.name, rule.long_s)
                with self._lock:
                    was = key in self._firing
                    if firing:
                        self._firing.add(key)
                    else:
                        self._firing.discard(key)
                if firing and not was and self.recorder is not None:
                    from ..events import WARNING

                    self.recorder.publish(
                        "SLO", spec.name, "SLOFastBurn",
                        f"error budget burning {burn_l:.1f}x sustainable "
                        f"over {int(rule.long_s)}s (threshold {rule.factor}x; "
                        f"{bad_l}/{tot_l} bad)",
                        type=WARNING,
                    )
                rules_out.append({
                    "long_s": rule.long_s, "short_s": rule.short_s,
                    "factor": rule.factor,
                    "burn_long": round(burn_l, 3),
                    "burn_short": round(burn_s, 3),
                    "firing": firing,
                })
            out["slos"].append({
                "name": spec.name,
                "objective": spec.objective,
                "window_s": spec.window_s,
                "threshold_s": spec.threshold_s,
                "events_in_window": total,
                "bad_in_window": bad,
                "error_ratio": round(err, 5),
                "budget_remaining": round(remaining, 4),
                "burn_rules": rules_out,
            })
        return out

    def reset(self) -> None:
        with self._lock:
            for q in self._events.values():
                q.clear()
            self._firing.clear()
