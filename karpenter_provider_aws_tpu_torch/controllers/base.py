"""Controller protocol + Manager runtime with crash-loop supervision.

The reference rides controller-runtime (reconcile loops with
MaxConcurrentReconciles, singleton controllers with requeue intervals —
SURVEY.md section 2.3). Here a controller is a named ``reconcile()``
callable with an interval; the Manager runs each on its own thread.
Tests call ``reconcile()`` directly for determinism (the reference's
hermetic suites do exactly this with Reconcile()).

Supervision (resilience layer, designs/circuit-breakers.md):

- crash-loop backoff — a controller whose reconcile fails
  ``CRASH_BACKOFF_GRACE`` times in a row is skipped for an exponentially
  growing window (reset on the first success), so a persistently broken
  loop cannot monopolize its thread or spam dependencies at full rate;
- a watchdog — a reconcile still in flight after N x its interval flips
  ``karpenter_controller_stuck{controller}`` to 1 and publishes one
  Warning event per episode (the thread itself cannot be killed; the
  gauge is the page);
- a per-reconcile deadline budget — every pass runs inside a
  ``resilience.budget`` scope that the solver-RPC and AWS-retry seams
  consult ambiently;
- ``/debug/health`` — one JSON page on the metrics server joining
  per-controller backoff/stuck status and the most recent reconcile
  errors.

This package carries no circuit breaker: a solve that raises inside a
reconcile is isolated, logged into ``Manager.errors`` and backed off, as
controller-runtime does with any failing reconcile, and never served by
another backend. Harnesses that drive ``reconcile_all_once`` read
``errors`` after each pass.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional, Protocol

from ..resilience import budget as _budget
from ..trace import span as trace_span
from ..utils.clock import Clock, RealClock

log = logging.getLogger("karpenter.tpu")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# consecutive failures tolerated before backoff arms (the first couple of
# failures retry at full rate, like controller-runtime's rate limiter
# starting in the milliseconds)
CRASH_BACKOFF_GRACE = 3
CRASH_BACKOFF_BASE_S = 1.0
CRASH_BACKOFF_CAP_S = 300.0
# a reconcile is "stuck" after this many times its own interval
STUCK_FACTOR = 3.0
WATCHDOG_PERIOD_S = 1.0


class Controller(Protocol):
    name: str
    interval_s: float

    def reconcile(self) -> None: ...


class Manager:
    def __init__(self, controllers: list[Controller], elector=None,
                 clock: Optional[Clock] = None, recorder=None):
        self.controllers = list(controllers)
        # Leader election (parity: controller-runtime manager's lease gate,
        # cmd/controller/main.go:34): when an elector is present it runs
        # like any controller, and every OTHER controller is idled while
        # this replica does not hold the lease — two replicas of a
        # node-launching control loop must never both write.
        self.elector = elector
        if elector is not None:
            self.controllers.insert(0, elector)
        self.clock = clock or RealClock()
        self._recorder = recorder
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._watchdog: Optional[threading.Thread] = None
        # last reconcile errors, newest last (bounded); controller-runtime
        # parity: a failing reconcile is logged and requeued, never fatal.
        self.errors: list[tuple[str, Exception]] = []
        # supervision state, all under one lock
        self._sup_lock = threading.Lock()
        self._failstreak: dict[str, int] = {}
        self._backoff_until: dict[str, float] = {}
        self._last_error: dict[str, str] = {}
        self._inflight: dict[str, float] = {}   # name -> reconcile start
        self._stuck: set[str] = set()
        self._crashloop_enabled = os.environ.get(
            "KARPENTER_TPU_CRASHLOOP_BACKOFF", "1"
        ) != "0"
        # the freshest manager owns the health page (same replace-on-
        # re-register contract as the obs/ debug pages)
        try:
            from ..metrics import REGISTRY

            REGISTRY.register_debug_page("/debug/health", self.health)
        except Exception:
            pass

    def is_running(self) -> bool:
        """Reconcile loops are up and not stopping (the /readyz source)."""
        return bool(self._threads) and not self._stop.is_set()

    def _idled(self, c: Controller) -> bool:
        return (
            self.elector is not None
            and c is not self.elector
            and not self.elector.is_leader()
        )

    def start(self) -> None:
        for c in self.controllers:
            t = threading.Thread(target=self._run, args=(c,), daemon=True, name=c.name)
            self._threads.append(t)
            t.start()
        self._watchdog = threading.Thread(
            target=self._watch, daemon=True, name="reconcile-watchdog"
        )
        self._watchdog.start()

    def _run(self, c: Controller) -> None:
        while not self._stop.is_set():
            if not self._idled(c):
                self._reconcile_one(c)
            self._stop.wait(c.interval_s)

    def _reconcile_one(self, c: Controller) -> None:
        """One supervised reconcile: crash-loop gate, in-flight tracking
        for the watchdog, a deadline-budget scope, error isolation."""
        name = c.name
        now = self.clock.now()
        with self._sup_lock:
            if c is not self.elector and now < self._backoff_until.get(name, 0.0):
                # crash-looping: sit out the backoff window. The elector
                # is exempt — backing IT off stops lease renewal and idles
                # every other controller for the whole window, turning a
                # transient API brownout into minutes of a leaderless,
                # frozen replica; its own retry cadence is the bound.
                return
            self._inflight[name] = now
        try:
            # flight-recorded: every reconcile is a span, so the
            # /metrics per-controller latency histogram and the
            # Chrome trace of a live manager come for free (the
            # span's error attr marks failing passes). The replica
            # identity rides the span when an elector names one, so N
            # replicas sharing one process registry (new_replicaset)
            # land DISTINGUISHABLE per-replica series instead of
            # silently summing into unlabeled ones.
            attrs = {}
            identity = getattr(self.elector, "identity", None)
            if identity:
                attrs["replica"] = identity
            with trace_span(f"controller.{name}", **attrs):
                with _budget.scope(_budget.Budget(
                    self._budget_s(c), clock=self.clock,
                )):
                    with self._ownership_scope(c):
                        c.reconcile()
        except Exception as e:
            log.exception("controller %s reconcile failed", name)
            self._record_error(c, e)
            self._note_failure(c, e)
        else:
            self._note_success(c)
        finally:
            with self._sup_lock:
                self._inflight.pop(name, None)
                was_stuck = name in self._stuck
                self._stuck.discard(name)
            if was_stuck:
                self._set_stuck_gauge(name, 0.0)

    def _ownership_scope(self, c: Controller):
        """Ambient partition ownership for this reconcile (sharded control
        plane): when the elector publishes an ``ownership()`` snapshot
        (operator/sharding.ShardElector), every OTHER controller runs
        inside ``sharding.scope(snapshot)`` and filters its work through
        the owns_* predicates. The single LeaderElector (no snapshot) and
        elector-less managers change nothing — the predicates answer True
        with no ambient scope."""
        import contextlib

        if (
            self.elector is None
            or c is self.elector
            or not hasattr(self.elector, "ownership")
        ):
            return contextlib.nullcontext()
        from ..operator import sharding

        return sharding.scope(self.elector.ownership())

    @staticmethod
    def _budget_s(c: Controller) -> float:
        """Per-reconcile deadline: N x the controller's own interval with
        a floor, or the explicit env override."""
        override = _env_float("KARPENTER_TPU_RECONCILE_BUDGET_S", 0.0)
        if override > 0:
            return override
        interval = float(getattr(c, "interval_s", 10.0) or 10.0)
        return max(interval * 4.0, 30.0)

    # -- crash-loop supervision --------------------------------------------

    def _note_success(self, c: Controller) -> None:
        with self._sup_lock:
            self._failstreak.pop(c.name, None)
            self._backoff_until.pop(c.name, None)
            self._last_error.pop(c.name, None)

    def _note_failure(self, c: Controller, e: Exception) -> None:
        with self._sup_lock:
            streak = self._failstreak.get(c.name, 0) + 1
            self._failstreak[c.name] = streak
            self._last_error[c.name] = f"{type(e).__name__}: {e}"[:200]
            if (not self._crashloop_enabled or c is self.elector
                    or streak < CRASH_BACKOFF_GRACE):
                return
            delay = min(
                CRASH_BACKOFF_CAP_S,
                CRASH_BACKOFF_BASE_S * (2 ** (streak - CRASH_BACKOFF_GRACE)),
            )
            self._backoff_until[c.name] = self.clock.now() + delay
        try:
            from ..metrics import CRASHLOOP_BACKOFFS

            CRASHLOOP_BACKOFFS.inc(controller=c.name)
        except Exception:
            pass
        log.warning(
            "controller %s crash-looping (%d consecutive failures); "
            "backing off %.1fs", c.name, streak, delay,
        )

    # -- stuck-reconcile watchdog ------------------------------------------

    def _watch(self) -> None:
        while not self._stop.is_set():
            try:
                self.check_stuck()
            except Exception:  # pragma: no cover - defensive
                log.exception("reconcile watchdog check failed")
            self._stop.wait(WATCHDOG_PERIOD_S)

    def check_stuck(self) -> list[str]:
        """Flag every reconcile in flight longer than STUCK_FACTOR x its
        interval. Evaluated on the manager clock so hermetic tests drive
        it deterministically; the background watchdog thread calls it on
        a real cadence. Returns the currently-stuck controller names."""
        now = self.clock.now()
        intervals = {
            c.name: float(getattr(c, "interval_s", 10.0) or 10.0)
            for c in self.controllers
        }
        newly: list[str] = []
        with self._sup_lock:
            for name, since in self._inflight.items():
                limit = max(intervals.get(name, 10.0), 1.0) * STUCK_FACTOR
                if now - since > limit and name not in self._stuck:
                    self._stuck.add(name)
                    newly.append((name, now - since, limit))
            stuck = sorted(self._stuck)
        for name, age, limit in newly:
            self._set_stuck_gauge(name, 1.0)
            log.warning(
                "controller %s reconcile stuck: running %.0fs (limit %.0fs)",
                name, age, limit,
            )
            try:
                from ..events import WARNING

                self._get_recorder().publish(
                    "Controller", name, "ReconcileStuck",
                    f"reconcile running for {age:.0f}s "
                    f"(limit {limit:.0f}s)", type=WARNING,
                )
            except Exception:
                pass
        return stuck

    def _set_stuck_gauge(self, name: str, value: float) -> None:
        try:
            from ..metrics import CONTROLLER_STUCK

            CONTROLLER_STUCK.set(value, controller=name)
        except Exception:
            pass

    def _get_recorder(self):
        if self._recorder is None:
            from ..events import default_recorder

            self._recorder = default_recorder()
        return self._recorder

    # -- /debug/health ------------------------------------------------------

    def health(self) -> dict:
        """Joined supervision view: per-controller backoff/stuck/in-flight
        status, recent reconcile errors."""
        now = self.clock.now()
        with self._sup_lock:
            controllers = {}
            for c in self.controllers:
                name = c.name
                until = self._backoff_until.get(name, 0.0)
                inflight_since = self._inflight.get(name)
                controllers[name] = {
                    "interval_s": float(getattr(c, "interval_s", 0.0) or 0.0),
                    "consecutive_failures": self._failstreak.get(name, 0),
                    "in_backoff": now < until,
                    "backoff_remaining_s": round(max(0.0, until - now), 3),
                    "stuck": name in self._stuck,
                    "inflight_s": (
                        round(now - inflight_since, 3)
                        if inflight_since is not None else None
                    ),
                    "last_error": self._last_error.get(name, ""),
                }
        return {
            "running": self.is_running(),
            "controllers": controllers,
            "recent_errors": [
                [n, f"{type(e).__name__}: {e}"[:200]]
                for n, e in self.errors[-10:]
            ],
        }

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        if self._watchdog is not None:
            self._watchdog.join(timeout=timeout)
        if self.elector is not None:
            stuck = [t.name for t in self._threads if t.is_alive()]
            if stuck:
                # a reconcile is still mid-write: releasing now would let a
                # successor start writing concurrently — keep the lease and
                # let the TTL fence the hand-off instead
                log.warning(
                    "not releasing leader lease: %s still running", stuck
                )
            else:
                # clean shutdown hands the lease off instead of making the
                # successor wait out the TTL
                self.elector.release()

    def _record_error(self, c: Controller, e: Exception) -> None:
        self.errors.append((c.name, e))
        del self.errors[:-50]

    def reconcile_all_once(self) -> None:
        """Deterministic single pass in registration order (test helper).
        Errors are isolated per controller, exactly like the threaded path —
        one failing reconcile must not starve the others. Leadership gating,
        crash-loop backoff, and the budget scope apply exactly like the
        threaded path too."""
        for c in self.controllers:
            if self._idled(c):
                continue
            self._reconcile_one(c)
