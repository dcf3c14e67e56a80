"""Lifecycle SLIs: pod pending->nominated->bound, claim created->ready.

``LifecycleSLI`` is the cluster observer (``state.Cluster.observer``): the
sanctioned mutation surface (apply/bind_pod/unbind_pod/delete) and the
registration/liveness controllers call its hooks, and it turns transitions
into:

 - ``karpenter_pod_scheduling_duration_seconds{phase}`` histograms
   (nominate = pending->nominated, bind = pending->bound),
 - ``karpenter_nodeclaim_lifecycle_duration_seconds{phase}`` histograms
   (launch / register / ready / total),
 - SLI events fed to the SLO engine (pod-time-to-bind,
   nodeclaim-time-to-ready),
 - eviction audit records (one per drained pod — the chaos acceptance
   surface), and
 - bounded raw-duration rings so the bench can report exact p50/p99
   time-to-bind instead of reconstructing percentiles from buckets.

All timestamps are in the cluster store's clock base (FakeClock under
test/chaos — transitions are deterministic per seed). Hooks never call
back into the Cluster: they may run under its lock.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

SAMPLE_CAP = 4096  # bounded raw-duration history (bench percentile source)


def percentile(samples, q: float):
    """Nearest-rank percentile over raw samples (None when empty) — THE
    percentile used by /debug/cluster and the SLI bench rows, so the two
    can never disagree about the same samples."""
    s = sorted(samples)
    if not s:
        return None
    return round(float(s[min(len(s) - 1, int(q * len(s)))]), 3)


class LifecycleSLI:
    def __init__(self, clock=None, engine=None, audit=None, ledger=None):
        self.clock = clock
        self.engine = engine       # SLOEngine or None
        self.audit = audit         # AuditLog or None
        self.ledger = ledger       # CorrelationLedger or None (hop mint)
        self._lock = threading.Lock()
        self._pod_pending: dict[str, float] = {}      # uid -> pending-at
        self._pod_name: dict[str, str] = {}           # uid -> name (audit)
        self._claims: dict[str, dict] = {}            # name -> phase times
        # sharded provisioning (GLOBAL work queue): uid -> enqueue time,
        # consumed when the pod's work is claimed/stolen off the queue
        self._pod_enqueued: dict[str, float] = {}
        self.bind_samples: deque = deque(maxlen=SAMPLE_CAP)   # (uid, seconds)
        self.ready_samples: deque = deque(maxlen=SAMPLE_CAP)  # (claim, seconds)
        # queue-wait: enqueue->claim for every GLOBAL pod; steal-wait: the
        # subset whose claim was a STEAL (the GLOBAL holder was dead) —
        # the replica-loss tail the provisioning-4r gate bounds
        self.queue_wait_samples: deque = deque(maxlen=SAMPLE_CAP)
        self.steal_wait_samples: deque = deque(maxlen=SAMPLE_CAP)

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        import time

        return time.monotonic()

    def _hop_once(self, kind: str, ident: str, hop_kind: str, key: str = "",
                  name: Optional[str] = None, **kw) -> None:
        """Mint the subject's correlation id and record one idempotent
        hop; never raises (observability must not sink the store)."""
        if self.ledger is None:
            return
        try:
            cid = self.ledger.mint(kind, ident, name=name)
            self.ledger.record_once(
                cid, hop_kind, key=key, subject_kind=kind,
                subject=name or ident, **kw
            )
        except Exception:
            pass

    # -- pod lifecycle -----------------------------------------------------
    def pod_applied(self, pod, now: Optional[float] = None) -> None:
        """First sight of a pending pod starts its scheduling clock AND
        mints its correlation id (the flight recorder's first hop);
        re-applies of a tracked pod are no-ops."""
        now = self._now() if now is None else now
        with self._lock:
            self._pod_name[pod.uid] = pod.name
            if pod.node_name:
                # applied already-bound (restored state): nothing to time
                self._pod_pending.pop(pod.uid, None)
                return
            if pod.uid in self._pod_pending:
                return
            self._pod_pending[pod.uid] = now
        self._hop_once("Pod", pod.uid, "pending", name=pod.name, at=now)

    def pod_nominated(self, uid: str, now: Optional[float] = None,
                      claim: Optional[str] = None) -> None:
        now = self._now() if now is None else now
        with self._lock:
            t0 = self._pod_pending.get(uid)
            name = self._pod_name.get(uid, uid)
        if t0 is None:
            return
        from ..metrics import POD_SCHEDULING_SECONDS

        POD_SCHEDULING_SECONDS.observe(max(0.0, now - t0), phase="nominate")
        self._hop_once(
            "Pod", uid, "nominate", key=claim or "", name=name, at=now,
            detail={"claim": claim} if claim else None,
        )

    # -- sharded provisioning (GLOBAL work queue) --------------------------
    def pod_routed_global(self, uid: str, now: Optional[float] = None) -> None:
        """A pending pod entered the work-stealing GLOBAL queue: start its
        queue-wait clock (idempotent — re-routed pods keep the FIRST
        enqueue time; the SLI measures how long work sat unclaimed)."""
        now = self._now() if now is None else now
        with self._lock:
            self._pod_enqueued.setdefault(uid, now)

    def pod_work_claimed(self, uid: str, now: Optional[float] = None,
                         stolen: bool = False) -> None:
        """The pod's GLOBAL-queue work was claimed (by the GLOBAL holder)
        or stolen (the holder was dead). One queue-wait sample per pod;
        stolen claims feed the steal-wait ring too."""
        now = self._now() if now is None else now
        with self._lock:
            t0 = self._pod_enqueued.pop(uid, None)
            if t0 is None:
                return
            wait = max(0.0, now - t0)
            self.queue_wait_samples.append((uid, wait))
            if stolen:
                self.steal_wait_samples.append((uid, wait))
        from ..metrics import POD_QUEUE_WAIT_SECONDS

        POD_QUEUE_WAIT_SECONDS.observe(
            wait, outcome="stolen" if stolen else "claimed"
        )

    def pod_bound(self, uid: str, node_name: str, now: Optional[float] = None) -> None:
        now = self._now() if now is None else now
        with self._lock:
            t0 = self._pod_pending.pop(uid, None)
            name = self._pod_name.get(uid, uid)
        if t0 is None:
            return
        dur = max(0.0, now - t0)
        from ..metrics import POD_SCHEDULING_SECONDS

        POD_SCHEDULING_SECONDS.observe(dur, phase="bind")
        with self._lock:
            self.bind_samples.append((uid, dur))
        if self.engine is not None:
            self.engine.record_latency("pod-time-to-bind", dur, at=now)
        if self.ledger is not None:
            try:
                # plain record (not once): pod_bound fires exactly once
                # per pending episode, and an evict->rebind onto the SAME
                # node must still appear as a second bind hop. The binder
                # is read off the innermost live reconcile span — three
                # controllers can land a bind (scheduling / registration /
                # provisioning) and the timeline should say which did.
                detail = {"node": node_name, "pending_s": round(dur, 3)}
                from ..trace.spans import TRACER

                cur = TRACER.current()
                if cur is not None and cur.name.startswith("controller."):
                    detail["binder"] = cur.name[len("controller."):]
                self.ledger.record(
                    self.ledger.mint("Pod", uid, name=name), "bind",
                    subject_kind="Pod", subject=name, at=now, detail=detail,
                )
            except Exception:
                pass

    def pod_unbound(self, uid: str, old_node: str, now: Optional[float] = None) -> None:
        """Eviction/drain: the pod re-enters pending and its scheduling
        clock restarts; one eviction audit record per drained pod."""
        now = self._now() if now is None else now
        with self._lock:
            self._pod_pending[uid] = now
            name = self._pod_name.get(uid, uid)
        if self.audit is not None:
            from .audit import EVICTION

            self.audit.record(
                EVICTION, "Pod", name, f"evict:{old_node or '?'}",
                {"node": old_node, "uid": uid}, at=now,
            )
        if self.ledger is not None:
            try:
                # an eviction restarts the lifecycle; record (not once —
                # a pod can be evicted repeatedly) so the merged timeline
                # shows the re-pending edge between two bind hops
                self.ledger.record(
                    self.ledger.mint("Pod", uid, name=name), "evict",
                    subject_kind="Pod", subject=name, at=now,
                    detail={"node": old_node},
                )
            except Exception:
                pass

    def pod_deleted(self, uid: str) -> None:
        with self._lock:
            self._pod_pending.pop(uid, None)
            self._pod_name.pop(uid, None)

    # -- nodeclaim lifecycle -----------------------------------------------
    def claim_applied(self, claim, now: Optional[float] = None) -> None:
        """Tracks created (first sight) and launched (provider id set) —
        both flow through Cluster.apply, so no controller changes needed."""
        now = self._now() if now is None else now
        launched = bool(claim.status.provider_id)
        from ..metrics import NODECLAIM_LIFECYCLE_SECONDS

        with self._lock:
            st = self._claims.get(claim.name)
            if st is None:
                st = self._claims[claim.name] = {"created": now}
            if launched and "launched" not in st:
                st["launched"] = now
                delta = max(0.0, now - st["created"])
            else:
                return
        NODECLAIM_LIFECYCLE_SECONDS.observe(delta, phase="launch")
        self._hop_once("NodeClaim", claim.name, "launched", at=now,
                       detail={"provider_id": claim.status.provider_id})

    def claim_registered(self, claim, now: Optional[float] = None) -> None:
        now = self._now() if now is None else now
        from ..metrics import NODECLAIM_LIFECYCLE_SECONDS

        with self._lock:
            st = self._claims.setdefault(claim.name, {"created": now})
            if "registered" in st:
                return
            st["registered"] = now
            base = st.get("launched", st["created"])
        NODECLAIM_LIFECYCLE_SECONDS.observe(
            max(0.0, now - base), phase="register"
        )
        self._hop_once(
            "NodeClaim", claim.name, "register", at=now,
            detail={"node": claim.status.node_name},
        )

    def claim_ready(self, claim, now: Optional[float] = None) -> None:
        now = self._now() if now is None else now
        from ..metrics import NODECLAIM_LIFECYCLE_SECONDS

        with self._lock:
            st = self._claims.setdefault(claim.name, {"created": now})
            if "ready" in st:
                return
            st["ready"] = now
            base = st.get("registered", st.get("launched", st["created"]))
            total = max(0.0, now - st["created"])
            self.ready_samples.append((claim.name, total))
        NODECLAIM_LIFECYCLE_SECONDS.observe(max(0.0, now - base), phase="ready")
        NODECLAIM_LIFECYCLE_SECONDS.observe(total, phase="total")
        if self.engine is not None:
            self.engine.record_latency("nodeclaim-time-to-ready", total, at=now)
        self._hop_once("NodeClaim", claim.name, "ready", at=now,
                       detail={"total_s": round(total, 3)})

    def claim_reaped(self, claim_name: str, now: Optional[float] = None) -> None:
        """Liveness reap: the claim never became a node — an SLO miss."""
        now = self._now() if now is None else now
        if self.engine is not None:
            self.engine.record_bad("nodeclaim-time-to-ready", at=now)
        with self._lock:
            self._claims.pop(claim_name, None)

    def claim_gone(self, claim_name: str) -> None:
        with self._lock:
            self._claims.pop(claim_name, None)

    # -- introspection -----------------------------------------------------
    def pending_ages(self, now: Optional[float] = None) -> dict[str, float]:
        now = self._now() if now is None else now
        with self._lock:
            return {
                self._pod_name.get(uid, uid): max(0.0, now - t0)
                for uid, t0 in self._pod_pending.items()
            }

    def bind_durations(self) -> list[float]:
        with self._lock:
            return [d for _, d in self.bind_samples]

    def ready_durations(self) -> list[float]:
        with self._lock:
            return [d for _, d in self.ready_samples]

    def queue_wait_durations(self) -> list[float]:
        with self._lock:
            return [d for _, d in self.queue_wait_samples]

    def steal_wait_durations(self) -> list[float]:
        with self._lock:
            return [d for _, d in self.steal_wait_samples]

    def bound_uids(self) -> list[str]:
        """Uids of the pods whose binds this SLI timed — the correlation
        coverage denominator (obs/fleet.py)."""
        with self._lock:
            return [uid for uid, _ in self.bind_samples]

    def reset(self) -> None:
        with self._lock:
            self._pod_pending.clear()
            # _pod_name survives: it is an identity map, not judgment
            # history — a pre-reset pod evicted later (the simulator's
            # ballast) must still narrate under its name, not its uid
            self._claims.clear()
            self._pod_enqueued.clear()
            self.bind_samples.clear()
            self.ready_samples.clear()
            self.queue_wait_samples.clear()
            self.steal_wait_samples.clear()
