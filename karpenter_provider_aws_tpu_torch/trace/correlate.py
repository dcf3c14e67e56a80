"""Causal correlation across replicas: one id per pod/claim lifecycle.

The sharded control plane (PRs 9/12) split one pod's lifecycle across
processes: replica A routes it, replica B claims it from the GLOBAL work
queue after A dies, replica C registers the node and the launcher binds
the nomination. Every per-process observability plane (spans, audit,
events) sees only its own hops — answering "why did pod X take 500s to
bind" meant manually joining N rings with no shared causality.

This module is the joining key (designs/fleet-flight-recorder.md):

- :func:`correlation_id` — a **pure function** of the object's identity
  (``c-<sha256(kind:ident)[:12]>``). No mint RPC, no coordination: every
  replica derives the same id from the same pod/claim independently,
  which is what makes cross-replica correlation work with zero protocol.
- :class:`Hop` — one lifecycle step, stamped with the correlation id,
  the store-clock time, the **replica identity** that performed it
  (resolved from the ambient sharding ownership scope), and — for hops
  sanctioned by a partition lease — the lease's fencing token, so the
  merged timeline can order cross-replica hops on tenancy epochs, not
  just timestamps.
- :class:`CorrelationLedger` — a bounded, thread-safe hop ring with a
  per-correlation-id index and a ``(subject kind, name) -> cid`` alias
  map. ``record_once`` dedupes idempotent hops (a pod stays pending for
  ten passes; its ``route`` hop is minted exactly once), so steady state
  can never grow the ledger through re-reconciles.

The ledger lives on the ``Obs`` bundle (one per hermetic environment; in
a ReplicaSet every replica writes to the shared world's ledger exactly
like the shared audit ring — the N-processes-one-store shape is the
testenv seam, and real deployments serialize per-process ledgers through
``/debug/flight`` for :class:`~..obs.fleet.FleetRecorder` to merge).
Hooks never call back into the cluster store: ``record`` may run under
its lock.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Optional

#: bounded hop history (a steady-state fleet dedupes to ~8 hops per pod
#: lifecycle; 64k hops covers a multi-thousand-pod simulated day)
LEDGER_CAP = 65536

#: the replica stamp used when no sharding ownership scope is ambient
SINGLE_REPLICA = "single"

#: a COMPLETE pod chain (correlation coverage) carries a lifecycle START
#: hop — ``pending`` (first sight) or ``evict`` (a drained pod re-enters
#: pending; its original pending hop may predate the recorder) — and the
#: terminal ``bind``; everything between (route, queue claim, solve,
#: launch, nominate) depends on how the pod landed
START_POD_HOPS = ("pending", "evict")
REQUIRED_POD_HOPS = ("pending", "bind")  # kept for back-compat docs


def chain_complete(kinds) -> bool:
    """Is a pod chain complete? (the coverage gate's one rule)"""
    kinds = set(kinds)
    return "bind" in kinds and any(k in kinds for k in START_POD_HOPS)


import functools


@functools.lru_cache(maxsize=65536)
def correlation_id(kind: str, ident: str) -> str:
    """Deterministic correlation id for one object identity. Pods key on
    their uid, claims on their name — both stable for the object's whole
    lifetime and identical on every replica. Memoized: the provisioner
    and the 1s host binder re-derive ids for every still-pending pod on
    every pass."""
    digest = hashlib.sha256(f"{kind}:{ident}".encode()).hexdigest()
    return f"c-{digest[:12]}"


def current_replica() -> str:
    """The replica identity to stamp on a hop: the ambient sharding
    ownership's replica when a scope is active (Manager-wrapped
    reconciles in an N-replica deployment), else ``single``."""
    from ..operator import sharding

    own = sharding.current()
    return own.replica if own is not None else SINGLE_REPLICA


@dataclass(frozen=True)
class Hop:
    """One lifecycle step of one correlated object."""

    seq: int                   # ledger-local, monotonic (merge tiebreak)
    cid: str                   # correlation id
    at: float                  # store-clock timestamp
    replica: str               # identity of the replica performing the hop
    kind: str                  # pending | route | claim | steal | solve | ...
    subject_kind: str = ""     # Pod | NodeClaim
    subject: str = ""          # object name
    detail: dict = field(default_factory=dict)
    fence: Optional[tuple] = None  # (lease name, token) sanctioning the hop

    def as_dict(self) -> dict:
        d = {
            "seq": self.seq,
            "cid": self.cid,
            "at": round(float(self.at), 3),
            "replica": self.replica,
            "kind": self.kind,
            "subject_kind": self.subject_kind,
            "subject": self.subject,
        }
        if self.detail:
            d["detail"] = dict(self.detail)
        if self.fence:
            d["fence"] = [self.fence[0], int(self.fence[1])]
        return d

    @staticmethod
    def from_dict(d: dict) -> "Hop":
        fence = d.get("fence")
        return Hop(
            seq=int(d.get("seq", 0)),
            cid=str(d.get("cid", "")),
            at=float(d.get("at", 0.0)),
            replica=str(d.get("replica", SINGLE_REPLICA)),
            kind=str(d.get("kind", "")),
            subject_kind=str(d.get("subject_kind", "")),
            subject=str(d.get("subject", "")),
            detail=dict(d.get("detail") or {}),
            fence=tuple(fence) if fence else None,
        )


def merge_key(hop: Hop) -> tuple:
    """The cross-replica merge order (designs/fleet-flight-recorder.md):
    store-clock time first (all replicas share the store's clock base —
    the lease-audit tick base), then the ledger sequence (within one
    shared-world ledger, append order IS causal order — the common
    testenv/sim/chaos shape), then the fencing-token epoch (the
    remaining tiebreak when N per-process ledgers are concatenated and
    seq streams interleave: an adopt under tenancy 3 sorts after a
    launch under tenancy 2)."""
    return (round(hop.at, 6), hop.seq, hop.fence[1] if hop.fence else 0)


class CorrelationLedger:
    """Bounded thread-safe hop ring + per-cid index + name alias map."""

    def __init__(self, capacity: int = LEDGER_CAP, clock=None):
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: deque[Hop] = deque(maxlen=capacity)
        self._seq = itertools.count(1)
        # cid -> list of hops (pruned lazily against the ring's tail)
        self._by_cid: "OrderedDict[str, list[Hop]]" = OrderedDict()
        # (subject kind, subject name) -> cid — the CLI looks objects up
        # by name; correlation ids key on uids for pods
        self._alias: dict[tuple, str] = {}
        # (cid, kind, dedupe key) already recorded (record_once)
        self._seen: set = set()

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        import time

        return time.monotonic()

    # -- minting -----------------------------------------------------------
    def mint(self, subject_kind: str, ident: str,
             name: Optional[str] = None) -> str:
        """Resolve (and alias) the correlation id for one object. Pure on
        ``(subject_kind, ident)``; registering the human name makes the
        object findable by ``<kind>/<name>``."""
        cid = correlation_id(subject_kind, ident)
        key = (subject_kind, name or ident)
        if self._alias.get(key) == cid:  # steady-state fast path
            return cid
        with self._lock:
            self._alias[key] = cid
            if name is not None and name != ident:
                self._alias[(subject_kind, ident)] = cid
        return cid

    def resolve(self, subject_kind: str, name: str) -> Optional[str]:
        with self._lock:
            return self._alias.get((subject_kind, name))

    # -- recording ---------------------------------------------------------
    def record(self, cid: str, kind: str, subject_kind: str = "",
               subject: str = "", detail: Optional[dict] = None,
               at: Optional[float] = None, replica: Optional[str] = None,
               fence: Optional[tuple] = None) -> Hop:
        hop = Hop(
            seq=next(self._seq),
            cid=cid,
            at=self._now() if at is None else at,
            replica=current_replica() if replica is None else replica,
            kind=kind,
            subject_kind=subject_kind,
            subject=subject,
            detail=detail or {},
            fence=tuple(fence) if fence else None,
        )
        with self._lock:
            evicted = (
                self._ring[0]
                if len(self._ring) == self._ring.maxlen else None
            )
            self._ring.append(hop)
            self._by_cid.setdefault(cid, []).append(hop)
            if evicted is not None:
                hops = self._by_cid.get(evicted.cid)
                if hops:
                    hops.remove(evicted)
                    if not hops:
                        self._by_cid.pop(evicted.cid, None)
        try:
            from ..metrics import CORRELATION_HOPS

            CORRELATION_HOPS.inc(kind=kind)
        except Exception:
            pass
        return hop

    def has_recorded(self, cid: str, kind: str, key: str = "") -> bool:
        """Lock-free peek at the :meth:`record_once` dedupe set — the
        hot controller loops check this FIRST and skip the per-pod
        mint/partition work for objects already narrated."""
        return (cid, kind, key) in self._seen

    def record_once(self, cid: str, kind: str, key: str = "",
                    **kw) -> Optional[Hop]:
        """Record unless an identical ``(cid, kind, key)`` hop exists —
        the idempotence contract that lets every reconcile pass re-route
        a still-pending pod without growing its chain."""
        token = (cid, kind, key)
        with self._lock:
            if token in self._seen:
                return None
            if len(self._seen) >= 4 * (self._ring.maxlen or LEDGER_CAP):
                # bounded like the ring: once enough lifecycles have
                # passed to wrap it several times over, the evicted
                # chains' dedupe tokens are dead weight — drop the set
                # (live chains at worst re-record one idempotent hop)
                self._seen.clear()
            self._seen.add(token)
        return self.record(cid, kind, **kw)

    # -- reading -----------------------------------------------------------
    def hops(self, cid: str) -> list[Hop]:
        """One object's hops in cross-replica merge order."""
        with self._lock:
            out = list(self._by_cid.get(cid, ()))
        return sorted(out, key=merge_key)

    def all_hops(self) -> list[Hop]:
        with self._lock:
            return list(self._ring)

    def cids(self) -> list[str]:
        with self._lock:
            return list(self._by_cid)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- persistence (the /debug/flight + CLI offline surface) -------------
    def snapshot(self) -> dict:
        with self._lock:
            hops = list(self._ring)
            alias = {
                f"{kind}/{name}": cid
                for (kind, name), cid in self._alias.items()
            }
        return {
            "hops": [h.as_dict() for h in hops],
            "alias": alias,
        }

    @staticmethod
    def from_snapshot(data: dict, clock=None) -> "CorrelationLedger":
        ledger = CorrelationLedger(clock=clock)
        for key, cid in (data.get("alias") or {}).items():
            kind, _, name = key.partition("/")
            ledger._alias[(kind, name)] = cid
        for d in data.get("hops", ()):
            hop = Hop.from_dict(d)
            ledger._ring.append(hop)
            ledger._by_cid.setdefault(hop.cid, []).append(hop)
        return ledger

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._by_cid.clear()
            self._alias.clear()
            self._seen.clear()
