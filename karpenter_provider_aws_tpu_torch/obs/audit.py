"""Decision audit log: a bounded, thread-safe ring of structured records.

Every consequential control-plane decision appends one JSON-ready record:
pod placements (winning instance type + price + the top rejected
alternatives), consolidation accept/reject with hourly savings,
interruption drains, evictions, and lifecycle reaps. The ring answers
"why did the controller decide X" after the fact — the judgment-layer
complement to trace/ (which answers "what ran and how long").

Append is O(1) (``deque.append`` under one lock) and the ring is bounded
(``capacity``), so a controller loop running for weeks can never grow
memory through the audit plane. Records are plain data; ``to_jsonl`` /
``load_jsonl`` round-trip them for the ``obs explain`` CLI.
"""

from __future__ import annotations

import itertools
import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

_seq = itertools.count(1)

# Well-known record kinds (free-form strings are allowed; these are what
# the shipped controllers emit and what /debug/decisions groups by).
PLACEMENT = "placement"
DISRUPTION = "disruption"
INTERRUPTION = "interruption"
EVICTION = "eviction"
LIFECYCLE = "lifecycle"


@dataclass(frozen=True)
class AuditRecord:
    seq: int                 # process-unique, monotonic
    at: float                # store-clock timestamp of the decision
    kind: str                # placement | disruption | interruption | ...
    subject_kind: str        # Pod | NodeClaim | Node | NodePool | SLO
    subject: str             # object name
    decision: str            # machine key: launch:<type> | bind:<node> | ...
    detail: dict = field(default_factory=dict)
    rev: Optional[int] = None  # cluster revision at decision time

    def as_dict(self) -> dict:
        d = {
            "seq": self.seq,
            "at": round(float(self.at), 3),
            "kind": self.kind,
            "subject_kind": self.subject_kind,
            "subject": self.subject,
            "decision": self.decision,
            "detail": dict(self.detail),
        }
        if self.rev is not None:
            d["rev"] = int(self.rev)
        return d

    @staticmethod
    def from_dict(d: dict) -> "AuditRecord":
        return AuditRecord(
            seq=int(d.get("seq", 0)),
            at=float(d.get("at", 0.0)),
            kind=str(d.get("kind", "")),
            subject_kind=str(d.get("subject_kind", "")),
            subject=str(d.get("subject", "")),
            decision=str(d.get("decision", "")),
            detail=dict(d.get("detail") or {}),
            rev=d.get("rev"),
        )


class AuditLog:
    """Bounded thread-safe decision ring. One per environment (hermetic
    tests own theirs); the process default backs the CLI and operator."""

    def __init__(self, capacity: int = 8192, clock=None):
        self.clock = clock
        self._lock = threading.Lock()
        self._ring: deque[AuditRecord] = deque(maxlen=capacity)

    def _now(self) -> float:
        if self.clock is not None:
            return self.clock.now()
        import time

        return time.monotonic()

    def record(
        self,
        kind: str,
        subject_kind: str,
        subject: str,
        decision: str,
        detail: Optional[dict] = None,
        at: Optional[float] = None,
        rev: Optional[int] = None,
    ) -> AuditRecord:
        rec = AuditRecord(
            seq=next(_seq),
            at=self._now() if at is None else at,
            kind=kind,
            subject_kind=subject_kind,
            subject=subject,
            decision=decision,
            detail=detail or {},
            rev=rev,
        )
        with self._lock:
            self._ring.append(rec)
        try:
            from ..metrics import AUDIT_RECORDS

            AUDIT_RECORDS.inc(kind=kind)
        except Exception:
            pass
        return rec

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def query(
        self,
        kind: Optional[str] = None,
        subject_kind: Optional[str] = None,
        subject: Optional[str] = None,
        decision_prefix: Optional[str] = None,
        limit: Optional[int] = None,
    ) -> list[AuditRecord]:
        """Filtered records, oldest first. Every non-None filter must
        match; ``limit`` keeps the NEWEST matches."""
        with self._lock:
            out = list(self._ring)
        if kind is not None:
            out = [r for r in out if r.kind == kind]
        if subject_kind is not None:
            out = [r for r in out if r.subject_kind == subject_kind]
        if subject is not None:
            out = [r for r in out if r.subject == subject]
        if decision_prefix is not None:
            out = [r for r in out if r.decision.startswith(decision_prefix)]
        if limit is not None and len(out) > limit:
            out = out[-limit:]
        return out

    def tail(self, n: int = 100) -> list[AuditRecord]:
        with self._lock:
            out = list(self._ring)
        return out[-n:]

    def to_jsonl(self) -> str:
        return "".join(json.dumps(r.as_dict()) + "\n" for r in self.tail(10**9))

    def dump(self, path: str) -> int:
        """Write the ring as JSONL; returns the record count."""
        records = self.tail(10**9)
        with open(path, "w") as f:
            for r in records:
                f.write(json.dumps(r.as_dict()) + "\n")
        return len(records)

    @staticmethod
    def load_jsonl(path: str) -> list[AuditRecord]:
        out: list[AuditRecord] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(AuditRecord.from_dict(json.loads(line)))
                except (json.JSONDecodeError, TypeError, ValueError):
                    continue  # a torn tail line must not sink the query
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()


_default = AuditLog()


def default_audit() -> AuditLog:
    return _default
