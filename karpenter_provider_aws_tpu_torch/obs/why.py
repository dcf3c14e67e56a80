"""The why-not engine's live board.

The JAX package's ``obs/why.py`` computes a per-(group, type) elimination
bitmask on the device and decodes it into ranked reasons for every
unschedulable pod. This package does not carry that plane yet: the solver
refuses ``KARPENTER_TPU_WHY`` when it is asked for, ``enabled()`` is False,
and the board the provisioning controller stamps stays empty. What is here
is the board itself (``WhyBoard``, ``board``) and its ``/debug/why`` page,
so that the controller keeps the reference's shape.
"""

from __future__ import annotations

import threading
from typing import Mapping, Optional


def enabled() -> bool:
    """The why plane is not carried: always False (``KARPENTER_TPU_WHY=1``
    raises at the solver instead)."""
    return False


class WhyBoard:
    """Bounded newest-wins record of decoded attributions, keyed by pod
    name — the live lookup surface behind the ``/debug/why`` page.
    Thread-safe; O(1) per stamp."""

    def __init__(self, cap: int = 1024):
        self._cap = cap
        self._lock = threading.Lock()
        self._records: dict[str, dict] = {}
        self._hist: dict[str, int] = {}

    def stamp(self, name: str, rec: Mapping, at: float = 0.0) -> None:
        entry = dict(rec)
        entry["at"] = float(at)
        with self._lock:
            self._records.pop(name, None)
            self._records[name] = entry
            top = str(entry.get("top", ""))
            if top:
                self._hist[top] = self._hist.get(top, 0) + 1
            while len(self._records) > self._cap:
                self._records.pop(next(iter(self._records)))

    def get(self, name: str) -> Optional[dict]:
        with self._lock:
            rec = self._records.get(name)
            return dict(rec) if rec else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "records": {k: dict(v) for k, v in self._records.items()},
                "reasons": dict(sorted(self._hist.items())),
            }

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._hist.clear()


_board = WhyBoard()


def board() -> WhyBoard:
    return _board


def debug_why_page() -> dict:
    """``/debug/why``: the ranked reason histogram plus the newest decoded
    records (newest last — insertion order is stamp order)."""
    snap = _board.snapshot()
    recs = list(snap["records"].items())
    return {
        "reasons": snap["reasons"],
        "records": dict(recs[-64:]),
        "total": len(recs),
    }
