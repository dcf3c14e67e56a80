"""Offering windows: reserved capacity as a time-boxed, slot-counted pool
(the JAX package's ``market/offerings.py``, copied).

An :class:`OfferingWindow` models one purchasable reserved-capacity slice of
the market — an ODCR reservation (open-ended, committed price 0: the
marginal cost of capacity already paid for) or a capacity block (a future
``[start_s, end_s)`` window at a committed $/hr). Windows are derived from the
catalog's resolved :class:`catalog.reservations.Reservation` snapshot — the
reservation store stays the single source of truth for slot accounting, and
this module is the pure time/price algebra over it.

Encoding contract: windows land in the RESERVED column of the catalog's
``price[T, Z, C]`` / ``avail[T, Z, C]`` tensors, the columns ``ops/encode.py``
folds into ``price[G, T]`` and ``type_window[T, Z, C]`` and the replacement
paths read. A window that is closed (not started, expired) or slot-exhausted
leaves its cell at (inf, unavailable), so the FFD open phase, the
consolidation screen and the replacement paths see the market through one
tensor. No tensor gains a dimension.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..models import labels as lbl

#: window lifecycle states (state_at)
PENDING = "pending"
OPEN = "open"
EXPIRED = "expired"


@dataclass(frozen=True)
class OfferingWindow:
    """One reserved-capacity window: (type, zone) slots at a committed
    price, purchasable only inside ``[start_s, end_s)``. ``None`` bounds
    mean open-ended on that side (a plain ODCR reservation is
    ``start_s=None, end_s=None, committed_price=0.0``)."""

    id: str
    instance_type: str
    zone: str
    slots: int
    used: int = 0
    committed_price: float = 0.0
    start_s: Optional[float] = None
    end_s: Optional[float] = None
    capacity_type: str = lbl.CAPACITY_TYPE_RESERVED

    @property
    def remaining(self) -> int:
        return max(self.slots - self.used, 0)

    def state_at(self, now: float) -> str:
        if self.start_s is not None and now < self.start_s:
            return PENDING
        if self.end_s is not None and now >= self.end_s:
            return EXPIRED
        return OPEN

    def open_at(self, now: float) -> bool:
        """Purchasable right now: inside the window AND slots remain.
        This is the predicate the price sort must respect — a committed-
        price (often $0) window with no remaining slots winning a
        cheapest-offering sort must never happen."""
        return self.state_at(now) == OPEN and self.remaining > 0


def windows_from_reservations(reservations: Sequence) -> list[OfferingWindow]:
    """Lift the resolved reservation snapshot into windows. Reservations
    without window fields (the pre-market shape) become open-ended
    committed-price-0 windows — the exact legacy semantics."""
    out: list[OfferingWindow] = []
    for r in reservations:
        out.append(OfferingWindow(
            id=r.id,
            instance_type=r.instance_type,
            zone=r.zone,
            slots=int(r.count),
            used=int(r.used),
            committed_price=float(getattr(r, "committed_price", 0.0) or 0.0),
            start_s=getattr(r, "start_s", None),
            end_s=getattr(r, "end_s", None),
        ))
    return out


def apply_window_columns(price, avail, names: Sequence[str],
                         zones: Sequence[str], windows: Sequence[OfferingWindow],
                         now: float, unavailable=None) -> int:
    """Encode open windows into the RESERVED column of the catalog
    tensors (in place). Multiple windows on one (type, zone) cell keep
    the cheapest committed price — the cell is 'the best reserved offer
    purchasable now'. Closed/exhausted windows contribute nothing, and
    the ICE mask still applies on top. Returns the number of cells lit."""
    tidx = {n: i for i, n in enumerate(names)}
    zidx = {z: i for i, z in enumerate(zones)}
    ci = lbl.RESERVED_INDEX
    lit = 0
    for w in windows:
        if not w.open_at(now):
            continue
        ti, zi = tidx.get(w.instance_type), zidx.get(w.zone)
        if ti is None or zi is None:
            continue
        live = True
        if unavailable is not None:
            live = not unavailable.is_unavailable(
                w.instance_type, w.zone, lbl.CAPACITY_TYPE_RESERVED
            )
        price[ti, zi, ci] = min(float(price[ti, zi, ci]), w.committed_price)
        if live:
            avail[ti, zi, ci] = True
            lit += 1
    return lit


def dark_cell_reason(windows: Sequence[OfferingWindow], instance_type: str,
                     zone: str, now: float) -> Optional[str]:
    """Name why the RESERVED cell for ``(instance_type, zone)`` is dark
    right now — the reason a why-attribution reports for a dark market cell.

    A pending window, or an open one with every slot consumed, reads
    ``market:window-closed`` (the market will or did sell here, just not
    now); a window that ran out its clock reads ``reservation:expired``.
    ``None`` means no window ever covered the cell — the darkness is not
    market-caused and the caller falls back to zone/capacity verdicts.
    """
    expired = None
    for w in windows:
        if w.instance_type != instance_type or w.zone != zone:
            continue
        if w.state_at(now) == EXPIRED:
            expired = "reservation:expired"
        else:
            # pending, or open + slot-exhausted (an open window with
            # remaining slots would have lit the cell via open_at)
            return "market:window-closed"
    return expired


def windows_cache_key(windows: Sequence[OfferingWindow], now: float) -> tuple:
    """The time-varying fragment of the catalog cache key: which bounded
    windows are open right now. Slot counts already ride the reservation
    store's seqnum; only the CLOCK-driven open/close transitions need a
    key of their own, so the fragment is empty () for a catalog with only
    open-ended reservations — the pre-market key shape."""
    return tuple(sorted(
        (w.id, w.state_at(now))
        for w in windows
        if w.start_s is not None or w.end_s is not None
    ))
