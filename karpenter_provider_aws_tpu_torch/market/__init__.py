"""Market state: reserved-capacity windows and the market kill switch (the
JAX package's ``market/``, without its simulator scenarios).

- :mod:`market.offerings` — reserved pools and time-boxed capacity blocks as
  :class:`OfferingWindow` s (start/end, committed price, remaining slots),
  encoded into the reserved column of the catalog's ``[T, Z, C]``
  price/availability tensors;
- :class:`catalog.pricing.MarketModel` — seeded price walks and per-offering
  spot-reclaim probability, pure functions of ``(seed, instance_type, zone,
  tick)`` on the injected clock.

Kill switch: ``KARPENTER_TPU_MARKET=0`` disables every market effect — no
walks applied, no windows encoded, no reclaim premium — and the catalog's
tensors are byte-identical to a provider that never held market state.
"""

from __future__ import annotations

import os


def market_enabled() -> bool:
    """The market kill switch, read per call so it can be flipped live."""
    return os.environ.get("KARPENTER_TPU_MARKET", "1") != "0"


from .offerings import (  # noqa: E402
    OfferingWindow,
    apply_window_columns,
    dark_cell_reason,
    windows_cache_key,
    windows_from_reservations,
)

__all__ = [
    "market_enabled",
    "OfferingWindow",
    "apply_window_columns",
    "dark_cell_reason",
    "windows_cache_key",
    "windows_from_reservations",
]
