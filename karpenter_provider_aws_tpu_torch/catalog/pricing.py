"""Pricing: $/hr catalog with static seed prices + live-refresh interface.

Reference parity: ``pkg/providers/pricing/pricing.go`` — compiled-in seed
prices (pricing.go:43), on-demand refresh via a pricing API, per-zone spot
prices with an on-demand-derived default (pricing.go:75-90,141-156), and an
isolated-VPC mode that skips live refresh (pricing.go:164-170).

The price *model* is deterministic (a function of the type's shape), standing
in for the reference's generated ``zz_generated.pricing_*.go`` tables. A
``PriceUpdate`` hook lets a live backend override any entry, mirroring
UpdateOnDemandPricing / UpdateSpotPricing.
"""

from __future__ import annotations

import hashlib
import math
import threading
from typing import TYPE_CHECKING, Mapping, Optional

from ..models import labels as lbl

if TYPE_CHECKING:
    from .instancetypes import InstanceType

# Seed $/vcpu-hr by category; generation discount compounds 8%/gen newer than 5.
_BASE_VCPU_RATE = {
    "c": 0.0425, "m": 0.0480, "r": 0.0630, "x": 0.0835,
    "i": 0.0780, "t": 0.0209, "d": 0.0690,
    "g": 0.2500, "p": 0.7500, "inf": 0.1800, "trn": 0.3300,
}
_ARM_DISCOUNT = 0.80       # arm lines price ~20% under x86 peers
_METAL_PREMIUM = 1.10
_NVME_PREMIUM = 1.12
_NET_PREMIUM = 1.08
_GEN_DISCOUNT = 0.92


def _jitter(seed: str, lo: float, hi: float) -> float:
    h = int.from_bytes(hashlib.sha256(seed.encode()).digest()[:4], "big")
    return lo + (hi - lo) * (h / 0xFFFFFFFF)


#: live-refresh staleness TTL: the reference's pricing controller refreshes
#: hourly; past this age a once-live source is considered stale and
#: observe_staleness publishes a PricingStale Warning (docs/observability.md)
PRICING_STALE_TTL_S = 3900.0

# Static seed-price tables (codegen output, copied into this package).
from .zz_generated_pricing import (  # noqa: E402
    INITIAL_ON_DEMAND_PRICES as _STATIC_OD,
    INITIAL_SPOT_PRICES as _STATIC_SPOT,
)


class PricingProvider:
    """Thread-safe price source; static model + overridable live updates."""

    def __init__(self, isolated_vpc: bool = False, clock=None):
        from ..utils.clock import RealClock

        self._od_overrides: dict[str, float] = {}
        # per-(type, zone) on-demand overrides: AWS on-demand is regional,
        # but the launch-path price comparisons are per-OFFERING (reference
        # iterates Offerings.Available() prices) — a live backend that does
        # report zonal variance must be representable
        self._od_zone_overrides: dict[tuple[str, str], float] = {}
        self._spot_overrides: dict[tuple[str, str], float] = {}
        self._lock = threading.RLock()
        self._seq = 0
        self.isolated_vpc = isolated_vpc
        self._clock = clock or RealClock()
        # staleness observability: wall of the last live refresh per source
        # ("spot" / "on-demand"); empty until a live backend has pushed at
        # least once — a static-catalog process is not "stale", it is
        # static (observe_staleness docstring)
        self._last_refresh: dict[str, float] = {}
        # the attached MarketModel (None = static market). The model never
        # changes query results by itself: its walks arrive through the
        # same update_spot override channel a live backend uses, and its
        # reclaim probabilities are read by the catalog tensor build.
        self.market: Optional["MarketModel"] = None

    # -- static seed tables (codegen output; parity: pricing.go:43 loading
    # the compiled-in zz_generated.pricing_* maps; loaded once) ------------
    def _static_od(self, name: str) -> Optional[float]:
        return _STATIC_OD.get(name)

    def _static_spot(self, name: str, zone: str) -> Optional[float]:
        return _STATIC_SPOT.get(name, {}).get(zone)

    # -- static model ------------------------------------------------------
    def _model_od(self, it: "InstanceType") -> float:
        rate = _BASE_VCPU_RATE.get(it.category, 0.05)
        price = rate * it.vcpus
        price *= _GEN_DISCOUNT ** max(0, it.generation - 5)
        if it.arch == "arm64":
            price *= _ARM_DISCOUNT
        if it.bare_metal:
            price *= _METAL_PREMIUM
        if it.local_nvme_gib:
            price *= _NVME_PREMIUM
        if it.family.endswith("n"):
            price *= _NET_PREMIUM
        if it.gpu_count:
            price += it.gpu_count * {"a10g": 0.60, "a100": 2.45, "h100": 6.90}.get(it.gpu_name, 1.0)
        if it.accelerator_count:
            price += it.accelerator_count * (0.95 if it.accelerator_name == "trainium" else 0.23)
        return round(price, 5)

    # -- queries (parity: OnDemandPrice / SpotPrice) -----------------------
    def on_demand_price(self, it: "InstanceType") -> float:
        with self._lock:
            override = self._od_overrides.get(it.name)
            if override is not None:
                return override
            static = self._static_od(it.name)
            return static if static is not None else self._model_od(it)

    def on_demand_price_zonal(self, it: "InstanceType", zone: str) -> float:
        """Per-(type, zone) on-demand offering price: the zonal override if
        a live backend set one, else the regional price."""
        with self._lock:
            override = self._od_zone_overrides.get((it.name, zone))
            if override is not None:
                return override
        return self.on_demand_price(it)

    def spot_price(self, it: "InstanceType", zone: str) -> float:
        """Zonal spot; default derived from on-demand when no live data
        (parity: pricing.go:141-156 spotPrice fallback)."""
        with self._lock:
            override = self._spot_overrides.get((it.name, zone))
            if override is not None:
                return override
            static = self._static_spot(it.name, zone)
            if static is not None:
                return static
            od = self.on_demand_price(it)
            return round(od * _jitter(f"{it.name}:{zone}", 0.24, 0.44), 5)

    def base_spot_price(self, it: "InstanceType", zone: str) -> float:
        """The UNWALKED spot price: static table / on-demand-derived model,
        live overrides ignored. The MarketModel multiplies this — never the
        override — so repeated ticks compose as ``base x multiplier(tick)``
        instead of compounding drift."""
        with self._lock:
            static = self._static_spot(it.name, zone)
            if static is not None:
                return static
            od = self.on_demand_price(it)
            return round(od * _jitter(f"{it.name}:{zone}", 0.24, 0.44), 5)

    # -- live refresh (parity: UpdateOnDemandPricing / UpdateSpotPricing) --
    def update_on_demand(self, prices: Mapping[str, float]) -> None:
        if self.isolated_vpc:
            return
        with self._lock:
            self._od_overrides.update(prices)
            self._seq += 1
            self._last_refresh["on-demand"] = self._clock.now()

    def update_on_demand_zonal(self, prices: Mapping[tuple[str, str], float]) -> None:
        if self.isolated_vpc:
            return
        with self._lock:
            self._od_zone_overrides.update(prices)
            self._seq += 1
            self._last_refresh["on-demand"] = self._clock.now()

    def update_spot(self, prices: Mapping[tuple[str, str], float]) -> None:
        if self.isolated_vpc:
            return
        with self._lock:
            self._spot_overrides.update(prices)
            self._seq += 1
            self._last_refresh["spot"] = self._clock.now()

    def reset(self) -> None:
        with self._lock:
            self._od_overrides.clear()
            self._od_zone_overrides.clear()
            self._spot_overrides.clear()
            self._last_refresh.clear()
            self._seq += 1

    def seq_num(self) -> int:
        with self._lock:
            return self._seq

    # -- staleness observability -----------------------------------------
    def observe_staleness(self, ttl_s: float = PRICING_STALE_TTL_S,
                          recorder=None) -> dict[str, float]:
        """Publish ``karpenter_pricing_age_seconds{source}`` for every
        source a live backend has refreshed, and a ``PricingStale``
        Warning event once an age crosses ``ttl_s``. A source that has
        NEVER refreshed is not reported: a static-catalog process runs on
        compiled-in prices by design and must not page. Isolated-VPC mode
        skips live refresh entirely (pricing.go:164-170 parity), so it
        never reports either. Returns ``{source: age_seconds}``."""
        with self._lock:
            if self.isolated_vpc:
                return {}
            now = self._clock.now()
            ages = {src: max(0.0, now - at)
                    for src, at in self._last_refresh.items()}
        from ..metrics import PRICING_AGE

        for src, age in ages.items():
            PRICING_AGE.set(age, source=src)
            if age > ttl_s:
                if recorder is None:
                    from ..events import default_recorder

                    recorder = default_recorder()
                recorder.publish(
                    kind="PricingProvider", name=src, reason="PricingStale",
                    message=(
                        f"{src} pricing last refreshed {age:.0f}s ago "
                        f"(TTL {ttl_s:.0f}s); cost decisions are running "
                        "on stale market data"
                    ),
                    type="Warning",
                )
        return ages

class MarketModel:
    """Seeded, clock-driven market: price-volatility walks and per-offering
    spot-reclaim probability, both PURE functions of
    ``(seed, instance_type, zone, tick)``.

    Determinism contract (the same one faults and traces obey): no ambient
    randomness, no wall time — every draw is a sha256 of the seed and the
    coordinates, and time is the injected clock quantized to ``tick_s``.
    Two models with the same seed therefore produce byte-identical price
    traces, and a resumed run re-derives the identical market at any tick.

    The walk per (type, zone) is a diurnal sinusoid with hashed phase and
    amplitude plus bounded per-tick hash noise — cheap (no state to
    integrate), smooth at the tick scale, and mean-reverting by
    construction. Reclaim probability rises as the walk dips under par:
    cheap spot is crowded spot, which is exactly when AWS reclaims it.

    ``apply()`` pushes the walked spot prices through the SAME
    ``update_spot`` override channel a live pricing backend uses, so
    downstream (tensor build, seqnum cache keys, provenance) cannot tell
    a simulated market from a real one. The reclaim-probability discount
    is folded into price VALUES at tensor build
    (``catalog/provider.py``), never into new jit arguments — tensor
    shapes are untouched.
    """

    def __init__(self, seed: int = 0, clock=None, volatility: float = 0.35,
                 reclaim_lambda: float = 0.25, tick_s: float = 300.0,
                 period_s: float = 86400.0):
        from ..utils.clock import RealClock

        self.seed = int(seed)
        self.clock = clock or RealClock()
        self.volatility = float(volatility)
        # $/hr risk premium per unit reclaim probability: effective spot
        # price = spot x (1 + reclaim_lambda x p_reclaim). The expected
        # cost of a reclaim (drain + relaunch + rebind) amortized over the
        # instance's mean life (0.25 by default).
        self.reclaim_lambda = float(reclaim_lambda)
        self.tick_s = float(tick_s)
        self.period_s = float(period_s)

    # -- deterministic draws ----------------------------------------------
    def _u(self, *key) -> float:
        h = hashlib.sha256(
            ":".join(str(k) for k in (self.seed,) + key).encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / float(1 << 64)

    def tick_index(self, now: Optional[float] = None) -> int:
        now = self.clock.now() if now is None else now
        return int(now // self.tick_s)

    # -- the walk ----------------------------------------------------------
    def spot_multiplier(self, name: str, zone: str,
                        now: Optional[float] = None) -> float:
        """Walked price over base price for one offering at ``now``:
        diurnal sine (hashed phase/amplitude per offering) + bounded
        per-tick hash noise, floored at 0.2x."""
        now = self.clock.now() if now is None else now
        phase = self._u("phase", name, zone) * 2.0 * math.pi
        amp = self.volatility * (0.5 + 0.5 * self._u("amp", name, zone))
        base = 1.0 + amp * math.sin(2.0 * math.pi * now / self.period_s + phase)
        t = self.tick_index(now)
        # two-tick average keeps adjacent ticks correlated (a walk, not
        # white noise) while staying a pure function of the tick index
        noise = (
            self._u("noise", name, zone, t)
            + self._u("noise", name, zone, t - 1)
            - 1.0
        ) * self.volatility * 0.5
        return max(0.2, base + noise)

    def reclaim_probability(self, name: str, zone: str,
                            now: Optional[float] = None) -> float:
        """P(reclaim within the pricing horizon) for a spot offering:
        a hashed per-offering base rate, amplified when the walk trades
        under par (cheap spot = crowded pool = reclaim pressure)."""
        now = self.clock.now() if now is None else now
        base = 0.02 + 0.08 * self._u("reclaim", name, zone)
        pressure = max(0.0, 1.0 - self.spot_multiplier(name, zone, now))
        return min(0.9, base + 1.5 * pressure * (0.5 + 0.5 * self._u("sens", name, zone)))

    # -- application --------------------------------------------------------
    def apply(self, catalog) -> int:
        """Push the current tick's walked spot prices into the catalog's
        pricing overrides (the live-refresh channel — seqnums bump, caches
        invalidate, exactly like a real backend). No-op (returns 0) when
        the market kill switch is off, so ``KARPENTER_TPU_MARKET=0`` runs
        never see a walked price."""
        from ..market import market_enabled

        if not market_enabled():
            return 0
        now = self.clock.now()
        updates: dict[tuple[str, str], float] = {}
        for it in catalog.list():
            for o in it.offerings:
                if o.capacity_type != lbl.CAPACITY_TYPE_SPOT:
                    continue
                base = catalog.pricing.base_spot_price(it, o.zone)
                updates[(it.name, o.zone)] = round(
                    base * self.spot_multiplier(it.name, o.zone, now), 5
                )
        if updates:
            catalog.pricing.update_spot(updates)
        return len(updates)
