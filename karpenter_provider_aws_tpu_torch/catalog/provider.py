"""CatalogProvider: the cached, seqnum-versioned view the solver consumes.

Reference parity: ``pkg/providers/instancetype/instancetype.go`` —
``DefaultProvider.List`` with a composite cache key of seqnums/hashes
(instancetype.go:121-139), 12h refresh, RWMutex-guarded snapshots
(instancetype.go:65-79), and ``createOfferings`` crossing types x zones x
capacity-types with the ICE mask (instancetype.go:252-293).

Accelerator-first addition: the provider also exports the problem *tensors* —
allocatable capacity matrix ``C[T, R]``, offering price/availability arrays
``price[T, Z, C]`` / ``avail[T, Z, C]`` (C = NUM_CAPACITY_TYPES) — which are what actually ship to
the device (SURVEY.md section 7.1-7.2).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ..models import labels as lbl
from ..models.resources import (
    CPU,
    MEMORY,
    NUM_RESOURCES,
    PODS,
    ResourceVector,
)
from ..utils.cache import CacheTTL, TTLCache
from ..utils.clock import Clock, RealClock
from ..utils.unavailable import UnavailableOfferings
from .instancetypes import DEFAULT_ZONES, InstanceType, generate_catalog
from .pricing import PricingProvider


@dataclass
class OverheadOptions:
    """Knobs for capacity -> allocatable (parity: options.go VMMemoryOverheadPercent
    + kubelet reserved/eviction defaults in types.go:354-416)."""

    vm_memory_overhead_percent: float = 0.075
    system_reserved_cpu_milli: float = 100.0
    system_reserved_memory_mib: float = 100.0
    eviction_threshold_memory_mib: float = 100.0
    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    reserved_enis: int = 0


def kube_reserved_cpu_milli(vcpus: int) -> float:
    """The kubelet CPU-reservation curve (parity: types.go:364-383):
    6% of the first core, 1% of the second, 0.5% of cores 3-4, 0.25% beyond."""
    cores = float(vcpus)
    reserved = 0.0
    tiers = [(1.0, 0.06), (1.0, 0.01), (2.0, 0.005), (math.inf, 0.0025)]
    for width, frac in tiers:
        take = min(cores, width)
        if take <= 0:
            break
        reserved += take * frac * 1000.0
        cores -= take
    return reserved


def kube_reserved_memory_mib(pods: float) -> float:
    """parity: types.go:389-401 — 255 MiB + 11 MiB per pod slot."""
    return 255.0 + 11.0 * pods


_provider_uid = __import__("itertools").count()


class CatalogProvider:
    def __init__(
        self,
        types: Optional[Sequence[InstanceType]] = None,
        pricing: Optional[PricingProvider] = None,
        unavailable: Optional[UnavailableOfferings] = None,
        overhead: Optional[OverheadOptions] = None,
        zones: Sequence[str] = DEFAULT_ZONES,
        clock: Optional[Clock] = None,
    ):
        self._clock = clock or RealClock()
        self._lock = threading.RLock()
        self.uid = next(_provider_uid)  # distinguishes caches across providers
        self._types: list[InstanceType] = list(types) if types is not None else generate_catalog(zones)
        self._index = {t.name: i for i, t in enumerate(self._types)}
        self.pricing = pricing or PricingProvider()
        self.unavailable = unavailable or UnavailableOfferings(clock=self._clock)
        self.overhead = overhead or OverheadOptions()
        from .reservations import ReservationStore

        self.reservations = ReservationStore()
        self.zones = tuple(zones)
        self._catalog_seq = 0
        self._tensor_cache = TTLCache(default_ttl=CacheTTL.INSTANCE_TYPES, clock=self._clock)

    # -- basic views -------------------------------------------------------
    def list(self) -> list[InstanceType]:
        with self._lock:
            return list(self._types)

    def get(self, name: str) -> Optional[InstanceType]:
        with self._lock:
            i = self._index.get(name)
            return self._types[i] if i is not None else None

    def names(self) -> list[str]:
        with self._lock:
            return [t.name for t in self._types]

    def __len__(self) -> int:
        return len(self._types)

    def refresh(self, types: Sequence[InstanceType]) -> None:
        """Swap in a new catalog snapshot (12h refresh controller path;
        parity: instancetype.go:181-250 UpdateInstanceTypes)."""
        with self._lock:
            self._types = list(types)
            self._index = {t.name: i for i, t in enumerate(self._types)}
            self._catalog_seq += 1
            self._tensor_cache.flush()

    # -- allocatable math --------------------------------------------------
    def allocatable(self, it: InstanceType, max_pods: Optional[int] = None,
                    ephemeral_gib: int = 20,
                    instance_store_policy: Optional[str] = None) -> ResourceVector:
        """capacity - VM overhead - kube/system reserved - eviction
        (parity: types.go:182-215 Allocatable). ``max_pods`` is the per-pool
        kubelet override, which wins over the global overhead option
        (parity: the kubelet maxPods input to types.go pods());
        ``ephemeral_gib``/``instance_store_policy`` come from the nodeclass
        (root block device size; RAID0 instance-store policy)."""
        o = self.overhead
        if max_pods is not None:
            pods = float(max_pods)
        elif o.max_pods is not None:
            pods = float(o.max_pods)
        else:
            pods = float(max(1, (it.max_enis - o.reserved_enis) * (it.ips_per_eni - 1) + 2))
            if o.pods_per_core:
                pods = min(pods, float(o.pods_per_core * it.vcpus))
        cap = it.capacity(max_pods=int(pods), ephemeral_gib=ephemeral_gib,
                          instance_store_policy=instance_store_policy)
        v = cap.v.copy()
        v[MEMORY] = v[MEMORY] * (1.0 - o.vm_memory_overhead_percent)
        v[MEMORY] -= kube_reserved_memory_mib(pods) + o.system_reserved_memory_mib + o.eviction_threshold_memory_mib
        v[CPU] -= kube_reserved_cpu_milli(it.vcpus) + o.system_reserved_cpu_milli
        v = np.maximum(v, 0.0)
        return ResourceVector(v)

    # -- seqnum composite key (parity: instancetype.go:121-139) ------------
    def cache_key(self) -> tuple:
        return (
            self._catalog_seq,
            self.pricing.seq_num(),
            self.unavailable.seq_num(),
            self.reservations.seq_num(),
            self.overhead.vm_memory_overhead_percent,
            self.overhead.max_pods,
        ) + self._market_fragment()

    def _market_fragment(self) -> tuple:
        """The clock-driven part of the cache key. Everything slot- or
        price-shaped already rides the seqnums above; only two things move
        with the clock alone — the MarketModel tick (reclaim premiums are a
        function of it) and bounded-window open/close transitions. Empty
        () when the market is off or there is no market state, so the key
        is the exact static-market tuple and cached tensors keep hitting."""
        from ..market import (
            market_enabled,
            windows_cache_key,
            windows_from_reservations,
        )

        if not market_enabled():
            return ()
        frag: list = []
        now = self._clock.now()
        model = self.pricing.market
        if model is not None:
            frag.append(("tick", model.tick_index(now)))
        wkey = windows_cache_key(
            windows_from_reservations(self.reservations.list()), now
        )
        if wkey:
            frag.append(("win", wkey))
        return tuple(frag)

    # -- tensor exports (the device-facing view) ------------------------------
    def tensors(self) -> "CatalogTensors":
        # NOTE: never hold the cache lock while building (the build takes the
        # provider lock; refresh() takes provider-then-cache — get_or_load
        # here would invert the order and deadlock). A racy double-build is
        # benign: both snapshots are identical for the same key.
        key = ("tensors", self.cache_key())
        hit = self._tensor_cache.get(key)
        if hit is not None:
            return hit
        built = self._build_tensors()
        self._tensor_cache.set(key, built)
        return built

    def _build_tensors(self) -> "CatalogTensors":
        from ..market import (
            apply_window_columns,
            market_enabled,
            windows_from_reservations,
        )

        with self._lock:
            T, Z = len(self._types), len(self.zones)
            zone_idx = {z: i for i, z in enumerate(self.zones)}
            C = np.zeros((T, NUM_RESOURCES), dtype=np.float32)
            price = np.full((T, Z, lbl.NUM_CAPACITY_TYPES), np.inf, dtype=np.float32)
            avail = np.zeros((T, Z, lbl.NUM_CAPACITY_TYPES), dtype=bool)
            names = tuple(t.name for t in self._types)
            use_market = market_enabled()
            model = self.pricing.market if use_market else None
            now = self._clock.now()
            for ti, it in enumerate(self._types):
                C[ti] = self.allocatable(it).v
                for o in it.offerings:
                    zi = zone_idx.get(o.zone)
                    if zi is None:
                        continue
                    if o.capacity_type not in lbl.CAPACITY_TYPES:
                        continue  # unknown market (future data): degrade, don't crash
                    ci = lbl.CAPACITY_TYPES.index(o.capacity_type)
                    live = o.available and not self.unavailable.is_unavailable(
                        it.name, o.zone, o.capacity_type
                    )
                    # live price source wins over the snapshot on the offering
                    p = (
                        self.pricing.on_demand_price(it)
                        if ci == 0
                        else self.pricing.spot_price(it, o.zone)
                    )
                    if model is not None and ci == lbl.SPOT_INDEX:
                        # reclaim-risk premium, folded into the price VALUE
                        # so every consumer (FFD sort, consolidation screen,
                        # replacement paths) arbitrages the same effective
                        # spot, and no tensor changes shape
                        p = p * (1.0 + model.reclaim_lambda
                                 * model.reclaim_probability(it.name, o.zone, now))
                    price[ti, zi, ci] = p
                    avail[ti, zi, ci] = live
            # Reserved offerings come from the resolved reservation store,
            # not the type's own offering list: committed price (0 for a
            # plain ODCR — already paid) while slots remain, ICE mask on top.
            if use_market:
                # window encoding: honors [start_s, end_s) bounds and slot
                # exhaustion; a plain open-ended reservation encodes exactly
                # like the static branch below
                apply_window_columns(
                    price, avail, names, self.zones,
                    windows_from_reservations(self.reservations.list()),
                    now, unavailable=self.unavailable,
                )
            else:
                # KARPENTER_TPU_MARKET=0: the static-market encoding, kept
                # verbatim for byte-identity
                reserved_remaining: dict[tuple[str, str], int] = {}
                for r in self.reservations.list():
                    k = (r.instance_type, r.zone)
                    reserved_remaining[k] = reserved_remaining.get(k, 0) + r.remaining
                for ti, it in enumerate(self._types):
                    for zi, zone in enumerate(self.zones):
                        if reserved_remaining.get((it.name, zone), 0) > 0:
                            ci = lbl.RESERVED_INDEX
                            price[ti, zi, ci] = 0.0
                            avail[ti, zi, ci] = not self.unavailable.is_unavailable(
                                it.name, zone, lbl.CAPACITY_TYPE_RESERVED
                            )
            return CatalogTensors(
                names=names,
                zones=self.zones,
                capacity=C,
                price=price,
                available=avail,
                key=self.cache_key(),
            )


@dataclass(frozen=True)
class CatalogTensors:
    """The device-facing catalog snapshot. ``capacity[T, R]`` is allocatable
    (overhead already subtracted); ``price``/``available`` are
    [T, Z, NUM_CAPACITY_TYPES] with capacity-type axis (0=on-demand, 1=spot,
    2=reserved) and ICE already masked."""

    names: tuple[str, ...]
    zones: tuple[str, ...]
    capacity: np.ndarray
    price: np.ndarray
    available: np.ndarray
    key: tuple = field(default=())

    def min_price(self) -> np.ndarray:
        """[T] cheapest available offering price per type (inf if none)."""
        masked = np.where(self.available, self.price, np.inf)
        return masked.min(axis=(1, 2))

    def any_available(self) -> np.ndarray:
        return self.available.any(axis=(1, 2))
