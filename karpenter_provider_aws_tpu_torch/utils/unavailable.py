"""UnavailableOfferings — the ICE feedback cache.

Reference parity: ``pkg/cache/unavailableofferings.go:31-84`` — keyed
``capacityType:instanceType:zone`` with a 3m TTL and a monotonically
increasing seqnum bumped on every insert/expiry-relevant change, so
downstream consumers (the device-resident offering tensors) can cheap-check
freshness via the seqnum instead of rescanning (SURVEY.md section 7,
"freshness semantics").
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional

from .cache import CacheTTL, TTLCache
from .clock import Clock


class UnavailableOfferings:
    def __init__(self, clock: Optional[Clock] = None, ttl: float = CacheTTL.UNAVAILABLE_OFFERINGS):
        self._cache = TTLCache(default_ttl=ttl, clock=clock)
        self._seq = 0
        self._lock = threading.Lock()

    @staticmethod
    def _key(capacity_type: str, instance_type: str, zone: str) -> str:
        return f"{capacity_type}:{instance_type}:{zone}"

    def _publish_size(self, count: Optional[int] = None) -> None:
        """Keep the ``karpenter_ice_cache_size`` gauge on the live key
        count — refreshed at every mutation AND every read that computes
        the live set, because TTL expiry inside TTLCache is silent and a
        mask that lapsed must stop being reported. Readers that already
        scanned the key set pass its length so the hot freshness check
        (``seq_num`` per encode) doesn't pay a second O(n) scan. Chaos
        scenarios assert this gauge's growth under ICE storms and decay
        after."""
        try:
            from ..metrics import ICE_CACHE_SIZE

            if count is None:
                count = len(self._cache.keys())
            ICE_CACHE_SIZE.set(float(count))
        except Exception:
            pass

    def mark_unavailable(self, instance_type: str, zone: str, capacity_type: str, reason: str = "ICE") -> None:
        with self._lock:
            self._cache.set(self._key(capacity_type, instance_type, zone), reason)
            self._seq += 1
            self._publish_size()

    def mark_unavailable_for_fleet_error(self, err, capacity_type: str) -> None:
        """Classify a launch error into per-(type, zone) unavailability
        (parity: instance.go:362-368 updateUnavailableOfferingsCache)."""
        self.mark_unavailable(err.instance_type, err.zone, capacity_type or err.capacity_type)

    def is_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> bool:
        return self._cache.get(self._key(capacity_type, instance_type, zone)) is not None

    def delete(self, instance_type: str, zone: str, capacity_type: str) -> None:
        with self._lock:
            self._cache.delete(self._key(capacity_type, instance_type, zone))
            self._seq += 1
            self._publish_size()

    def flush(self) -> None:
        with self._lock:
            self._cache.flush()
            self._seq += 1
            self._publish_size()

    def seq_num(self) -> tuple:
        """Composite-cache-key ingredient (parity: instancetype.go:121-139).

        Includes the currently-live key set, not just the insert counter —
        TTL expiry inside TTLCache is silent (no eviction hook), and a
        downstream tensor snapshot must stop masking an offering the moment
        its ICE entry lapses.
        """
        with self._lock:
            keys = tuple(sorted(self._cache.keys()))
            self._publish_size(len(keys))
            return (self._seq, keys)

    def entries(self) -> list[tuple[str, str, str]]:
        """[(capacity_type, instance_type, zone)] currently masked.

        Under ``self._lock`` like every mutator: the key snapshot must
        not interleave with a concurrent mark/flush (the lockless read
        here was the one racy accessor in the class)."""
        with self._lock:
            keys = self._cache.keys()
            self._publish_size(len(keys))
        out = []
        for k in keys:
            ct, it, z = k.split(":", 2)
            out.append((ct, it, z))
        return out
