"""PodDisruptionBudget: voluntary-eviction limits the drain path honors.

Parity: the core termination controller drains through the eviction API,
which enforces PDBs — a karpenter disruption never takes more replicas of
a covered workload down than the budget allows; blocked evictions retry
until replacements are Ready elsewhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Union


def _resolve(value: Union[int, str], total: int, round_up: bool) -> int:
    """K8s intstr semantics: minAvailable percentages round UP,
    maxUnavailable percentages round DOWN (the conservative direction for
    each field — the caller states which). Integer math, like
    GetScaledValueFromIntOrPercent — float rounding diverges at exact
    boundaries (ceil(50*0.14) = 8, but k8s' ceil(14*50/100) = 7)."""
    if isinstance(value, str) and value.endswith("%"):
        pct = int(float(value[:-1]))
        if round_up:
            return (pct * total + 99) // 100
        return pct * total // 100
    return int(value)


@dataclass
class PodDisruptionBudget:
    name: str
    selector: Mapping[str, str] = field(default_factory=dict)
    # exactly one of the two must be set (enforced in __post_init__)
    min_available: Optional[Union[int, str]] = None
    max_unavailable: Optional[Union[int, str]] = None

    def __post_init__(self):
        if (self.min_available is None) == (self.max_unavailable is None):
            raise ValueError(
                "PodDisruptionBudget needs exactly one of minAvailable / "
                "maxUnavailable"
            )

    def matches(self, pod) -> bool:
        return all(pod.labels.get(k) == v for k, v in self.selector.items())

    def disruptions_allowed(self, pods) -> int:
        """How many of ``pods`` (all pods matching the selector,
        cluster-wide) may be evicted right now. ``healthy`` = bound and
        Running; everything else already counts as disrupted."""
        matching = [p for p in pods if self.matches(p)]
        total = len(matching)
        healthy = sum(1 for p in matching if p.node_name and p.phase == "Running")
        if self.min_available is not None:
            need = _resolve(self.min_available, total, round_up=True)
            allowed = healthy - need
        else:
            cap = _resolve(self.max_unavailable, total, round_up=False)
            allowed = cap - (total - healthy)
        return max(allowed, 0)
