"""The parts of the NodeClass model that a NodePool and a NodeClaim need:
the kubelet configuration, the status condition and the process-wide spec
write sequence.

Reference parity: ``pkg/apis/v1beta1/ec2nodeclass.go`` (KubeletConfiguration).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .pod import _Seq

#: Bumped by every NodePool / NodeClass field reassignment, process-wide.
#: Direct in-place spec edits on live objects never reach the store's
#: change journal; consumers that cache per-spec derivations (the
#: disruption controller's dirty-set drift/expiry state) re-scan when this
#: sequence moves — the same over-invalidation contract as NODE_WRITE_SEQ.
SPEC_WRITE_SEQ = _Seq()


@dataclass
class Condition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    transition_seq: int = 0


@dataclass(frozen=True)
class KubeletConfiguration:
    """Kubelet knobs surfaced through node bootstrap
    (parity: v1beta1 KubeletConfiguration consumed at bootstrap.go:36-64)."""

    max_pods: Optional[int] = None
    pods_per_core: Optional[int] = None
    cluster_dns: tuple[str, ...] = ()
    system_reserved: tuple[tuple[str, str], ...] = ()
    kube_reserved: tuple[tuple[str, str], ...] = ()
    eviction_hard: tuple[tuple[str, str], ...] = ()
    eviction_soft: tuple[tuple[str, str], ...] = ()
    # signal -> duration string, e.g. ("memory.available", "1m0s")
    # (parity: bootstrap.go:64 --eviction-soft-grace-period)
    eviction_soft_grace_period: tuple[tuple[str, str], ...] = ()
    # parity: bootstrap.go:66-68 --eviction-max-pod-grace-period
    eviction_max_pod_grace_period: Optional[int] = None
    image_gc_high_threshold_percent: Optional[int] = None
    image_gc_low_threshold_percent: Optional[int] = None
    cpu_cfs_quota: Optional[bool] = None

    def extra_args(self) -> list[str]:
        """--flag=value kubelet arguments (parity: kubeletExtraArgs)."""
        args: list[str] = []
        if self.max_pods is not None:
            args.append(f"--max-pods={self.max_pods}")
        if self.pods_per_core is not None:
            args.append(f"--pods-per-core={self.pods_per_core}")
        if self.cluster_dns:
            args.append("--cluster-dns=" + ",".join(self.cluster_dns))
        for flag, pairs in (
            ("--system-reserved", self.system_reserved),
            ("--kube-reserved", self.kube_reserved),
            ("--eviction-hard", self.eviction_hard),
            ("--eviction-soft", self.eviction_soft),
            ("--eviction-soft-grace-period", self.eviction_soft_grace_period),
        ):
            if pairs:
                args.append(flag + "=" + ",".join(f"{k}={v}" for k, v in pairs))
        if self.eviction_max_pod_grace_period is not None:
            args.append(
                f"--eviction-max-pod-grace-period={self.eviction_max_pod_grace_period}"
            )
        if self.image_gc_high_threshold_percent is not None:
            args.append(f"--image-gc-high-threshold={self.image_gc_high_threshold_percent}")
        if self.image_gc_low_threshold_percent is not None:
            args.append(f"--image-gc-low-threshold={self.image_gc_low_threshold_percent}")
        if self.cpu_cfs_quota is not None:
            args.append(f"--cpu-cfs-quota={str(self.cpu_cfs_quota).lower()}")
        return args
