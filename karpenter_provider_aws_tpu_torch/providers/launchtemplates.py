"""Launch-template provider: ensure-or-create deduped launch templates.

Parity: ``pkg/providers/launchtemplate/launchtemplate.go`` — template name
is a hash of the resolved parameters (:149-151), a TTL cache dedupes
ensure calls with hydration on startup (:100-109), templates carry block
devices, IMDS metadata options and generated userdata (:235-312), and the
nodeclass termination path deletes every managed template by tag
(termination/controller.go:87-105).
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import asdict, dataclass, field
from typing import Optional, Sequence

from ..models.nodeclass import NodeClass
from ..utils.cache import CacheTTL, TTLCache
from ..utils.clock import Clock
from .bootstrap import ClusterInfo, KubeletConfiguration

log = logging.getLogger("karpenter.tpu.launchtemplates")

MANAGED_BY_TAG = "karpenter.tpu/managed-by"        # value: cluster name
NODECLASS_LT_TAG = "karpenter.tpu/nodeclass"


@dataclass(frozen=True)
class ResolvedTemplate:
    """The fully-resolved launch parameters for one image group (the
    amifamily.Resolver output analogue, resolver.go:123-162)."""

    image_id: str
    user_data: str
    instance_profile: str
    security_group_ids: tuple[str, ...] = ()
    block_devices: tuple = ()
    metadata_options: Optional[object] = None
    tags: tuple[tuple[str, str], ...] = ()
    # None = leave the subnet's default; True/False = pin it — either the
    # user's spec override (ec2nodeclass.go:45-47) or inferred False when
    # every resolved subnet is known private (subnet.go:119-130)
    associate_public_ip: Optional[bool] = None
    # CloudWatch detailed monitoring (parity: launchtemplate.go:255-257
    # Monitoring.Enabled from nodeclass.spec.detailedMonitoring)
    detailed_monitoring: bool = False

    def content_hash(self) -> str:
        blob = json.dumps(
            {
                "image": self.image_id,
                "user_data": self.user_data,
                "profile": self.instance_profile,
                "sgs": list(self.security_group_ids),
                "bdm": [asdict(b) for b in self.block_devices],
                "md": asdict(self.metadata_options) if self.metadata_options else None,
                "tags": list(self.tags),
                "public_ip": self.associate_public_ip,
                "monitoring": self.detailed_monitoring,
            },
            sort_keys=True,
        ).encode()
        return hashlib.sha256(blob).hexdigest()[:16]


def resolve_service_cidr(cloud, ip_family: str) -> str:
    """Cluster service CIDR from the backend's cluster description (parity:
    launchtemplate.go:429-450 ResolveClusterCIDR — ipv4 preferred, ipv6
    fallback, empty when the backend cannot say)."""
    describe = getattr(cloud, "describe_cluster", None)
    if describe is None:
        return ""
    try:
        info = describe() or {}
    except Exception as e:
        log.warning("cluster CIDR resolution failed (will retry): %s", e)
        return ""
    if ip_family == "ipv6":
        return info.get("service_ipv6_cidr") or info.get("service_ipv4_cidr") or ""
    return info.get("service_ipv4_cidr") or info.get("service_ipv6_cidr") or ""


class LaunchTemplateProvider:
    def __init__(self, cloud, cluster_info: ClusterInfo, clock: Optional[Clock] = None):
        from ..utils.clock import RealClock

        self.cloud = cloud
        self.cluster_info = cluster_info
        self._cache = TTLCache(default_ttl=CacheTTL.LAUNCH_TEMPLATE, clock=clock)
        self._hydrated = False
        self._clock = clock or RealClock()
        self._cidr_next_try = 0.0

    def _maybe_resolve_cidr(self) -> None:
        """Retry service-CIDR discovery until it succeeds (parity: the
        reference re-calls ResolveClusterCIDR from the launch path and
        no-ops once resolved, launchtemplate.go:429-432). Rate-limited so a
        down endpoint cannot add a describe call to every launch."""
        if self.cluster_info.service_cidr:
            return
        now = self._clock.now()
        if now < self._cidr_next_try:
            return
        self._cidr_next_try = now + 60.0
        cidr = resolve_service_cidr(self.cloud, self.cluster_info.ip_family)
        if cidr:
            # ClusterInfo is frozen; late CIDR discovery is the one sanctioned
            # mutation (the reference stores it in an atomic.Pointer for the
            # same reason, launchtemplate.go:81)
            object.__setattr__(self.cluster_info, "service_cidr", cidr)
            log.info("discovered cluster service CIDR %s", cidr)

    # -- the launch path ---------------------------------------------------
    def ensure_all(
        self,
        nodeclass: NodeClass,
        image_groups: Sequence[tuple],     # [(Image, [InstanceType, ...])]
        labels: Optional[dict] = None,
        taints: Sequence = (),
        kubelet: Optional[KubeletConfiguration] = None,
        associate_public_ip: Optional[bool] = None,
    ) -> dict[str, str]:
        """image_id -> launch template name, creating what is missing.

        One template per image group (parity: Resolver.Resolve grouping by
        (amiID, maxPods, efa); our grouping key is the image, since maxPods
        comes from the kubelet config and efa is N/A)."""
        self._hydrate_once()
        self._maybe_resolve_cidr()
        out: dict[str, str] = {}
        from .imagefamily import get_family

        family = get_family(nodeclass.image_family)
        for image, _types in image_groups:
            # The NODECLASS family picks the bootstrapper — not the image's
            # (parity: resolver.go:80-112, AMIFamily comes from the spec).
            boot = family.bootstrapper(
                self.cluster_info,
                kubelet=kubelet,
                labels=labels,
                taints=taints,
                custom=nodeclass.user_data,
                instance_store_policy=nodeclass.instance_store_policy,
            )
            resolved = ResolvedTemplate(
                image_id=image.id,
                user_data=boot.script(),
                instance_profile=nodeclass.status.instance_profile
                or nodeclass.instance_profile,
                security_group_ids=tuple(g.id for g in nodeclass.status.security_groups),
                block_devices=tuple(nodeclass.block_devices),
                metadata_options=nodeclass.metadata_options,
                tags=tuple(sorted(nodeclass.tags.items())),
                associate_public_ip=associate_public_ip,
                detailed_monitoring=nodeclass.detailed_monitoring,
            )
            out[image.id] = self._ensure_one(nodeclass, resolved)
        self._gc_stale(nodeclass, keep=set(out.values()))
        return out

    def _name(self, nodeclass: NodeClass, resolved: ResolvedTemplate) -> str:
        # The nodeclass name is part of the template name so two nodeclasses
        # with identical resolved parameters never share one template (either
        # one's termination teardown would destroy the other's).
        return f"karpenter.tpu/{self.cluster_info.name}/{nodeclass.name}/{resolved.content_hash()}"

    def _ensure_one(self, nodeclass: NodeClass, resolved: ResolvedTemplate) -> str:
        name = self._name(nodeclass, resolved)
        if self._cache.get(("lt", name)) is not None:
            return name
        existing = {t.name for t in self.cloud.describe_launch_templates()}
        if name not in existing:
            self.cloud.create_launch_template(
                name=name,
                image_id=resolved.image_id,
                user_data=resolved.user_data,
                instance_profile=resolved.instance_profile,
                security_group_ids=resolved.security_group_ids,
                block_devices=resolved.block_devices,
                metadata_options=resolved.metadata_options,
                associate_public_ip=resolved.associate_public_ip,
                detailed_monitoring=resolved.detailed_monitoring,
                tags={
                    # user tags first: the managed tags must win or hydration
                    # and termination teardown lose track of the template
                    **dict(resolved.tags),
                    MANAGED_BY_TAG: self.cluster_info.name,
                    NODECLASS_LT_TAG: nodeclass.name,
                },
            )
            log.info("created launch template %s", name)
        self._cache.set(("lt", name), True)
        return name

    def _gc_stale(self, nodeclass: NodeClass, keep: set[str]) -> None:
        """Delete superseded templates for this nodeclass (image/userdata/tag
        rotations mint a new hash name; the old one would otherwise live until
        nodeclass termination). A template still vouched for by the dedupe
        cache is kept — it may back an in-flight launch — so deletion happens
        one cache-TTL after the template stopped being resolved (parity: the
        reference deletes launch templates on cache eviction)."""
        for t in list(self.cloud.describe_launch_templates()):
            if (
                t.tags.get(MANAGED_BY_TAG) == self.cluster_info.name
                and t.tags.get(NODECLASS_LT_TAG) == nodeclass.name
                and t.name not in keep
                and self._cache.get(("lt", t.name)) is None
            ):
                self.cloud.delete_launch_template(t.name)
                log.info("garbage-collected stale launch template %s", t.name)

    # -- cache lifecycle ---------------------------------------------------
    def _hydrate_once(self) -> None:
        """Warm the dedupe cache from the cloud on first use (parity:
        hydration goroutine on leader election, launchtemplate.go:100-109)."""
        if self._hydrated:
            return
        self._hydrated = True
        for t in self.cloud.describe_launch_templates():
            if t.tags.get(MANAGED_BY_TAG) == self.cluster_info.name:
                self._cache.set(("lt", t.name), True)

    def invalidate(self, name: str) -> None:
        """Drop one template from the dedupe cache (parity: InvalidateCache
        after a launch failed with launch-template-not-found)."""
        self._cache.delete(("lt", name))

    def reset(self) -> None:
        self._cache.flush()
        self._hydrated = False

    # -- teardown ----------------------------------------------------------
    def delete_all(self, nodeclass: NodeClass) -> int:
        """Delete every managed template for a nodeclass (parity:
        nodeclass termination controller.go:87-105)."""
        n = 0
        for t in list(self.cloud.describe_launch_templates()):
            if (
                t.tags.get(MANAGED_BY_TAG) == self.cluster_info.name
                and t.tags.get(NODECLASS_LT_TAG) == nodeclass.name
            ):
                self.cloud.delete_launch_template(t.name)
                self._cache.delete(("lt", t.name))
                n += 1
        return n
