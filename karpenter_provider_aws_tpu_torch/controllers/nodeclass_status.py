"""NodeClass status controller: resolve spec selectors -> status + readiness.

Parity: ``pkg/controllers/nodeclass/status/controller.go:70-106`` —
sequential sub-reconcilers for subnets, security groups, images, instance
profile, then the readiness condition; adds the termination finalizer.
"""

from __future__ import annotations

from ..cloudprovider.cloudprovider import CloudProvider
from ..state.cluster import Cluster

FINALIZER = "karpenter.tpu/termination"


class NodeClassStatusController:
    name = "nodeclass-status"
    interval_s = 10.0

    def __init__(self, cluster: Cluster, cloudprovider: CloudProvider):
        self.cluster = cluster
        self.cloudprovider = cloudprovider

    def reconcile(self) -> None:
        from ..operator import sharding

        # nodeclass objects are pool/zone-agnostic (global scope): one
        # writer keeps the shared store's status fresh for every replica
        if not sharding.owns_global():
            return
        live = [nc for nc in self.cluster.nodeclasses.values() if not nc.deleted]
        # One cloud describe serves every nodeclass this pass (lazy: skipped
        # entirely when no nodeclass selects reservations).
        for nc in live:
            nc.finalizers.add(FINALIZER)
            nc.status.subnets = self.cloudprovider.subnets.list(nc)
            nc.status.security_groups = self.cloudprovider.security_groups.list(nc)
            nc.status.images = self.cloudprovider.images.list(nc)
            nc.status.capacity_reservations = self.cloudprovider.capacity_reservations.list(nc)
            if nc.role or nc.instance_profile:
                nc.status.instance_profile = self.cloudprovider.instance_profiles.create(nc)

            missing = [
                what
                for what, got in (
                    ("subnets", nc.status.subnets),
                    ("security groups", nc.status.security_groups),
                    ("images", nc.status.images),
                )
                if not got
            ]
            if missing:
                nc.status.set_condition(
                    "Ready", False, reason="ResolutionFailed",
                    message=f"unresolved: {', '.join(missing)}",
                )
            else:
                nc.status.set_condition("Ready", True)
        self._publish_reservations()
        # pricing-feed staleness rides this reconcile's cadence: the gauge
        # (karpenter_pricing_age_seconds{source}) plus a PricingStale
        # Warning past the TTL — a wedged poller pages as an event, not as
        # silently frozen market arbitrage (designs/market-engine.md)
        self.cloudprovider.catalog.pricing.observe_staleness()

    def _publish_reservations(self) -> None:
        """Publish the cross-nodeclass union into the catalog store (the
        tensors' 'reserved' offerings), once per reconcile. Deleted
        nodeclasses are excluded — their stale status must not keep
        advertising capacity nothing live selects."""
        from ..catalog.reservations import Reservation

        union: dict[str, Reservation] = {}
        for other in self.cluster.nodeclasses.values():
            if other.deleted:
                continue
            for r in getattr(other.status, "capacity_reservations", []):
                union[r.id] = Reservation(
                    id=r.id, instance_type=r.instance_type, zone=r.zone,
                    count=r.count, used=r.used,
                    # market-window fields: a capacity block's purchase
                    # window and committed $/hr ride the status through to
                    # the store so the tensor build can encode them
                    start_s=getattr(r, "start_s", None),
                    end_s=getattr(r, "end_s", None),
                    committed_price=float(getattr(r, "committed_price", 0.0) or 0.0),
                )
        store = self.cloudprovider.catalog.reservations

        def fingerprint(rs):
            return {
                r.id: (r.instance_type, r.zone, r.count, r.used,
                       getattr(r, "start_s", None), getattr(r, "end_s", None),
                       getattr(r, "committed_price", 0.0))
                for r in rs
            }

        if fingerprint(store.list()) != fingerprint(union.values()):
            store.update(union.values())
