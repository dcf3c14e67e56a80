"""CloudProvider: the plugin between the control plane and the cloud.

Create() parity with ``pkg/cloudprovider/cloudprovider.go:81-141`` +
``pkg/providers/instance/instance.go:94-258``:
 - nodeclass readiness gate (cloudprovider.go:90-93)
 - ranked instance-type/offering options filtered by the ICE cache
 - image resolution grouping by arch/accelerator (resolver.go:123-162)
 - zonal subnet choice with in-flight IP accounting (subnet.go:133-234)
 - launch via the request-coalescing batcher (createfleet.go:52-110)
 - ICE errors classified into the unavailable-offerings cache
   (instance.go:362-368) and surfaced to the caller
 - instance -> NodeClaim status with labels + capacity
   (cloudprovider.go:294-337 instanceToNodeClaim)
"""

from __future__ import annotations

import enum
import threading
from typing import Optional

from ..catalog.provider import CatalogProvider
from .backend import LaunchRequest
from ..models import labels as lbl
from ..models.nodeclaim import NodeClaim
from ..models.nodeclass import NodeClass
from ..providers.bootstrap import ClusterInfo
from ..providers.images import ImageProvider, resolve_image_for
from ..providers.instanceprofiles import InstanceProfileProvider
from ..providers.launchtemplates import LaunchTemplateProvider
from ..providers.securitygroups import SecurityGroupProvider
from ..providers.subnets import SubnetProvider
from ..utils import errors
from ..utils.batcher import Batcher, BatcherOptions
from ..utils.clock import Clock, RealClock

MANAGED_TAG = "karpenter.tpu/managed"
NODEPOOL_TAG = "karpenter.tpu/nodepool"
# instance.go:52 instanceTypeFlexibilityThreshold: minimum type flexibility
# for a spot->on-demand fallback launch
OD_FALLBACK_FLEXIBILITY_MIN = 5
NODECLAIM_TAG = "karpenter.tpu/nodeclaim"


class DriftReason(str, enum.Enum):
    NONE = ""
    STATIC = "NodeClassHashDrifted"          # hash/controller.go parity
    IMAGE = "ImageDrifted"                   # drift.go AMI drift
    SUBNET = "SubnetDrifted"
    SECURITY_GROUP = "SecurityGroupDrifted"
    NODEPOOL = "NodePoolHashDrifted"         # core NodePool static drift


class CloudProvider:
    def __init__(
        self,
        cloud,
        catalog: CatalogProvider,
        cluster,
        clock: Optional[Clock] = None,
        batcher_options: Optional[BatcherOptions] = None,
        cluster_info: Optional[ClusterInfo] = None,
    ):
        self.cloud = cloud
        self.catalog = catalog
        self.cluster = cluster
        self.clock = clock or RealClock()
        self.cluster_info = cluster_info or ClusterInfo(name="cluster-1")
        self.subnets = SubnetProvider(cloud, clock=clock)
        self.security_groups = SecurityGroupProvider(cloud, clock=clock)
        self.images = ImageProvider(cloud, clock=clock)
        self.instance_profiles = InstanceProfileProvider(cloud, clock=clock)
        self.launch_templates = LaunchTemplateProvider(cloud, self.cluster_info, clock=clock)
        from ..providers.reservations import ReservationProvider

        self.capacity_reservations = ReservationProvider(cloud, clock=clock)
        from ..utils.cache import CacheTTL, TTLCache

        self._launchable_cache = TTLCache(default_ttl=CacheTTL.DEFAULT, clock=clock)
        opts = batcher_options or BatcherOptions()
        self._fleet_batcher: Batcher = Batcher(self.cloud.create_fleet, options=opts)
        # fences stamped by delete() ride beside the coalesced id batch:
        # the batcher's unit is a bare instance id, so the (id -> fence)
        # map travels out of band and is consumed per flushed batch
        self._pending_fences: dict[str, tuple] = {}
        self._fences_lock = threading.Lock()
        self._terminate_batcher: Batcher = Batcher(
            self._terminate_batch,
            options=BatcherOptions(idle_timeout_s=opts.idle_timeout_s * 3,
                                   max_timeout_s=opts.max_timeout_s, max_items=500),
        )

    def _terminate_batch(self, ids: list) -> list:
        """One coalesced TerminateInstances call, carrying each id's
        fencing token when the sharded control plane stamped one and the
        backend can enforce it (the fake / any fenced store); unfenced
        backends get the plain call."""
        with self._fences_lock:
            fences = {
                i: self._pending_fences.pop(i)
                for i in list(ids) if i in self._pending_fences
            }
        if fences:
            import inspect

            try:
                accepts = "fences" in inspect.signature(
                    self.cloud.terminate_instances
                ).parameters
            except (TypeError, ValueError):
                accepts = False
            if accepts:
                return self.cloud.terminate_instances(list(ids), fences=fences)
        return self.cloud.terminate_instances(list(ids))

    # -- Create ------------------------------------------------------------
    def create(self, claim: NodeClaim) -> NodeClaim:
        nodeclass = self.cluster.nodeclasses.get(claim.nodeclass_name)
        if nodeclass is None:
            raise errors.NotFoundError(f"nodeclass {claim.nodeclass_name} not found")
        if not nodeclass.status.is_ready():
            raise errors.CloudError(
                f"nodeclass {nodeclass.name} is not ready", code="NodeClassNotReady"
            )

        type_options = [
            self.catalog.get(n) for n in claim.instance_type_options if self.catalog.get(n)
        ]
        if not type_options:
            raise errors.CloudError("no instance type options", code="NoInstanceTypes")

        # Image grouping: resolve for the best-ranked type, then keep only
        # types the same image serves (arch/gpu grouping parity).
        images = self.images.list(nodeclass)
        # First ranked option with a resolvable image wins; options no image
        # maps to are dropped rather than failing the launch (parity:
        # resolver.go:123-162 — types with no AMI never reach CreateFleet).
        image = None
        for t in type_options:
            image = resolve_image_for(images, t)
            if image is not None:
                break
        if image is None:
            raise errors.CloudError(
                f"no image for any of {[t.name for t in type_options[:5]]}",
                code="NoCompatibleImage",
            )
        type_options = [
            t for t in type_options if resolve_image_for(images, t) is image
        ]

        # ICE-masked offering options (parity: offerings filtered against the
        # unavailable cache before launch).
        offerings = list(self._live_offerings(claim, [t.name for t in type_options]))
        if not offerings:
            raise errors.InsufficientCapacityError(
                message="all candidate offerings are ICE-cached"
            )

        # Mixed-captype launches drop spot types costlier than the cheapest
        # ATTAINABLE on-demand type (parity: instance.go:429-451
        # filterUnwantedSpot) — the fleet's lowest-price walk could otherwise
        # land on a bigger spot box when the best-ranked type's offering is
        # ICE-masked and a cheap on-demand one would have served. Dropping
        # types invalidates the offering ranking (it is priced against the
        # best-ranked type) and can retire pairs only the dropped types kept
        # alive, so the offerings are recomputed from the survivors.
        filtered = self._filter_unwanted_spot(type_options, offerings)
        if filtered is not type_options:
            type_options = filtered
            offerings = list(
                self._live_offerings(claim, [t.name for t in type_options])
            )
            if not offerings:
                raise errors.InsufficientCapacityError(
                    message="all candidate offerings are ICE-cached"
                )

        zones = sorted({z for z, _ in offerings})
        # ONE discovery snapshot drives both the zonal pick and the
        # public-IP inference: a cache expiry between two reads could pin
        # associatePublicIP=False onto a launch into a public subnet.
        subnet_snapshot = self.subnets.list(nodeclass)
        subnet_by_zone = self.subnets.zonal_subnets_for_launch(
            nodeclass, zones, subnets=subnet_snapshot
        )
        offerings = [o for o in offerings if o[0] in subnet_by_zone]
        if not offerings:
            raise errors.CloudError("no subnet available in candidate zones", code="NoSubnets")
        sgs = tuple(g.id for g in self.security_groups.list(nodeclass))

        # On-demand fallback flexibility gate (parity: instance.go:270-289
        # checkODFallback): spot was allowed but every offering that
        # actually remains launchable (post-ICE, post-subnet) is on-demand —
        # launching that fallback with almost no type flexibility risks
        # immediate ICE churn, so the reference refuses below 5 options and
        # so do we. Reserved (pre-paid) launches are exempt.
        # UNION of solve-time live offerings and the claim's capacity-type
        # requirements: if spot was ICE-cached at solve time the offerings
        # carry only on-demand, but the claim's requirements still allow
        # spot — the reference derives this gate from the requirements
        # (instance.go:272), so the fallback check must still fire.
        allowed_cts = {ct for _, ct in (claim.offering_options or ())} | set(
            claim.capacity_type_options or ()
        )
        live_cts = {ct for _, ct in offerings}
        if (
            lbl.CAPACITY_TYPE_SPOT in allowed_cts
            and lbl.CAPACITY_TYPE_SPOT not in live_cts
            and lbl.CAPACITY_TYPE_ON_DEMAND in live_cts
            and lbl.CAPACITY_TYPE_RESERVED not in live_cts
            and len(type_options) < OD_FALLBACK_FLEXIBILITY_MIN
        ):
            raise errors.CloudError(
                f"at least {OD_FALLBACK_FLEXIBILITY_MIN} instance types are "
                "recommended when flexible to spot but falling back to "
                f"on-demand; this launch has {len(type_options)}",
                code="InsufficientTypeFlexibility",
            )

        # Ensure the launch template for this image group (parity:
        # launchtemplate.EnsureAll at instance.go launch time).
        def ensure_template() -> str:
            pool = self.cluster.nodepools.get(claim.nodepool_name)
            return self.launch_templates.ensure_all(
                nodeclass,
                [(image, type_options)],
                labels=dict(claim.labels),
                taints=list(claim.taints) + list(claim.startup_taints),
                kubelet=getattr(pool, "kubelet", None) if pool else None,
                # the user's explicit setting wins (ec2nodeclass.go:45-47);
                # otherwise explicit False only when every resolved subnet
                # is known private (subnet.go:119-130); same snapshot as
                # the zonal pick above
                associate_public_ip=(
                    nodeclass.associate_public_ip
                    if nodeclass.associate_public_ip is not None
                    else self.subnets.associate_public_ip_value(
                        nodeclass, subnets=subnet_snapshot
                    )
                ),
            )[image.id]

        lt_name = ensure_template()
        # Fencing (sharded control plane): name the lease tenancy that
        # sanctioned this launch — the ambient sanction key (a disruption
        # replacement is sanctioned by the OLD node's partition lease),
        # else the GLOBAL lease (provisioning). () when unsharded.
        from ..operator import sharding

        fence = sharding.write_fence(self.cluster, claim) or ()
        request = LaunchRequest(
            fence=tuple(fence),
            instance_type_options=[t.name for t in type_options],
            offering_options=offerings,
            image_id=image.id,
            subnet_by_zone=subnet_by_zone,
            security_group_ids=sgs,
            context=nodeclass.context,
            tags={
                MANAGED_TAG: "true",
                NODEPOOL_TAG: claim.nodepool_name,
                NODECLAIM_TAG: claim.name,
                **nodeclass.tags,
            },
            launch_template_name=lt_name,
        )
        try:
            try:
                result = self._fleet_batcher.add(request)
            except errors.CloudError as e:
                if not errors.is_launch_template_not_found(e):
                    raise
                # Single retry after re-ensuring the template (parity:
                # instance.go:106-110 LT-not-found retry).
                self.launch_templates.invalidate(lt_name)
                request.launch_template_name = ensure_template()
                result = self._fleet_batcher.add(request)
        except Exception as e:
            # give back every pre-deducted IP, then classify ICE into the
            # unavailable cache so the next solve masks the offering
            self.subnets.release_unused(subnet_by_zone, used_zone="")
            if errors.is_unfulfillable_capacity(e) and getattr(e, "instance_type", ""):
                self.catalog.unavailable.mark_unavailable(
                    e.instance_type, e.zone, e.capacity_type
                )
                from ..metrics import ICE_EVENTS

                ICE_EVENTS.inc(capacity_type=e.capacity_type)
            raise
        self.subnets.release_unused(subnet_by_zone, result.zone)
        return self._instance_to_claim(claim, result, nodeclass)

    def _filter_unwanted_spot(self, type_options, offerings):
        """During a MIXED capacity-type launch, drop candidate types whose
        cheapest live offering is costlier than the cheapest on-demand
        price among the candidates (parity: instance.go:429-451
        filterUnwantedSpot). Spot-only or on-demand-only launches pass
        through untouched, and the cheapest-on-demand type itself always
        survives, so the result is never empty."""
        spot_zones = [z for z, ct in offerings if ct == lbl.CAPACITY_TYPE_SPOT]
        od_zones = [z for z, ct in offerings if ct == lbl.CAPACITY_TYPE_ON_DEMAND]
        has_reserved = any(ct == lbl.CAPACITY_TYPE_RESERVED for _, ct in offerings)
        # Reserved (pre-paid, marginal price 0) launches are exempt: the
        # price comparison below only understands the spot/on-demand market,
        # and dropping the reservation's own type would forfeit the slot.
        if not spot_zones or not od_zones or has_reserved:
            return type_options
        unavailable = self.catalog.unavailable.is_unavailable

        def live_od(t):
            # the comparison floor must be ATTAINABLE: an ICE-cached
            # on-demand price is not a price anyone can launch at, and the
            # price compared is the cheapest per-(type, zone) OFFERING
            # price over live zones (reference computes over
            # Offerings.Available(), per-offering prices) — not one
            # zone-independent number per type.
            return min(
                (
                    self.catalog.pricing.on_demand_price_zonal(t, z)
                    for z in od_zones
                    if not unavailable(t.name, z, lbl.CAPACITY_TYPE_ON_DEMAND)
                ),
                default=float("inf"),
            )

        cheapest_od = min((live_od(t) for t in type_options), default=float("inf"))
        if cheapest_od == float("inf"):
            return type_options  # no attainable on-demand: nothing to compare

        def cheapest_live(t):
            best = live_od(t)
            for z in spot_zones:
                if not unavailable(t.name, z, lbl.CAPACITY_TYPE_SPOT):
                    best = min(best, self.catalog.pricing.spot_price(t, z))
            return best

        kept = [t for t in type_options if cheapest_live(t) <= cheapest_od + 1e-9]
        if len(kept) == len(type_options):
            return type_options  # identity signals "nothing dropped" to the caller
        return kept or type_options

    def launchable_type_names(self, nodepool) -> "Optional[set[str]]":
        """Types a nodepool's nodeclass can actually boot: at least one
        resolved image is compatible (arch + accelerator). None = no
        constraint known (nodeclass missing/unready — the readiness gate
        rejects the launch anyway). Fed into the solve so the scheduler
        never commits capacity it cannot image (parity: amifamily
        MapToInstanceTypes, ami.go:79-90)."""
        nodeclass = self.cluster.nodeclasses.get(nodepool.nodeclass_name)
        if nodeclass is None or not nodeclass.status.is_ready():
            return None
        images = self.images.list(nodeclass)
        key = ("launchable", nodeclass.name, tuple(i.id for i in images), self.catalog.cache_key())
        hit = self._launchable_cache.get(key)
        if hit is not None:
            return hit
        allowed = {
            t.name for t in self.catalog.list() if resolve_image_for(images, t) is not None
        }
        self._launchable_cache.set(key, allowed)
        return allowed

    def _live_offerings(self, claim: NodeClaim, type_names):
        """(zone, captype) pairs from the claim not ICE-masked for at least
        one candidate type, ranked cheapest-first by the best-ranked type's
        actual offering price — the fleet takes the first launchable pair, so
        this ordering IS the lowest-price allocation strategy. A launch that
        lands anywhere but the cheapest live offering would immediately look
        consolidatable again (replace churn)."""
        pairs = claim.capacity_type_options or [lbl.CAPACITY_TYPE_ON_DEMAND]
        zones = claim.zone_options or list(self.catalog.zones)
        joint = getattr(claim, "offering_options", None) or [
            (z, ct) for z in zones for ct in pairs
        ]
        it = self.catalog.get(type_names[0]) if type_names else None
        # clock-gated reservation windows: an expired/not-yet-open capacity
        # block must not rank (or pass the filter) as free capacity
        now = self.clock.now()

        def price(offer):
            zone, captype = offer
            if it is None:
                return 0.0
            if captype == lbl.CAPACITY_TYPE_RESERVED:
                # pre-paid: marginal cost 0 while count remains, else
                # unusable (skipped below too)
                has = self.catalog.reservations.remaining(it.name, zone, now=now) > 0
                return 0.0 if has else float("inf")
            if captype == lbl.CAPACITY_TYPE_SPOT:
                return self.catalog.pricing.spot_price(it, zone)
            return self.catalog.pricing.on_demand_price(it)

        for zone, captype in sorted(joint, key=price):
            if captype == lbl.CAPACITY_TYPE_RESERVED and not any(
                self.catalog.reservations.remaining(t, zone, now=now) > 0
                for t in type_names
            ):
                continue
            if any(
                not self.catalog.unavailable.is_unavailable(t, zone, captype)
                for t in type_names
            ):
                yield (zone, captype)

    def _instance_to_claim(self, claim: NodeClaim, inst, nodeclass: NodeClass) -> NodeClaim:
        it = self.catalog.get(inst.instance_type)
        claim.status.provider_id = inst.provider_id
        claim.status.image_id = inst.image_id
        pool = self.cluster.nodepools.get(claim.nodepool_name)
        kubelet = getattr(pool, "kubelet", None) if pool else None
        max_pods = kubelet.max_pods if kubelet is not None else None
        # ephemeral-storage follows the nodeclass: root EBS volume size, or
        # the total instance store under the RAID0 policy (types.go:218-244)
        cap_kw = nodeclass.capacity_kwargs()
        claim.status.capacity = it.capacity(max_pods=max_pods, **cap_kw)
        claim.status.allocatable = self.catalog.allocatable(
            it, max_pods=max_pods, **cap_kw
        )
        claim.labels.update(it.labels())
        claim.labels[lbl.TOPOLOGY_ZONE] = inst.zone
        claim.labels[lbl.CAPACITY_TYPE] = inst.capacity_type
        zone_types = self._zone_types()
        if zone_types:
            claim.labels[lbl.ZONE_TYPE] = zone_types.get(inst.zone, "availability-zone")
        claim.status.internal_ip = getattr(inst, "private_ip", "")
        reservation_id = getattr(inst, "capacity_reservation_id", "")
        if reservation_id:
            claim.labels[lbl.CAPACITY_RESERVATION_ID] = reservation_id
            # keep the catalog's in-flight view fresh between status
            # refreshes — target the reservation the cloud actually drew
            self.catalog.reservations.consume_id(reservation_id)
            # a cached discovery snapshot now under-counts `used`: drop it so
            # the next status reconcile re-describes instead of rolling the
            # in-flight accounting back
            self.capacity_reservations.reset()
        claim.labels[lbl.NODEPOOL] = claim.nodepool_name
        claim.annotations.update(nodeclass.hash_annotations())
        claim.created_at = self.clock.now()
        claim.finalizers.add("karpenter.tpu/termination")
        claim.status.set_condition("Launched", True)
        return claim

    # -- Delete / Get / List ----------------------------------------------
    def delete(self, claim: NodeClaim) -> None:
        instance_id = parse_provider_id(claim.status.provider_id)
        if instance_id is None:
            raise errors.NotFoundError(f"claim {claim.name} has no provider id")
        from ..operator import sharding

        fence = sharding.write_fence(self.cluster, claim)
        if fence is not None:
            with self._fences_lock:
                self._pending_fences[instance_id] = tuple(fence)
        self._terminate_batcher.add(instance_id)
        # Return pre-paid capacity to the in-flight view — but only once the
        # cloud confirms the instance is actually terminated. Releasing on
        # the API call alone would advertise the slot while the instance is
        # still shutting down; an immediate relaunch would then ICE and
        # blacklist the reserved offering for the whole ICE TTL. If the
        # instance is still draining, the status reconcile re-syncs counts
        # from the cloud once it lands. The label is popped so a retried
        # delete can't double-release.
        rid = claim.labels.get(lbl.CAPACITY_RESERVATION_ID)
        if rid:
            try:
                terminated = self.cloud.get_instance(instance_id).state == "terminated"
            except errors.NotFoundError:
                terminated = True  # instance already gone
            except Exception:
                # A transient describe error (throttle, injected fault) says
                # nothing about instance state — keep the label so a retried
                # delete re-confirms, and let the status reconcile re-sync
                # counts. Releasing here would over-advertise the reserved
                # offering and invite an ICE blacklist.
                terminated = False
            if terminated:
                claim.labels.pop(lbl.CAPACITY_RESERVATION_ID, None)
                self.catalog.reservations.release(rid)
                self.capacity_reservations.reset()  # stale snapshot over-counts now

    def _zone_types(self) -> dict:
        """zone -> availability-zone|local-zone via the cloud's describe API
        (DescribeAvailabilityZones analogue), TTL-cached — zone topology
        changes at region-buildout cadence, not per launch."""
        hit = self._launchable_cache.get("zone-types")
        if hit is not None:
            return hit
        describe = getattr(self.cloud, "describe_availability_zones", None)
        out = describe() if describe is not None else {}
        self._launchable_cache.set("zone-types", out)
        return out

    def pool_reserved_allowed(self, nodepool) -> "set[tuple[str, str]]":
        """The (instance_type, zone) reserved offerings this pool may use:
        exactly its own nodeclass's resolved reservations. Per-pair — not a
        boolean — because the catalog tensors advertise every nodeclass's
        reservations globally, and a pool holding reservation X must not
        drain another nodeclass's reservation Y. Both the provisioner and
        the consolidation replace path gate through this one predicate so
        the two can never drift apart."""
        nc = self.cluster.nodeclasses.get(nodepool.nodeclass_name)
        if nc is None:
            return set()
        return {
            (r.instance_type, r.zone)
            for r in getattr(nc.status, "capacity_reservations", []) or []
        }

    def close(self) -> None:
        """Join the batchers' worker pools (their ThreadPoolExecutor threads
        are non-daemon; a stuck wire call would otherwise pin interpreter
        exit). Wired into Operator.stop()."""
        self._fleet_batcher.close()
        self._terminate_batcher.close()

    def reset_caches(self) -> None:
        """Test-environment hook: drop every provider-side cache."""
        self.subnets.reset()
        self.security_groups.reset()
        self.images.reset()
        self.instance_profiles.reset()
        self.launch_templates.reset()
        self.capacity_reservations.reset()
        self._launchable_cache.flush()

    def get(self, provider_id: str):
        instance_id = parse_provider_id(provider_id)
        if instance_id is None:
            raise errors.NotFoundError(f"bad provider id {provider_id}")
        return self.cloud.get_instance(instance_id)

    def list_instances(self):
        """All managed, non-terminated instances (parity: instance.go List
        by karpenter tag)."""
        return self.cloud.list_instances({MANAGED_TAG: "true"})

    # -- GetInstanceTypes --------------------------------------------------
    def get_instance_types(self, nodepool) -> list:
        """The scheduler's device catalog for one nodepool (parity:
        cloudprovider.go:154-171); the heavy lifting is the catalog tensor
        cache keyed by seqnums."""
        return self.catalog.list()

    # -- IsDrifted ---------------------------------------------------------
    def is_drifted(self, claim: NodeClaim, instances=None,
                   discovery_cache=None) -> DriftReason:
        """``instances`` (id -> instance) lets a bulk caller (the
        disruption controller's per-pass drift sweep) resolve the running
        instance from ONE list call instead of a locked per-claim
        ``get()`` round trip — 5k claims paid 5k cloud lookups per pass.
        ``discovery_cache`` (a dict the bulk caller owns for ONE sweep)
        memoizes the per-NODECLASS image/subnet/security-group discovery
        sets the same way: resolving them per claim was ~200ms of a
        10k-node pass for answers identical within the sweep."""
        # NodePool template drift first: the pool the claim was stamped
        # from has since changed labels/taints/requirements (core static
        # drift). Independent of the nodeclass — a deleted nodeclass must
        # not mask it (e.g. the pool was re-pointed and the old class
        # removed, which is itself template drift).
        def _hash_of(obj, kind: str) -> str:
            # spec hashes serialize the whole template (deepcopy + JSON);
            # per-sweep memoization via the caller's cache turns an
            # O(claims) re-serialization per pass into one per pool/class
            if discovery_cache is None:
                return obj.hash()
            hkey = (kind, obj.name)
            h = discovery_cache.get(hkey)
            if h is None:
                h = discovery_cache[hkey] = obj.hash()
            return h

        pool = self.cluster.nodepools.get(claim.nodepool_name)
        pool_stamp = claim.annotations.get(lbl.ANNOTATION_NODEPOOL_HASH)
        if pool is not None and pool_stamp is not None \
                and pool_stamp != _hash_of(pool, "pool"):
            return DriftReason.NODEPOOL
        nodeclass = self.cluster.nodeclasses.get(claim.nodeclass_name)
        if nodeclass is None:
            return DriftReason.NONE
        # static drift: stamped hash vs current spec hash (drift.go:41-60)
        stamped = claim.annotations.get(lbl.ANNOTATION_NODECLASS_HASH)
        if stamped is not None and stamped != _hash_of(nodeclass, "nodeclass"):
            return DriftReason.STATIC
        inst = None
        if instances is not None:
            iid = parse_provider_id(claim.status.provider_id)
            inst = instances.get(iid) if iid else None
        if inst is None:
            # bulk-map miss falls back to the exact per-claim lookup: the
            # listing is tag-filtered, and an untagged-but-running instance
            # must not silently stop drift-checking (misses are rare, so
            # the bulk win survives)
            try:
                inst = self.get(claim.status.provider_id)
            except Exception:
                return DriftReason.NONE
        # image drift: running image no longer among resolved images;
        # subnet / security-group drift vs current discovery. Resolved
        # once per nodeclass when the sweep hands in a cache.
        discovered = (
            discovery_cache.get(nodeclass.name)
            if discovery_cache is not None else None
        )
        if discovered is None:
            discovered = (
                {i.id for i in self.images.list(nodeclass)},
                {s.id for s in self.subnets.list(nodeclass)},
                {g.id for g in self.security_groups.list(nodeclass)},
            )
            if discovery_cache is not None:
                discovery_cache[nodeclass.name] = discovered
        images, subnet_ids, sg_ids = discovered
        if images and inst.image_id not in images:
            return DriftReason.IMAGE
        if inst.subnet_id and inst.subnet_id not in subnet_ids:
            return DriftReason.SUBNET
        if inst.security_group_ids and not set(inst.security_group_ids) <= sg_ids:
            return DriftReason.SECURITY_GROUP
        return DriftReason.NONE


def parse_provider_id(provider_id: str) -> Optional[str]:
    """cloud:///zone/i-... -> i-... (parity: utils.go:26-40 ParseInstanceID)."""
    if not provider_id:
        return None
    parts = provider_id.rsplit("/", 1)
    return parts[-1] if parts[-1].startswith("i-") else None
