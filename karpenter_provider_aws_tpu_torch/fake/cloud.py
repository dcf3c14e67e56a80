"""FakeCloud: the EC2-shaped in-memory backend.

Parity map (pkg/fake/ec2api.go):
 - ``EC2Behavior`` programmable outputs / recorded inputs -> ``calls`` +
   ``next_errors``
 - ``sync.Map`` instance store -> ``instances`` dict under a lock
 - ``InsufficientCapacityPools`` -> ``ice_pools`` (set of
   (capacity_type, instance_type, zone) triples) honored by create_fleet
   (ec2api.go:112-160 CreateFleet simulation)
 - capacity_pools: optional finite pool sizes, decremented per launch
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field, replace
from typing import Optional

from ..cloudprovider.backend import LaunchRequest  # noqa: F401 (re-exported)
from ..utils.clock import Clock, RealClock
from ..utils.errors import (
    InsufficientCapacityError,
    NotFoundError,
)

_ids = itertools.count(1000)


@dataclass
class Subnet:
    id: str
    zone: str
    available_ips: int = 8192
    tags: dict[str, str] = field(default_factory=dict)
    public: bool = False
    ipv6_native: bool = False  # nodes in this subnet get IPv6 internal IPs


@dataclass
class SecurityGroup:
    id: str
    name: str = ""
    tags: dict[str, str] = field(default_factory=dict)


@dataclass
class CapacityReservation:
    """A pre-paid (instance_type, zone) capacity pool with a hard count
    (the cloud-side ground truth behind catalog/reservations.py)."""

    id: str
    instance_type: str
    zone: str
    count: int
    used: int = 0
    name: str = ""
    tags: dict[str, str] = field(default_factory=dict)
    # Market-window fields (EC2 Capacity Blocks shape): launches may draw
    # slots only inside [start_s, end_s); None = open-ended on that side
    # (a plain ODCR). committed_price is the $/hr the block was bought at.
    start_s: Optional[float] = None
    end_s: Optional[float] = None
    committed_price: float = 0.0

    @property
    def remaining(self) -> int:
        return max(self.count - self.used, 0)

    def open_at(self, now: float) -> bool:
        if self.start_s is not None and now < self.start_s:
            return False
        if self.end_s is not None and now >= self.end_s:
            return False
        return True


@dataclass
class Image:
    id: str
    name: str
    family: str = "standard"        # image-family alias (AMI family analogue)
    arch: str = "amd64"
    gpu: bool = False
    created_seq: int = 0            # newest-first ordering key
    deprecated: bool = False
    tags: dict[str, str] = field(default_factory=dict)


@dataclass
class Instance:
    id: str
    instance_type: str
    zone: str
    capacity_type: str
    image_id: str
    subnet_id: str = ""
    security_group_ids: tuple[str, ...] = ()
    state: str = "running"          # pending | running | shutting-down | terminated
    private_ip: str = ""
    launch_time: float = 0.0
    tags: dict[str, str] = field(default_factory=dict)
    capacity_reservation_id: str = ""  # set for reserved-captype launches
    # the (lease name, fencing token) this launch was sanctioned under —
    # () for unfenced launches (single-replica deployments) and the
    # ("__seeded__", 0) sentinel for harness-seeded fleets. The
    # no-double-launch chaos invariant reads this.
    launch_fence: tuple = ()

    @property
    def provider_id(self) -> str:
        return f"cloud:///{self.zone}/{self.id}"


@dataclass
class LaunchTemplateData:
    name: str
    image_id: str
    user_data: str = ""
    instance_profile: str = ""
    security_group_ids: tuple[str, ...] = ()
    block_devices: tuple = ()
    metadata_options: Optional[object] = None
    tags: dict[str, str] = field(default_factory=dict)
    # None = subnet default; True/False = pinned (spec override or private-
    # subnet inference — ec2nodeclass.go:45-47, subnet.go:119-130)
    associate_public_ip: Optional[bool] = None
    detailed_monitoring: bool = False


class FakeCloud:
    def __init__(self, clock: Optional[Clock] = None, zones=("zone-a", "zone-b", "zone-c", "zone-d")):
        self.clock = clock or RealClock()
        self._lock = threading.RLock()
        self.zones = tuple(zones)
        # zone -> "availability-zone" | "local-zone" (parity: the localzone
        # suite selecting zones by type from DescribeAvailabilityZones)
        self.zone_types: dict[str, str] = {z: "availability-zone" for z in zones}
        self.subnets: list[Subnet] = [
            Subnet(id=f"subnet-{i}", zone=z, tags={"discovery": "cluster-1"})
            for i, z in enumerate(zones)
        ]
        self.security_groups: list[SecurityGroup] = [
            SecurityGroup(id="sg-1", name="default", tags={"discovery": "cluster-1"}),
        ]
        # coordination leases: name -> (holder, expires_at, holder nonce).
        # The nonce distinguishes two ELECTOR INSTANCES that share one
        # identity string (a deployment bug): without it both would renew
        # "their" lease and both believe they lead.
        self._leases: dict[str, tuple[str, float, str]] = {}
        # per-lease monotonic fencing tokens: bumped on every HOLDER
        # change (acquire of a new/expired/released lease), never on a
        # renew — the control-plane-store half of the fenced-write
        # protocol (operator/sharding.py)
        self._lease_tokens: dict[str, int] = {}
        # fenced writes rejected, by lease name (introspection; the
        # metric counts globally)
        self.fenced_rejections: list[tuple[str, int, int, str]] = []
        # work-stealing claim table (sharded provisioning): (queue, item)
        # -> (owner, expires_at, fence). Claims are fenced CAS writes like
        # launches — a deposed replica can neither claim nor renew.
        self._work_claims: dict[tuple[str, str], tuple[str, float, tuple]] = {}
        self.images: list[Image] = [
            Image(id="img-std-2", name="standard-v2", family="standard", arch="amd64", created_seq=2),
            Image(id="img-std-arm-2", name="standard-arm-v2", family="standard", arch="arm64", created_seq=2),
            Image(id="img-std-1", name="standard-v1", family="standard", arch="amd64", created_seq=1),
            Image(id="img-gpu-1", name="gpu-v1", family="gpu", arch="amd64", gpu=True, created_seq=1),
            Image(id="img-min-1", name="minimal-v1", family="minimal", arch="amd64", created_seq=1),
            Image(id="img-min-arm-1", name="minimal-arm-v1", family="minimal", arch="arm64", created_seq=1),
            Image(id="img-br-1", name="bottlerocket-v1", family="bottlerocket", arch="amd64", created_seq=1),
            Image(id="img-br-arm-1", name="bottlerocket-arm-v1", family="bottlerocket", arch="arm64", created_seq=1),
            Image(id="img-nodeadm-1", name="nodeadm-v1", family="nodeadm", arch="amd64", created_seq=1),
            Image(id="img-nodeadm-arm-1", name="nodeadm-arm-v1", family="nodeadm", arch="arm64", created_seq=1),
            Image(id="img-ubuntu-1", name="ubuntu-v1", family="ubuntu", arch="amd64", created_seq=1),
            Image(id="img-ubuntu-arm-1", name="ubuntu-arm-v1", family="ubuntu", arch="arm64", created_seq=1),
            Image(id="img-win-1", name="windows-v1", family="windows", arch="amd64", created_seq=1),
        ]
        self.instances: dict[str, Instance] = {}
        self.instance_profiles: dict[str, dict] = {}
        # id -> CapacityReservation (count-limited pre-paid pools)
        self.capacity_reservations: dict[str, "CapacityReservation"] = {}
        self.launch_templates: dict[str, LaunchTemplateData] = {}
        # Fault injection
        self.ice_pools: set[tuple[str, str, str]] = set()   # (captype, type, zone)
        self.capacity_pools: dict[tuple[str, str, str], int] = {}
        self.next_errors: list[Exception] = []
        # Recorded inputs per API name
        self.calls: dict[str, list] = {}

    # -- bookkeeping -------------------------------------------------------
    def _record(self, api: str, payload) -> None:
        self.calls.setdefault(api, []).append(payload)

    def _maybe_fail(self):
        if self.next_errors:
            raise self.next_errors.pop(0)

    def reset(self) -> None:
        """Between-spec reset (parity: pkg/test/environment.go:168-197)."""
        with self._lock:
            self.instances.clear()
            self.instance_profiles.clear()
            self.launch_templates.clear()
            self.ice_pools.clear()
            self.capacity_pools.clear()
            self.capacity_reservations.clear()
            self.next_errors.clear()
            self.calls.clear()
            self.fenced_rejections.clear()
            self._work_claims.clear()

    # -- fleet launch ------------------------------------------------------
    def create_fleet(self, requests: list[LaunchRequest]) -> list:
        """Launch one instance per request; per-request ICE errors are
        returned positionally (the batcher scatters them back to callers)."""
        with self._lock:
            self._record("create_fleet", requests)
            self._maybe_fail()
            results = []
            for req in requests:
                results.append(self._launch_one(req))
            return results

    def _launch_one(self, req: LaunchRequest):
        # Fencing first (sharded control plane): a launch sanctioned by a
        # superseded lease tenancy must not create capacity — the
        # successor replica already owns this partition's writes.
        fence_err = self._check_fence(getattr(req, "fence", ()), "create_fleet")
        if fence_err is not None:
            return fence_err
        # Launch-template reference must resolve (parity: CreateFleet's
        # InvalidLaunchTemplateName.NotFoundException, instance.go:106-110).
        if req.launch_template_name and req.launch_template_name not in self.launch_templates:
            return NotFoundError(
                f"launch template {req.launch_template_name} not found",
                code="InvalidLaunchTemplateName.NotFoundException",
            )
        # Walk ranked (type, offering) choices; first non-ICE pool wins —
        # mirrors CreateFleet's lowest-price allocation honoring ICE pools.
        last_ice = None
        for itype in req.instance_type_options:
            for zone, captype in req.offering_options:
                pool = (captype, itype, zone)
                if pool in self.ice_pools:
                    last_ice = pool
                    continue
                remaining = self.capacity_pools.get(pool)
                if remaining is not None:
                    if remaining <= 0:
                        last_ice = pool
                        continue
                    self.capacity_pools[pool] = remaining - 1
                reservation_id = ""
                if captype == "reserved":
                    # hard count: a reserved launch must draw from a live
                    # reservation, else the pool is effectively ICE
                    res = next(
                        (r for r in self.capacity_reservations.values()
                         if r.instance_type == itype and r.zone == zone
                         and r.remaining > 0 and r.open_at(self.clock.now())),
                        None,
                    )
                    if res is None:
                        last_ice = pool
                        continue
                    res.used += 1
                    reservation_id = res.id
                subnet_id = req.subnet_by_zone.get(zone, "")
                subnet = next((sn for sn in self.subnets if sn.id == subnet_id), None)
                seq = next(_ids)
                ipv6 = subnet is not None and subnet.ipv6_native
                inst = Instance(
                    id=f"i-{seq:08x}",
                    instance_type=itype,
                    zone=zone,
                    capacity_type=captype,
                    image_id=req.image_id,
                    subnet_id=subnet_id,
                    private_ip=(f"fd00::{seq:x}" if ipv6 else f"10.0.{(seq >> 8) & 255}.{seq & 255}"),
                    security_group_ids=req.security_group_ids,
                    launch_time=self.clock.now(),
                    tags=dict(req.tags),
                    capacity_reservation_id=reservation_id,
                    launch_fence=tuple(getattr(req, "fence", ()) or ()),
                )
                self.instances[inst.id] = inst
                return inst
        if last_ice is not None:
            captype, itype, zone = last_ice
            return InsufficientCapacityError(instance_type=itype, zone=zone, capacity_type=captype)
        return InsufficientCapacityError(message="no launchable offering in request")

    def describe_availability_zones(self) -> dict[str, str]:
        with self._lock:
            self._record("describe_availability_zones", None)
            self._maybe_fail()
            return dict(self.zone_types)

    # -- coordination (leader-election lease host) -------------------------
    def try_acquire_lease(self, name: str, holder: str, ttl_s: float) -> str:
        """CAS acquire-or-renew: the current holder renews, anyone else
        takes over only after expiry. Returns the holder AFTER the attempt
        (parity: the coordination.k8s.io Lease the reference's manager
        rides, cmd/controller/main.go:34)."""
        return self.try_acquire_lease_fenced(name, holder, ttl_s)[0]

    def try_acquire_lease_fenced(
        self, name: str, holder: str, ttl_s: float, nonce: str = "",
    ) -> tuple[str, int, str]:
        """Fenced CAS acquire-or-renew: returns ``(holder, token, nonce)``
        after the attempt. The fencing token bumps on every holder change
        and NEVER on a renew, so a token uniquely names one continuous
        tenancy of the lease; the fenced write checks below reject any
        token older than the current one. ``nonce`` distinguishes elector
        instances sharing one identity: a same-identity contender with a
        different nonce is a CONTENDER, not the holder renewing — it
        waits out the TTL like anyone else."""
        with self._lock:
            self._maybe_fail()
            now = self.clock.now()
            lease = self._leases.get(name)
            if lease is None or now >= lease[1] or (
                lease[0] == holder and lease[2] == nonce
            ):
                if lease is None or lease[0] != holder or lease[2] != nonce \
                        or now >= lease[1]:
                    # new tenancy (fresh, expired, or a same-identity
                    # takeover): the fencing token advances
                    self._lease_tokens[name] = self._lease_tokens.get(name, 0) + 1
                self._leases[name] = (holder, now + ttl_s, nonce)
                return holder, self._lease_tokens[name], nonce
            return lease[0], self._lease_tokens.get(name, 0), lease[2]

    def release_lease(self, name: str, holder: str) -> None:
        """Voluntary hand-off; only the holder may release. The fencing
        token survives the release — the NEXT acquire bumps it, so a
        released-and-reacquired lease still fences the old tenancy out."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is not None and lease[0] == holder:
                del self._leases[name]

    def list_leases(self, prefix: str = "") -> dict[str, tuple[str, float, str]]:
        """Live (unexpired) leases by name, optionally prefix-filtered —
        the sharded elector's membership discovery reads
        ``karpenter-shard-member/`` through this."""
        with self._lock:
            now = self.clock.now()
            return {
                name: lease
                for name, lease in self._leases.items()
                if name.startswith(prefix) and now < lease[1]
            }

    def lease_token(self, name: str) -> int:
        """The current fencing token for ``name`` (0 = never acquired)."""
        with self._lock:
            return self._lease_tokens.get(name, 0)

    # -- work-stealing claim table (sharded provisioning) ------------------
    def try_claim_work(self, queue: str, items: list[str], owner: str,
                       ttl_s: float, fence: tuple) -> list[str]:
        """Fenced batch CAS over the GLOBAL work queue: returns the subset
        of ``items`` now claimed by ``owner`` — newly claimed (unclaimed
        or expired entries) plus renewals of ``owner``'s own live claims.
        Items claimed by another live owner are skipped, never stolen
        silently: a steal happens only through expiry (the claimant died)
        or release. The claim itself is a control-plane write sanctioned
        by ``fence`` — a superseded tenancy's claim attempt raises
        ``StaleFencingTokenError``, so a deposed replica cannot keep
        feeding itself work (the exactly-once handoff edge)."""
        with self._lock:
            self._record("try_claim_work", (queue, list(items), owner))
            self._maybe_fail()
            fence_err = self._check_fence(fence, "try_claim_work")
            if fence_err is not None:
                raise fence_err
            now = self.clock.now()
            granted: list[str] = []
            for item in items:
                cur = self._work_claims.get((queue, item))
                if cur is not None and cur[0] != owner and now < cur[1]:
                    continue  # live foreign claim: lost the race
                self._work_claims[(queue, item)] = (
                    owner, now + float(ttl_s), tuple(fence or ()),
                )
                granted.append(item)
            return granted

    def release_work(self, queue: str, items: list[str], owner: str) -> None:
        """Voluntary release (item solved/bound or abandoned); only the
        owner's own claims are dropped."""
        with self._lock:
            self._record("release_work", (queue, list(items), owner))
            for item in items:
                cur = self._work_claims.get((queue, item))
                if cur is not None and cur[0] == owner:
                    del self._work_claims[(queue, item)]

    def list_work_claims(self, queue: str) -> dict[str, tuple[str, float]]:
        """Live (unexpired) claims: item -> (owner, expires_at)."""
        with self._lock:
            now = self.clock.now()
            return {
                item: (owner, exp)
                for (q, item), (owner, exp, _f) in self._work_claims.items()
                if q == queue and now < exp
            }

    def _check_fence(self, fence, api: str):
        """Validate a write's fencing token against the lease host's
        current token the way a real control-plane store would: a token
        OLDER than the lease's current tenancy means the writer was
        deposed after it planned this write — reject, don't race the
        successor. Returns the error (callers decide raise-vs-positional).
        Callers hold the lock. Valid tokens start at 1 — token 0 is the
        explicit never-held sentinel (``sharding.write_fence``'s fallback
        for a writer holding no relevant lease) and is rejected even when
        the lease has never been acquired (``cur == 0``): a fenced write
        is only sanctioned by a tenancy somebody actually holds."""
        if not fence:
            return None
        name, token = fence[0], int(fence[1])
        if name == "__seeded__":
            return None
        cur = self._lease_tokens.get(name, 0)
        if token < cur or token < 1:
            self.fenced_rejections.append((name, token, cur, api))
            try:
                from ..metrics import FENCED_WRITES_REJECTED

                FENCED_WRITES_REJECTED.inc(api=api)
            except Exception:
                pass
            from ..utils.errors import StaleFencingTokenError

            return StaleFencingTokenError(
                f"{api}: fencing token {token} for {name} superseded by "
                f"{cur}: the sanctioning lease has a new holder"
            )
        return None

    def describe_cluster(self) -> dict:
        """Cluster network facts (EKS DescribeCluster analogue)."""
        with self._lock:
            self._record("describe_cluster", None)
            self._maybe_fail()
            return {
                "service_ipv4_cidr": "10.100.0.0/16",
                "service_ipv6_cidr": "fd00:10::/108",
            }

    # -- instance APIs -----------------------------------------------------
    def describe_instances(self, ids: list[str]) -> list[Instance]:
        with self._lock:
            self._record("describe_instances", list(ids))
            self._maybe_fail()
            return [self.instances[i] for i in ids if i in self.instances]

    def list_instances(self, tag_filters: Optional[dict[str, str]] = None) -> list[Instance]:
        with self._lock:
            self._record("list_instances", tag_filters or {})
            self._maybe_fail()
            out = []
            for inst in self.instances.values():
                if inst.state == "terminated":
                    continue
                if tag_filters and not all(
                    (v == "*" and k in inst.tags) or inst.tags.get(k) == v
                    for k, v in tag_filters.items()
                ):
                    continue
                out.append(inst)
            return out

    def terminate_instances(self, ids: list[str], fences: Optional[dict] = None) -> list:
        """``fences`` (instance id -> (lease name, token), optional) fences
        each terminate the way ``LaunchRequest.fence`` fences a launch: a
        write from a superseded lease tenancy returns the rejection
        positionally (the batcher scatters it back) and the instance
        stays running for its real owner to manage."""
        with self._lock:
            self._record("terminate_instances", list(ids))
            self._maybe_fail()
            results = []
            for i in ids:
                fence_err = self._check_fence(
                    (fences or {}).get(i, ()), "terminate_instances"
                )
                if fence_err is not None:
                    results.append(fence_err)
                    continue
                inst = self.instances.get(i)
                if inst is None:
                    results.append(NotFoundError(f"instance {i} not found"))
                else:
                    if inst.state != "terminated" and inst.capacity_reservation_id:
                        res = self.capacity_reservations.get(inst.capacity_reservation_id)
                        if res is not None and res.used > 0:
                            res.used -= 1
                    inst.state = "terminated"
                    results.append(inst)
            return results

    def get_instance(self, instance_id: str) -> Instance:
        with self._lock:
            inst = self.instances.get(instance_id)
            if inst is None or inst.state == "terminated":
                raise NotFoundError(f"instance {instance_id} not found")
            return inst

    def tag_instance(self, instance_id: str, tags: dict[str, str]) -> None:
        with self._lock:
            self._record("tag_instance", (instance_id, dict(tags)))
            self._maybe_fail()
            self.get_instance(instance_id).tags.update(tags)

    # -- discovery APIs ----------------------------------------------------
    def describe_subnets(self) -> list[Subnet]:
        with self._lock:
            self._record("describe_subnets", None)
            self._maybe_fail()
            return list(self.subnets)

    def describe_security_groups(self) -> list[SecurityGroup]:
        with self._lock:
            self._record("describe_security_groups", None)
            self._maybe_fail()
            return list(self.security_groups)

    def describe_capacity_reservations(self) -> list[CapacityReservation]:
        with self._lock:
            self._record("describe_capacity_reservations", None)
            self._maybe_fail()
            # snapshots, like a real describe call — callers caching these
            # must not see later cloud-side mutations for free (tags too:
            # selector terms match on them)
            return [replace(r, tags=dict(r.tags)) for r in self.capacity_reservations.values()]

    def describe_images(self, selector_terms=None) -> list[Image]:
        with self._lock:
            self._record("describe_images", selector_terms)
            self._maybe_fail()
            live = [i for i in self.images if not i.deprecated]
            if not selector_terms:
                return live
            # mirror the AWS backend's wire scoping: union of per-term
            # matches (the provider's host-side filter then re-applies)
            return [
                i for i in live
                if any(t.matches(i) for t in selector_terms)
            ]

    # -- launch templates --------------------------------------------------
    def create_launch_template(self, name: str, image_id: str, user_data: str = "",
                               instance_profile: str = "", security_group_ids=(),
                               block_devices=(), metadata_options=None,
                               tags: Optional[dict[str, str]] = None,
                               associate_public_ip: Optional[bool] = None,
                               detailed_monitoring: bool = False) -> LaunchTemplateData:
        with self._lock:
            self._record("create_launch_template", name)
            self._maybe_fail()
            lt = LaunchTemplateData(
                name=name, image_id=image_id, user_data=user_data,
                instance_profile=instance_profile,
                security_group_ids=tuple(security_group_ids),
                block_devices=tuple(block_devices),
                metadata_options=metadata_options, tags=dict(tags or {}),
                associate_public_ip=associate_public_ip,
                detailed_monitoring=detailed_monitoring,
            )
            self.launch_templates[name] = lt
            return lt

    def describe_launch_templates(self) -> list[LaunchTemplateData]:
        with self._lock:
            self._record("describe_launch_templates", None)
            self._maybe_fail()
            return list(self.launch_templates.values())

    def delete_launch_template(self, name: str) -> None:
        with self._lock:
            self._record("delete_launch_template", name)
            self._maybe_fail()
            if name not in self.launch_templates:
                raise NotFoundError(f"launch template {name} not found")
            del self.launch_templates[name]

    # -- instance profiles (IAM analogue) ----------------------------------
    def create_instance_profile(self, name: str, role: str, tags: dict[str, str]) -> None:
        with self._lock:
            self._record("create_instance_profile", (name, role))
            self._maybe_fail()
            self.instance_profiles.setdefault(name, {"role": role, "tags": dict(tags)})

    def delete_instance_profile(self, name: str) -> None:
        with self._lock:
            self._record("delete_instance_profile", name)
            self._maybe_fail()
            if name not in self.instance_profiles:
                raise NotFoundError(f"instance profile {name} not found", code="NoSuchEntity")
            del self.instance_profiles[name]
