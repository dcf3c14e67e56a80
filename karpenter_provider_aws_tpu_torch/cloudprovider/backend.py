"""The cloud-backend contract: what a cloud must provide to run this
framework.

The reference's whole design pivots on a declared plugin boundary
(the upstream provider's `pkg/cloudprovider/cloudprovider.go:54` asserts the
interface; the EC2 API surface the providers consume is the implicit second
boundary). Here that second boundary is explicit: ``CloudBackend`` is the
complete call surface the production providers/controllers make against the
cloud, and ``LaunchRequest`` is the wire unit of the launch path. The
in-memory test double (``fake.cloud.FakeCloud``) implements this Protocol;
a real adapter (REST/gRPC) slots in without touching any caller.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol, runtime_checkable


@dataclass
class LaunchRequest:
    """One logical single-node launch; the batcher coalesces many of these
    into one fleet call (parity: createfleet.go:52-110)."""

    instance_type_options: list[str]          # ranked cheapest-first
    offering_options: list[tuple[str, str]]   # launchable (zone, captype)
    image_id: str
    subnet_by_zone: dict[str, str] = field(default_factory=dict)
    security_group_ids: tuple[str, ...] = ()
    tags: dict[str, str] = field(default_factory=dict)
    launch_template_name: str = ""            # "" = launch without a template
    # reserved EC2 launch context, verbatim pass-through (instance.go:220)
    context: str = ""
    # sharded-control-plane fencing (operator/sharding.py): the
    # (lease name, token) tuple naming the lease tenancy that sanctioned
    # this launch. () = unfenced (single-replica). The backend rejects a
    # token older than the lease's current tenancy (StaleFencingToken).
    fence: tuple = ()


@runtime_checkable
class CloudBackend(Protocol):
    """Everything the framework calls on the cloud, in one place.

    Parity map (reference API clients the providers wrap):
     - fleet/instances  -> EC2 CreateFleet / DescribeInstances /
       TerminateInstances / CreateTags (instance.go, tagging controller)
     - subnets/SGs      -> DescribeSubnets / DescribeSecurityGroups
       (subnet.go:75-117, securitygroup.go)
     - images           -> DescribeImages (amifamily/ami.go:176-199)
     - launch templates -> Create/Describe/DeleteLaunchTemplate
       (launchtemplate.go:202-312)
     - instance profile -> IAM Create/DeleteInstanceProfile
       (instanceprofile.go:60-105)
     - reservations     -> DescribeCapacityReservations
     - zones            -> DescribeAvailabilityZones (localzone suite)
    """

    # -- capacity ----------------------------------------------------------
    def create_fleet(self, requests: list[LaunchRequest]) -> list: ...

    def describe_instances(self, ids: list[str]) -> list: ...

    def list_instances(self, tag_filters: Optional[dict[str, str]] = None) -> list: ...

    def terminate_instances(self, ids: list[str]) -> list: ...

    def get_instance(self, instance_id: str): ...

    def tag_instance(self, instance_id: str, tags: dict[str, str]) -> None: ...

    # -- coordination ------------------------------------------------------
    # Leader-election lease host (parity: the coordination.k8s.io Lease the
    # reference's controller-runtime manager uses, cmd/controller/main.go:34).
    # try_acquire_lease is a CAS acquire-or-renew returning the holder AFTER
    # the attempt; release_lease is the voluntary hand-off.
    def try_acquire_lease(self, name: str, holder: str, ttl_s: float) -> str: ...

    def release_lease(self, name: str, holder: str) -> None: ...

    # Fenced coordination (sharded control plane, operator/sharding.py):
    # the CAS additionally returns a monotonic fencing token (bumped per
    # holder change, never per renew) + the holder's instance nonce, and
    # list_leases serves membership discovery. Backends that cannot host
    # fenced leases simply don't run the sharded elector — the single
    # LeaderElector path needs only the two methods above.
    def try_acquire_lease_fenced(
        self, name: str, holder: str, ttl_s: float, nonce: str = "",
    ) -> tuple[str, int, str]: ...

    def list_leases(self, prefix: str = "") -> dict: ...

    # -- networking / discovery -------------------------------------------
    def describe_availability_zones(self) -> dict[str, str]: ...

    # Cluster network facts: at least service_ipv4_cidr / service_ipv6_cidr
    # (parity: EKS DescribeCluster feeding launchtemplate.go:429-450
    # ResolveClusterCIDR).
    def describe_cluster(self) -> dict: ...

    def describe_subnets(self) -> list: ...

    def describe_security_groups(self) -> list: ...

    def describe_capacity_reservations(self) -> list: ...

    # ``selector_terms`` (optional SelectorTerm sequence) lets the backend
    # push discovery scoping into the wire call (AWS: per-term
    # DescribeImages filters/ids/owners); None = account-wide discovery.
    def describe_images(self, selector_terms=None) -> list: ...

    # -- launch templates --------------------------------------------------
    def create_launch_template(self, name: str, image_id: str, user_data: str = "",
                               **kwargs) -> None: ...

    def describe_launch_templates(self) -> list: ...

    def delete_launch_template(self, name: str) -> None: ...

    # -- identity ----------------------------------------------------------
    def create_instance_profile(self, name: str, role: str, tags: dict[str, str]) -> None: ...

    def delete_instance_profile(self, name: str) -> None: ...
