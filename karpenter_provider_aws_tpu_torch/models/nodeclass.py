"""NodeClass: cloud-specific node configuration (EC2NodeClass analogue).

Reference parity: ``pkg/apis/v1beta1/ec2nodeclass.go:29-120`` (spec: selector
terms, AMI family, role/instanceProfile, userData, block devices, metadata
options, tags) and ``ec2nodeclass_status.go:56-92`` (status: resolved
subnets/security-groups/images/instance-profile + conditions), plus the
static drift hash (``ec2nodeclass.go:340``, ``hash/controller.go:47-70``).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field, asdict
from typing import Optional

from . import labels as lbl
from .pod import _Seq

#: Bumped by every NodePool / NodeClass field reassignment, process-wide.
#: Direct in-place spec edits on live objects never reach the store's
#: change journal; consumers that cache per-spec derivations (the
#: disruption controller's dirty-set drift/expiry state) re-scan when this
#: sequence moves — the same over-invalidation contract as NODE_WRITE_SEQ.
SPEC_WRITE_SEQ = _Seq()


@dataclass(frozen=True)
class SelectorTerm:
    """Discovery selector for subnets / security groups / images
    (parity: SubnetSelectorTerm / SecurityGroupSelectorTerm / AMISelectorTerm).

    ``owner`` (AMISelectorTerm.Owner parity) scopes the WIRE discovery
    call (DescribeImages Owner param) — it narrows what the cloud returns
    rather than what ``matches`` accepts host-side, since discovered
    resource models carry no owner field to check against."""

    tags: tuple[tuple[str, str], ...] = ()
    id: str = ""
    name: str = ""
    owner: str = ""

    @staticmethod
    def of(id: str = "", name: str = "", owner: str = "", **tags) -> "SelectorTerm":
        return SelectorTerm(
            tags=tuple(sorted(tags.items())), id=id, name=name, owner=owner
        )

    def matches(self, resource) -> bool:
        if self.id:
            return resource.id == self.id
        if self.name:
            rname = getattr(resource, "name", "")
            if "*" in self.name or "?" in self.name:
                # EC2 DescribeImages name filters take shell-style
                # wildcards; the host-side enforcement point must accept
                # exactly what the scoped wire call matched
                import fnmatch

                if not fnmatch.fnmatchcase(rname, self.name):
                    return False
            elif rname != self.name:
                return False
        rtags = getattr(resource, "tags", {})
        for k, v in self.tags:
            if v == "*":
                if k not in rtags:
                    return False
            elif rtags.get(k) != v:
                return False
        # an owner-only term constrains at the wire (Owner param); host-side
        # it accepts whatever that scoped discovery returned
        return bool(self.tags) or bool(self.name) or bool(self.owner)


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


@dataclass(frozen=True)
class BlockDevice:
    device_name: str = "/dev/xvda"
    volume_size_gib: int = 20
    volume_type: str = "gp3"
    iops: Optional[int] = None
    throughput: Optional[int] = None
    encrypted: bool = True
    delete_on_termination: bool = True
    # at most one mapping may be the root volume (CEL rule parity:
    # ec2nodeclass.go:89 "must have only one blockDeviceMappings with
    # rootVolume")
    root_volume: bool = False


@dataclass(frozen=True)
class MetadataOptions:
    """IMDS options (parity: ec2nodeclass.go MetadataOptions defaults)."""

    http_endpoint: str = "enabled"
    http_protocol_ipv6: str = "disabled"
    http_put_response_hop_limit: int = 2
    http_tokens: str = "required"


@dataclass
class Condition:
    type: str
    status: bool
    reason: str = ""
    message: str = ""
    transition_seq: int = 0


@dataclass
class NodeClassStatus:
    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        SPEC_WRITE_SEQ.v += 1  # discovery updates move drift answers

    subnets: list = field(default_factory=list)           # resolved Subnet objects
    security_groups: list = field(default_factory=list)   # resolved SecurityGroup objects
    images: list = field(default_factory=list)            # resolved Image objects
    capacity_reservations: list = field(default_factory=list)  # resolved reservations
    instance_profile: str = ""
    conditions: dict[str, Condition] = field(default_factory=dict)

    def set_condition(self, ctype: str, status: bool, reason: str = "", message: str = "") -> None:
        self.conditions[ctype] = Condition(ctype, status, reason, message)

    def is_ready(self) -> bool:
        c = self.conditions.get("Ready")
        return c is not None and c.status


@dataclass
class NodeClass:
    def __setattr__(self, name, value):
        # see SPEC_WRITE_SEQ: direct spec edits must wake journal-driven
        # consumers (the disruption drift sweep) without a store apply()
        object.__setattr__(self, name, value)
        SPEC_WRITE_SEQ.v += 1

    name: str
    image_family: str = "standard"  # parity with AMIFamily: standard|minimal|gpu|custom
    image_selector: list[SelectorTerm] = field(default_factory=list)
    subnet_selector: list[SelectorTerm] = field(default_factory=list)
    security_group_selector: list[SelectorTerm] = field(default_factory=list)
    # Capacity-reservation discovery (ODCR analogue): reservations matching
    # any term become 'reserved' capacity-type offerings at price 0.
    capacity_reservation_selector: list[SelectorTerm] = field(default_factory=list)
    role: str = ""
    instance_profile: str = ""  # mutually exclusive with role
    user_data: str = ""
    block_devices: list[BlockDevice] = field(default_factory=lambda: [BlockDevice()])
    metadata_options: MetadataOptions = field(default_factory=MetadataOptions)
    tags: dict[str, str] = field(default_factory=dict)
    vm_memory_overhead_percent: float = 0.075  # options.go VMMemoryOverheadPercent default
    detailed_monitoring: bool = False
    # How instance-store (local NVMe) disks are used. "RAID0" makes them the
    # node's ephemeral-storage (capacity = total instance-store size) and the
    # bootstrap configures the RAID (parity: ec2nodeclass.go:93-95 +
    # types.go:218-224 ephemeralStorage + eksbootstrap.go:80-82 /
    # nodeadm.go:86-88). None leaves ephemeral-storage on the EBS root.
    instance_store_policy: Optional[str] = None  # None | "RAID0"
    # Explicit public-IP override (parity: ec2nodeclass.go:45-47). None =
    # infer from the resolved subnets (subnet.go:119-130); True/False wins.
    associate_public_ip: Optional[bool] = None
    # Reserved EC2 launch context, passed through to the fleet request
    # verbatim (parity: ec2nodeclass.go:116-119 + instance.go:220).
    context: str = ""
    status: NodeClassStatus = field(default_factory=NodeClassStatus)
    finalizers: set[str] = field(default_factory=set)
    deleted: bool = False

    # Fields excluded from the static drift hash because they are resolved
    # dynamically (parity: hash tags on ec2nodeclass.go spec fields).
    _HASH_EXCLUDE = ("status", "finalizers", "deleted", "image_selector",
                     "subnet_selector", "security_group_selector",
                     "capacity_reservation_selector")

    def hash(self) -> str:
        """Static drift hash over immutable spec fields
        (parity: ec2nodeclass.go:340 Hash via hashstructure)."""
        spec = {}
        for k, v in self.__dict__.items():
            if k in self._HASH_EXCLUDE or k.startswith("_"):
                continue
            if hasattr(v, "__dataclass_fields__"):
                v = asdict(v)
            elif isinstance(v, list):
                v = [asdict(x) if hasattr(x, "__dataclass_fields__") else x for x in v]
            spec[k] = v
        blob = json.dumps(spec, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def root_volume_size_gib(self) -> int:
        """Size of the root EBS volume: the device marked rootVolume, else
        the first mapping, else the 20 GiB family default. ONE home for the
        rule — claim capacity (cloudprovider) and the solve tensor (encode)
        must agree on it (parity: types.go:225-244 block-device resolution)."""
        root = next(
            (b for b in self.block_devices if b.root_volume),
            self.block_devices[0] if self.block_devices else None,
        )
        return root.volume_size_gib if root else 20

    def capacity_kwargs(self) -> dict:
        """kwargs for InstanceType.capacity()/CatalogProvider.allocatable()
        derived from this nodeclass — the ONE home for how a nodeclass
        shapes node capacity (fit accounting, limits accounting, and claim
        status must agree)."""
        return {
            "ephemeral_gib": self.root_volume_size_gib(),
            "instance_store_policy": self.instance_store_policy,
        }

    def hash_annotations(self) -> dict[str, str]:
        return {
            lbl.ANNOTATION_NODECLASS_HASH: self.hash(),
            lbl.ANNOTATION_NODECLASS_HASH_VERSION: lbl.NODECLASS_HASH_VERSION,
        }
