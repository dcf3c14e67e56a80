"""NodeClaim: a request for one node, tracked from launch to registration.

Owns what the reference consumes from the core NodeClaim API + lifecycle
(SURVEY.md section 2.2): requirements snapshot, resource request, provider-ID
binding, and Launched/Registered/Initialized conditions. The cloud provider
converts a launched instance into NodeClaim status
(parity: pkg/cloudprovider/cloudprovider.go:294-337 instanceToNodeClaim).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

from .requirements import Requirement, Requirements
from .resources import ResourceVector
from .nodeclass import Condition

_seq = itertools.count()


@dataclass
class NodeClaimStatus:
    provider_id: str = ""
    image_id: str = ""
    internal_ip: str = ""
    node_name: str = ""
    capacity: ResourceVector = field(default_factory=ResourceVector)
    allocatable: ResourceVector = field(default_factory=ResourceVector)
    conditions: dict[str, Condition] = field(default_factory=dict)

    def set_condition(self, ctype: str, status: bool, reason: str = "") -> None:
        self.conditions[ctype] = Condition(ctype, status, reason)

    def condition(self, ctype: str) -> bool:
        c = self.conditions.get(ctype)
        return c is not None and c.status


@dataclass
class NodeClaim:
    name: str
    nodepool_name: str = ""
    nodeclass_name: str = "default"
    requirements: list[Requirement] = field(default_factory=list)
    resources: ResourceVector = field(default_factory=ResourceVector)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    taints: list = field(default_factory=list)
    startup_taints: list = field(default_factory=list)
    created_at: float = 0.0
    deleted: bool = False
    deleted_at: float = 0.0  # clock time of the delete mark (grace periods)
    # snapshotted from the pool at launch (core copies it onto the claim):
    # the deadline must survive the pool being edited/deleted mid-drain
    termination_grace_period_s: "Optional[float]" = None
    finalizers: set[str] = field(default_factory=set)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)
    # Solver hints: candidate instance-type names ranked by the solve, passed
    # to the launch path (parity: the scheduler passing instance-type options
    # into CloudProvider.Create, truncated at instance.go:52-53).
    instance_type_options: list[str] = field(default_factory=list)
    capacity_type_options: list[str] = field(default_factory=list)
    zone_options: list[str] = field(default_factory=list)
    offering_options: list[tuple] = field(default_factory=list)  # joint (zone, captype)

    @staticmethod
    def fresh(nodepool_name: str, nodeclass_name: str = "default", **kw) -> "NodeClaim":
        return NodeClaim(name=f"{nodepool_name}-{next(_seq):x}", nodepool_name=nodepool_name,
                         nodeclass_name=nodeclass_name, **kw)

    def scheduling_requirements(self) -> Requirements:
        return Requirements(self.requirements).union(Requirements.from_labels(self.labels))

    def is_launched(self) -> bool:
        return self.status.condition("Launched")

    def is_registered(self) -> bool:
        return self.status.condition("Registered")

    def is_initialized(self) -> bool:
        return self.status.condition("Initialized")
