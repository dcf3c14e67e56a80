"""The Cluster store + Node model, as far as the consolidation screen reads
them.

``Node`` is the JAX package's ``state/cluster.py`` Node unchanged. ``Cluster``
keeps only the store surface the cluster encode reads: ``apply`` for pods,
nodes and claims, ``bind_pod``, ``pods_by_node``, ``snapshot_nodes`` and
``snapshot_claims``. It carries no change journal, partitions or PDBs, so
``ops.consolidate.encode_cluster`` always takes the full encode.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from ..models import labels as lbl
from ..models.nodeclaim import NodeClaim
from ..models.pod import Pod, _Seq
from ..models.resources import ResourceVector


@dataclass
class Node:
    name: str
    provider_id: str = ""
    nodepool_name: str = ""
    nodeclaim_name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    taints: list = field(default_factory=list)
    capacity: ResourceVector = field(default_factory=ResourceVector)
    allocatable: ResourceVector = field(default_factory=ResourceVector)
    ready: bool = False
    cordoned: bool = False
    internal_ip: str = ""
    created_at: float = 0.0
    # monotonic timestamp of the last pod bind/unbind touching this node;
    # consolidateAfter quiet windows are measured from here
    last_pod_event: float = 0.0
    # bumped on EVERY field assignment (controllers flip ready/cordoned and
    # reassign labels in place on the live object, outside Cluster methods).
    # The incremental cluster encoder compares this per row, so direct
    # attribute mutation can never serve stale tensors. ``last_pod_event``
    # is exempt: it never shapes tensors and is written on every bind —
    # tracking it would force the defensive O(N) scan every pass.
    _version: int = field(default=0, repr=False, compare=False)

    def __setattr__(self, name, value):
        # field FIRST, version after: a reader that observes the new version
        # has then necessarily seen (or will re-read) the new field value,
        # so the encoder's read-version-then-fields protocol can only ever
        # over-invalidate, never record a fresh version over a stale field
        object.__setattr__(self, name, value)
        if name != "_version" and name != "last_pod_event":
            object.__setattr__(self, "_version", getattr(self, "_version", 0) + 1)
            NODE_WRITE_SEQ.v += 1

    def zone(self) -> str:
        return self.labels.get(lbl.TOPOLOGY_ZONE, "")

    def capacity_type(self) -> str:
        return self.labels.get(lbl.CAPACITY_TYPE, "")

    def instance_type(self) -> str:
        return self.labels.get(lbl.INSTANCE_TYPE_LABEL, "")


#: Bumped by every tracked Node field write, across all clusters.
NODE_WRITE_SEQ = _Seq()


class Cluster:
    """Thread-safe store of claims, nodes and pods (the reference's
    ``state.Cluster`` without its journal, indexes and observers)."""

    def __init__(self):
        self._lock = threading.RLock()
        self.nodeclaims: dict[str, NodeClaim] = {}
        self.nodes: dict[str, Node] = {}
        self.pods: dict[str, Pod] = {}

    def apply(self, obj) -> None:
        with self._lock:
            if isinstance(obj, NodeClaim):
                self.nodeclaims[obj.name] = obj
            elif isinstance(obj, Node):
                self.nodes[obj.name] = obj
            elif isinstance(obj, Pod):
                self.pods[obj.uid] = obj
            else:
                raise TypeError(f"unknown object {type(obj)}")

    def bind_pod(self, pod_uid: str, node_name: str, now: float = 0.0) -> None:
        with self._lock:
            pod = self.pods[pod_uid]
            pod.node_name = node_name
            pod.phase = "Running"
            node = self.nodes.get(node_name)
            if node is not None:
                node.last_pod_event = max(node.last_pod_event, now)

    def pods_by_node(self) -> dict[str, list[Pod]]:
        """node name -> bound pods, in ONE locked pass over the pod store."""
        out: dict[str, list[Pod]] = {}
        with self._lock:
            for p in self.pods.values():
                if p.node_name:
                    out.setdefault(p.node_name, []).append(p)
        return out

    def snapshot_nodes(self) -> list[Node]:
        with self._lock:
            return list(self.nodes.values())

    def snapshot_claims(self) -> list[NodeClaim]:
        with self._lock:
            return list(self.nodeclaims.values())
