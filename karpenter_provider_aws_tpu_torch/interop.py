"""Build this package's solve and screen inputs from the JAX package's plain
numpy fields.

Tests feed both packages the very same tensors through these functions; they
take numpy arrays only, so this package never imports the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .ops.consolidate import ClusterTensors, ZoneConstraint
from .ops.encode import EncodedProblem
from .ops.ffd import _State, pack_window_bits

#: the numpy fields of ``EncodedProblem``, in both packages
ARRAY_FIELDS = (
    "requests", "counts", "compat", "capacity", "price", "group_window",
    "type_window", "group_zone_allowed", "group_captype_allowed",
    "max_per_node", "atomic", "type_exotic",
)


def problem_from_reference(
    arrays: Mapping[str, np.ndarray],
    group_pods: Sequence[list] = (),
    type_names: Sequence[str] = (),
    zones: Sequence[str] = (),
    nodepool=None,
) -> EncodedProblem:
    """This package's ``EncodedProblem`` from the JAX package's array fields
    (``ARRAY_FIELDS``, each copied)."""
    missing = [f for f in ARRAY_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing problem fields: {missing}")
    fields = {
        f: None if arrays[f] is None else np.array(arrays[f], copy=True)
        for f in ARRAY_FIELDS
    }
    return EncodedProblem(
        group_pods=[list(p) for p in group_pods],
        type_names=tuple(type_names),
        zones=tuple(zones),
        nodepool=nodepool,
        **fields,
    )


def state_from_reference(
    node_type: np.ndarray,     # [N] int
    node_price: np.ndarray,    # [N] float
    used: np.ndarray,          # [N, R] float
    node_cap: np.ndarray,      # [N, R] float
    node_window: np.ndarray,   # [N, Z, C] bool
    n_open: int,
    *,
    device,
) -> _State:
    """An ``ops.ffd._State`` of pre-opened rows from the JAX package's
    ``_State`` fields; the window becomes this package's bitmask."""
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    return _State(
        node_type=t(node_type, np.int32),
        node_price=t(node_price, np.float32),
        used=t(used, np.float32),
        node_cap=t(node_cap, np.float32),
        node_window=t(pack_window_bits(node_window), np.int32),
        n_open=torch.tensor(int(n_open), dtype=torch.int32, device=device),
    )


#: the numpy fields of ``ClusterTensors``, in both packages
CLUSTER_ARRAY_FIELDS = (
    "free", "price", "requests", "group_ids", "group_counts", "compat",
    "disruption_cost", "blocked", "used_total", "group_node_count", "mpn",
    "hn_match", "cap", "node_zone_idx", "node_gang",
)
#: the list fields of ``ClusterTensors`` (plain strings), in both packages
CLUSTER_LIST_FIELDS = ("node_names", "nodepool_names", "node_zone", "zones", "node_captype")


def cluster_tensors_from_reference(fields: Mapping[str, object]) -> ClusterTensors:
    """This package's ``ClusterTensors`` from the JAX package's fields: the
    arrays of ``CLUSTER_ARRAY_FIELDS`` (each copied), the string lists of
    ``CLUSTER_LIST_FIELDS``, and ``zone_constraints`` as one list per group
    of ``(kind, skew, match, selector)`` tuples. ``group_pods`` stays empty:
    the screen and the validator never read it."""
    missing = [f for f in CLUSTER_ARRAY_FIELDS + CLUSTER_LIST_FIELDS + ("zone_constraints",)
               if f not in fields]
    if missing:
        raise KeyError(f"missing cluster fields: {missing}")
    arrays = {f: np.array(fields[f], copy=True) for f in CLUSTER_ARRAY_FIELDS}
    lists = {f: list(fields[f]) for f in CLUSTER_LIST_FIELDS}
    zone_constraints = [
        [ZoneConstraint(kind=str(kind), skew=int(skew), match=np.array(match, dtype=bool),
                        selector=None if selector is None else dict(selector))
         for kind, skew, match, selector in cons]
        for cons in fields["zone_constraints"]
    ]
    return ClusterTensors(group_pods=[], zone_constraints=zone_constraints, **arrays, **lists)


def cluster_from_reference(snapshot: Mapping[str, Sequence[Mapping]], cluster=None):
    """This package's ``state.Cluster`` in the state of a JAX package store,
    from plain Python and numpy data (the caller reads it off the reference
    ``Cluster``), applied in the order node pools, node classes, claims,
    nodes, pods, then each bound pod bound. ``cluster`` (a fresh store, for
    example an environment's) is filled and returned; by default a new one.

    ``snapshot`` holds lists of dicts:

    - ``nodepools``: ``name``, ``nodeclass_name``, ``requirements`` as
      (key, operator value, values) triples, ``labels``, ``annotations``,
      ``taints`` as (key, value, effect), ``weight``, and ``disruption``
      when given: ``consolidation_policy``, ``consolidate_after_s``,
      ``expire_after_s`` and ``budgets`` (each a string, or a (nodes,
      reasons, schedule, duration_s) tuple);
    - ``nodeclasses``: ``name``, ``role``;
    - ``claims``: ``name``, ``nodepool_name``, ``nodeclass_name``,
      ``labels``, ``annotations``, the ``instance_type_options``,
      ``zone_options`` and ``capacity_type_options``, ``provider_id``,
      ``node_name``, ``capacity`` and ``allocatable`` (resource vectors),
      ``conditions`` (the names of the true conditions);
    - ``nodes``: ``name``, ``provider_id``, ``nodepool_name``,
      ``nodeclaim_name``, ``labels``, ``capacity``, ``allocatable``,
      ``ready``, ``cordoned``;
    - ``pods``: ``name``, ``requests`` (a resource vector), ``labels``,
      ``node_selector``, ``node_name`` (empty when pending).
    """
    from .models.nodeclaim import NodeClaim
    from .models.nodeclass import NodeClass
    from .models.nodepool import Budget, Disruption, NodePool, Taint
    from .models.pod import Pod
    from .models.requirements import Operator, Requirement
    from .models.resources import ResourceVector
    from .state.cluster import Cluster, Node

    cluster = Cluster() if cluster is None else cluster

    def vec(a):
        return ResourceVector(np.array(a, dtype=np.float32, copy=True))

    for p in snapshot.get("nodepools", ()):
        cluster.apply(NodePool(
            name=p["name"], nodeclass_name=p.get("nodeclass_name", "default"),
            requirements=[Requirement(k, Operator(op), tuple(v))
                          for k, op, v in p.get("requirements", ())],
            labels=dict(p.get("labels", {})), annotations=dict(p.get("annotations", {})),
            taints=[Taint(k, v, e) for k, v, e in p.get("taints", ())],
            weight=int(p.get("weight", 0)),
            **({"disruption": Disruption(
                consolidation_policy=d["consolidation_policy"],
                consolidate_after_s=d["consolidate_after_s"],
                expire_after_s=d["expire_after_s"],
                budgets=[b if isinstance(b, str) else Budget(nodes=b[0], reasons=tuple(b[1]),
                                                             schedule=b[2], duration_s=b[3])
                         for b in d["budgets"]],
            )} if (d := p.get("disruption")) is not None else {}),
        ))
    for nc in snapshot.get("nodeclasses", ()):
        cluster.apply(NodeClass(name=nc["name"], role=nc.get("role", "")))
    for c in snapshot.get("claims", ()):
        claim = NodeClaim(
            name=c["name"], nodepool_name=c["nodepool_name"],
            nodeclass_name=c.get("nodeclass_name", "default"),
            labels=dict(c.get("labels", {})), annotations=dict(c.get("annotations", {})),
            instance_type_options=list(c.get("instance_type_options", ())),
            zone_options=list(c.get("zone_options", ())),
            capacity_type_options=list(c.get("capacity_type_options", ())),
        )
        claim.status.provider_id = c.get("provider_id", "")
        claim.status.node_name = c.get("node_name", "")
        claim.status.capacity = vec(c["capacity"])
        claim.status.allocatable = vec(c["allocatable"])
        for cond in c.get("conditions", ()):
            claim.status.set_condition(cond, True)
        cluster.apply(claim)
    for n in snapshot.get("nodes", ()):
        cluster.apply(Node(
            name=n["name"], provider_id=n.get("provider_id", ""),
            nodepool_name=n.get("nodepool_name", ""),
            nodeclaim_name=n.get("nodeclaim_name", ""), labels=dict(n.get("labels", {})),
            capacity=vec(n["capacity"]), allocatable=vec(n["allocatable"]),
            ready=bool(n.get("ready", False)), cordoned=bool(n.get("cordoned", False)),
        ))
    bound = []
    for p in snapshot.get("pods", ()):
        pod = Pod(name=p["name"], requests=vec(p["requests"]), labels=dict(p.get("labels", {})),
                  node_selector=dict(p.get("node_selector", {})))
        cluster.apply(pod)
        if p.get("node_name"):
            bound.append((pod.uid, p["node_name"]))
    for uid, node_name in bound:
        cluster.bind_pod(uid, node_name)
    return cluster
