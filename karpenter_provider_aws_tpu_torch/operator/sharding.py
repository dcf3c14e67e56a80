"""Sharded control plane: per-partition leases, fencing tokens, ownership.

The single :class:`~.leaderelection.LeaderElector` makes replication
all-or-nothing: one replica owns every nodepool and a leader loss idles
the whole fleet for up to a lease TTL. This module generalizes it into a
**sharded lease layer** (designs/sharded-control-plane.md):

- **Partition leases.** Replicas contend for one lease per cluster
  partition, keyed on the store's stable ``(nodepool, zone)`` index
  (``Cluster.partition_key`` — the same key the partitioned encoder
  chains and the sharded screen/solve already shard by), plus one
  ``GLOBAL`` lease owning the unpartitioned work: the interruption
  queue, objects whose partition cannot be determined, and the
  work-stealing GLOBAL pod queue. Pending pods themselves are ROUTED,
  not GLOBAL-owned (:func:`pod_partition` / :func:`split_pending`,
  designs/sharded-provisioning.md): partition-pinned pods solve on
  their partition's lease holder, unpinned pods through the fenced
  queue on the lease host.
- **Fencing tokens.** Every lease carries a monotonic fencing token that
  bumps on every holder change (``CloudBackend.try_acquire_lease_fenced``;
  the fake hosts it the way a real control-plane store would). The token
  is stamped into every cloud-side write a replica makes under that lease
  (launch via ``LaunchRequest.fence``, terminate via per-id fences), and
  the store REJECTS any write carrying a token older than the lease's
  current one — a deposed leader's in-flight writes bounce off the cloud
  instead of racing the successor (``StaleFencingTokenError``,
  ``karpenter_fenced_writes_rejected_total``).
- **Ownership scope.** The :class:`~..controllers.base.Manager` wraps
  every reconcile in an ambient :func:`scope` carrying the replica's
  current :class:`Ownership` snapshot. Controllers filter their work
  through :func:`owns_key` / :func:`owns_claim` / :func:`owns_node` /
  :func:`owns_global`; with no ambient scope (single-replica deployments,
  every existing test) the predicates answer True and nothing changes.
- **Rebalancing + handoff barrier.** Desired ownership is rendezvous
  (highest-random-weight) hashing of partition keys over the live member
  set — deterministic, minimal movement on membership change. A replica
  acquires a partition only once the previous lease has expired (the CAS
  enforces that) and then ADOPTS the partition's unsettled claims —
  launched-but-unregistered NodeClaims whose previous owner died mid
  lifecycle — exactly once, at the acquire edge, extending the
  pods-bound-once invariant across replicas.

Chaos proves the invariants instead of asserting them:
``chaos/scenarios/replica-loss.json`` kills / pauses / netsplits a
replica mid-spot-storm and the ``no-double-launch`` /
``no-orphaned-claims`` / ``leases-partition-the-fleet`` invariants close
the run (chaos/invariants.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
from dataclasses import dataclass, field
from typing import Optional

from ..utils.clock import Clock

log = logging.getLogger("karpenter.tpu.sharding")

#: sentinel partition key for the unpartitioned scope (pending pods, the
#: interruption queue, objects with no resolvable partition)
GLOBAL_KEY: tuple = ("__global__", "")

LEASE_PREFIX = "karpenter-shard"
MEMBER_PREFIX = "karpenter-shard-member"

SHARD_TTL_S = 15.0
# same shape as leaderelection.RENEW_DEADLINE_FRACTION: a replica stops
# acting on a lease strictly before the lease host would let a contender
# steal it
RENEW_DEADLINE_FRACTION = 2.0 / 3.0


def lease_name(key: tuple) -> str:
    return LEASE_PREFIX + "/" + "/".join(str(k) for k in key)


def rendezvous_owner(key: tuple, members: list[str]) -> Optional[str]:
    """Highest-random-weight owner of ``key`` among ``members``:
    deterministic, and a membership change moves only the partitions the
    joining/leaving replica wins/loses (minimal reshuffle)."""
    if not members:
        return None
    token = "/".join(str(k) for k in key)
    return max(
        members,
        key=lambda m: (
            hashlib.sha256(f"{token}@{m}".encode()).hexdigest(), m
        ),
    )


# -- ambient ownership -------------------------------------------------------

@dataclass(frozen=True)
class Ownership:
    """One replica's point-in-time lease holdings: partition key ->
    fencing token. Immutable — a controller pass runs against the
    snapshot taken when the pass started, and a snapshot that goes stale
    mid-pass is exactly what the cloud-side fencing check exists for."""

    replica: str
    keys: dict = field(default_factory=dict)   # partition key -> token

    def holds(self, key: tuple) -> bool:
        return key in self.keys

    def fence(self, key: tuple) -> Optional[tuple]:
        """(lease name, token) for stamping a write sanctioned by
        ``key``'s lease; None when this replica does not hold it."""
        token = self.keys.get(key)
        if token is None:
            return None
        return (lease_name(key), token)


_AMBIENT = threading.local()


@contextlib.contextmanager
def scope(ownership: Optional[Ownership]):
    """Ambient ownership for the current thread (the Manager enters this
    around every reconcile when a ShardElector is wired)."""
    prev = getattr(_AMBIENT, "own", None)
    _AMBIENT.own = ownership
    try:
        yield ownership
    finally:
        _AMBIENT.own = prev


def current() -> Optional[Ownership]:
    return getattr(_AMBIENT, "own", None)


@contextlib.contextmanager
def sanction(key: Optional[tuple]):
    """Name the partition lease sanctioning the cloud writes inside this
    block (e.g. a consolidation replacement launch is sanctioned by the
    OLD node's partition lease, wherever the new node lands)."""
    prev = getattr(_AMBIENT, "sanction", None)
    _AMBIENT.sanction = key
    try:
        yield
    finally:
        _AMBIENT.sanction = prev


def current_sanction() -> Optional[tuple]:
    """The ambient :func:`sanction` key for the current thread (None when
    no explicit sanction is in force) — captured by callers that hand
    work to other threads (the provisioner's launch pool) so the fencing
    resolution is identical whichever thread runs the write."""
    return getattr(_AMBIENT, "sanction", None)


def owns_global() -> bool:
    own = current()
    if own is None:
        return True
    return own.holds(GLOBAL_KEY)


# -- pending-pod routing (sharded provisioning) ------------------------------

#: name of the work-stealing queue for truly global pending pods on the
#: lease host (designs/sharded-provisioning.md)
WORK_QUEUE = "karpenter-global-pods"


def _pinned_value(value_set) -> Optional[str]:
    """The single label value a requirement ValueSet pins its key to, or
    None (unconstrained / complement / multi-valued sets don't pin)."""
    if value_set is None or value_set.complement:
        return None
    if len(value_set.values) != 1:
        return None
    return next(iter(value_set.values))


def pod_partition(pod, nodepools=None) -> Optional[tuple]:
    """The FEASIBLE (nodepool, zone) partition a pending pod's required
    constraints pin it to, or None (a truly global pod).

    A pod is partition-pinned iff its nodeSelector + required node
    affinity constrain ``topology.kubernetes.io/zone`` to exactly one
    zone AND the nodepool is determined — either pinned by a
    ``karpenter.sh/nodepool`` selector or unambiguous because the cluster
    runs exactly one nodepool. The rule is a pure function of the pod
    spec (plus the stable nodepool list), so every replica routes every
    pod identically — the property the ownership split relies on."""
    from ..models import labels as lbl

    reqs = pod.requirements()
    zone = _pinned_value(reqs.get(lbl.TOPOLOGY_ZONE))
    if not zone:
        return None
    pool = _pinned_value(reqs.get(lbl.NODEPOOL))
    if not pool:
        pools = list(nodepools or ())
        if len(pools) != 1:
            return None
        pool = getattr(pools[0], "name", pools[0])
    return (str(pool), str(zone))


def routes_here(pod, nodepools=None, own: Optional[Ownership] = None) -> bool:
    """Does this replica own ``pod``'s provisioning/binding work? The ONE
    routing predicate both the provisioner's split and the host binder
    filter through — the no-double-bind guarantee rests on every replica
    routing every pod identically, so the rule must not be re-derived at
    call sites. Pinned pods route to their partition's holder; unpinned
    (or unleased-partition) pods to the GLOBAL holder; no ownership
    scope means single-replica — everything routes here."""
    own = own if own is not None else current()
    if own is None:
        return True
    key = pod_partition(pod, nodepools)
    if key is None or key not in _known_keys(own):
        return own.holds(GLOBAL_KEY)
    return own.holds(key)


def split_pending(pods, nodepools=None, own: Optional[Ownership] = None):
    """Route a pending-pod list through the ownership snapshot:
    ``(local, global_pods, foreign)`` where ``local`` maps each OWNED
    partition key to its pinned pods, ``global_pods`` are the unpinned
    (or unleased-partition) pods that flow through the work-stealing
    GLOBAL queue, and ``foreign`` are pods pinned to partitions another
    replica owns (skipped here; their owner solves them).

    With no ownership (single-replica), everything lands in
    ``global_pods`` — the unchanged legacy path."""
    own = own if own is not None else current()
    local: dict[tuple, list] = {}
    global_pods: list = []
    foreign: list = []
    if own is None:
        return {}, list(pods), []
    known = _known_keys(own)
    for pod in pods:
        key = pod_partition(pod, nodepools)
        if key is None or key not in known:
            # unpinned, or pinned to a partition no elector has contended
            # yet: GLOBAL scope (same fall-through as owns_key)
            global_pods.append(pod)
        elif own.holds(key):
            local.setdefault(key, []).append(pod)
        else:
            foreign.append(pod)
    return local, global_pods, foreign


def steal_fence(own: Optional[Ownership] = None) -> Optional[tuple]:
    """The (key, (lease name, token)) pair sanctioning this replica's
    claims against the GLOBAL work queue: the GLOBAL lease when held,
    else the replica's first held partition lease (lease-name order, so
    the choice is stable across passes). None when the replica holds
    nothing — a lease-less replica must not touch the queue."""
    own = own if own is not None else current()
    if own is None:
        return None
    if own.holds(GLOBAL_KEY):
        return (GLOBAL_KEY, own.fence(GLOBAL_KEY))
    for key in sorted(own.keys, key=lease_name):
        return (key, own.fence(key))
    return None


def owns_key(key: Optional[tuple]) -> bool:
    """Does this replica own partition ``key``? ``None`` and keys no
    elector has contended yet (a brand-new pool/zone's first node) fall
    to the GLOBAL owner, so no object is orphaned between a partition
    appearing and its lease being contended."""
    own = current()
    if own is None:
        return True
    if key is None:
        return own.holds(GLOBAL_KEY)
    return own.holds(key) or (
        key not in _known_keys(own) and own.holds(GLOBAL_KEY)
    )


def _partition_of_claim(cluster, claim) -> Optional[tuple]:
    """The partition a claim's work routes to: its backing node's router
    mapping when registered, else the (nodepool, zone-label) pair when the
    launch pinned a zone, else None (global)."""
    node_name = getattr(getattr(claim, "status", None), "node_name", "")
    if node_name:
        key = cluster.partition_of(node_name)
        if key is not None:
            return key
    from ..models import labels as lbl

    zone = claim.labels.get(lbl.TOPOLOGY_ZONE, "")
    if zone:
        return (claim.nodepool_name, zone)
    return None


def owns_claim(cluster, claim) -> bool:
    own = current()
    if own is None:
        return True
    key = _partition_of_claim(cluster, claim)
    if key is None:
        return own.holds(GLOBAL_KEY)
    return own.holds(key) or (
        # unleased partition (no replica has contended it yet) falls to
        # the global owner — checked against the elector's known-key set
        key not in _known_keys(own) and own.holds(GLOBAL_KEY)
    )


def owns_node(cluster, node) -> bool:
    own = current()
    if own is None:
        return True
    key = cluster.partition_of(node.name)
    if key is None:
        from ..state.cluster import Cluster

        key = Cluster.partition_key(node)
    return own.holds(key) or (
        key not in _known_keys(own) and own.holds(GLOBAL_KEY)
    )


def _known_keys(own: Ownership) -> frozenset:
    return getattr(own, "_known", frozenset())


def write_fence(cluster=None, claim=None, key: Optional[tuple] = None):
    """The (lease name, token) to stamp into a cloud write, resolved from
    the ambient ownership: an explicit ``key``, the ambient
    :func:`sanction` key, the claim's partition, or the GLOBAL lease —
    whichever this replica holds, in that order. ``None`` when no
    sharding is active (single-replica: writes are unfenced).

    A replica whose snapshot no longer matches the cloud (deposed while a
    pass was in flight) still stamps its OLD token here — that is the
    point: the cloud rejects it."""
    own = current()
    if own is None:
        return None
    candidates = []
    if key is not None:
        candidates.append(key)
    sk = getattr(_AMBIENT, "sanction", None)
    if sk is not None:
        candidates.append(sk)
    if claim is not None and cluster is not None:
        ck = _partition_of_claim(cluster, claim)
        if ck is not None:
            candidates.append(ck)
    candidates.append(GLOBAL_KEY)
    for k in candidates:
        f = own.fence(k)
        if f is not None:
            return f
    # held nothing relevant: stamp the first candidate with a token the
    # cloud has certainly superseded (explicitly stale — never silent)
    return (lease_name(candidates[0]), 0)


# -- the sharded elector -----------------------------------------------------


class ShardElector:
    """The sharded elector (per-partition leases, rendezvous rebalancing,
    adoption) of the JAX package's ``operator/sharding.py``. This package
    runs one replica: with no elector every predicate above answers what the
    reference answers for one replica, and constructing one raises."""

    name = "sharding"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the sharded elector (N-replica control plane) is not supported by this package yet"
        )
