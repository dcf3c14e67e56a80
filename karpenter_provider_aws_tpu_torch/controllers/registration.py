"""Registration controller: launched NodeClaims -> ready Nodes -> bound pods.

Stands in for the kubelet + core NodeClaim lifecycle controllers
(SURVEY.md section 2.2 "NodePool/NodeClaim lifecycle"): a launched claim
registers a Node carrying the claim's labels, flips Registered/Initialized,
clears startup taints, and binds nominated pods (the fake analogue of
kube-scheduler honoring the provisioner's nomination).
"""

from __future__ import annotations

from typing import Optional

from ..models import labels as lbl
from ..state.cluster import Cluster, Node
from ..utils.clock import Clock, RealClock


class RegistrationController:
    name = "registration"
    interval_s = 1.0

    def __init__(self, cluster: Cluster, provisioning=None, clock: Optional[Clock] = None):
        self.cluster = cluster
        self.provisioning = provisioning
        self.clock = clock or RealClock()
        self._pass_usage = None  # per-reconcile usage snapshot (see below)
        self._pass_noms = None   # per-reconcile reverse nomination map
        # dirty-set walk state (the change-journal pattern the encoders
        # set): insertion-ordered claim names still needing lifecycle work
        self._watch: dict[str, None] = {}
        self._cursor = None      # (epoch, rev) of the last journal read

    def _watched_claims(self) -> list:
        """The claims a pass must visit, driven off the store's change
        journal instead of an O(claims) condition-check walk per pass
        (the simulator-found per-claim tail): claims enter the watch set
        when the journal names them (apply/launch/delete) and leave once
        fully initialized; claims referenced by this replica's live
        nominations ride along so a nomination landing AFTER a claim
        initialized still binds. Journal overflow / store reset falls
        back to one full rebuild — never a correctness loss."""
        cluster = self.cluster
        epoch = getattr(cluster, "epoch", None)
        rev = getattr(cluster, "rev", None)
        if epoch is None or rev is None:  # foreign store: full walk
            return list(cluster.nodeclaims.values())
        changes = None
        if self._cursor is not None and self._cursor[0] is epoch:
            changes = cluster.changes_since(self._cursor[1])
        if changes is None:
            self._watch = {
                c.name: None
                for c in cluster.snapshot_claims()
                if not c.is_initialized() or c.deleted
            }
        else:
            for name in changes.get("claim", ()):
                self._watch[name] = None
        self._cursor = (epoch, rev)
        noms: set = set()
        if self.provisioning is not None:
            with self.provisioning._nominations_lock:
                noms = set(self.provisioning.nominations.values())
        out = []
        for name in list(self._watch):
            claim = cluster.nodeclaims.get(name)
            if claim is None or claim.deleted or (
                claim.is_initialized() and name not in noms
            ):
                # settled (or gone): out of the watch set — a later
                # nomination re-reaches it through ``noms`` below, and a
                # later store mutation re-journals it
                del self._watch[name]
                if claim is None or claim.deleted:
                    continue
            out.append(claim)
        seen = {c.name for c in out}
        for name in sorted(noms - seen):
            claim = cluster.nodeclaims.get(name)
            if claim is not None and not claim.deleted:
                out.append(claim)
        return out

    def reconcile(self) -> None:
        from ..operator import sharding

        observer = getattr(self.cluster, "observer", None)
        # one usage snapshot per pass, shared by every claim's nomination
        # binding and decremented as binds land: recomputing the O(pods)
        # node_usage scan per newly-registered claim made registration a
        # ~1s/pass controller on a consolidating 10k-node fleet (each
        # replacement wave re-scanned the store per claim)
        self._pass_usage = None
        # reverse nomination map, built once per pass: scanning the whole
        # nominations dict per claim was O(claims x nominations)
        self._pass_noms = None
        # names of claims THIS replica nominated pods onto: the launcher
        # keeps binding its nominations even when the claim's partition
        # landed with another replica (binds are store writes the fencing
        # layer doesn't gate; a pod uid lives in exactly one replica's
        # nomination map, so pods-bound-once holds across replicas)
        self_nominated: set = set()
        if self.provisioning is not None and sharding.current() is not None:
            with self.provisioning._nominations_lock:
                self_nominated = set(self.provisioning.nominations.values())
        for claim in self._watched_claims():
            if claim.deleted or not claim.is_launched():
                continue
            if not sharding.owns_claim(self.cluster, claim):
                # not ours to register — but bind our own nominations once
                # its real owner has brought the node up
                if claim.name in self_nominated and claim.is_registered():
                    self._bind_nominated(claim)
                continue
            if not claim.is_registered():
                # registration: node joins carrying pool taints + startup
                # taints (the reference injects startupTaints at launch)
                node = Node(
                    name=f"node-{claim.name}",
                    provider_id=claim.status.provider_id,
                    nodepool_name=claim.nodepool_name,
                    nodeclaim_name=claim.name,
                    labels=dict(claim.labels),
                    annotations=dict(claim.annotations),
                    taints=list(claim.taints) + list(claim.startup_taints),
                    capacity=claim.status.capacity,
                    allocatable=claim.status.allocatable,
                    internal_ip=claim.status.internal_ip,
                    ready=True,
                    created_at=self.clock.now(),
                )
                node.labels[lbl.HOSTNAME] = node.name
                self.cluster.apply(node)
                claim.status.node_name = node.name
                claim.status.set_condition("Registered", True)
                if observer is not None:
                    # condition flips happen on the live object, outside
                    # Cluster methods — notify the lifecycle SLI directly
                    observer.claim_registered(claim, now=self.clock.now())
            if not claim.is_initialized():
                # initialization: startup taints are expected to be cleared
                # by their owners (CNI etc.); the fake kubelet clears them
                # here, leaving only the permanent pool taints.
                node = self.cluster.nodes.get(claim.status.node_name)
                if node is not None:
                    startup = {(t.key, t.value, t.effect) for t in claim.startup_taints}
                    node.taints = [
                        t for t in node.taints if (t.key, t.value, t.effect) not in startup
                    ]
                claim.status.set_condition("Initialized", True)
                if observer is not None:
                    observer.claim_ready(claim, now=self.clock.now())
            self._bind_nominated(claim)

    def _bind_nominated(self, claim) -> None:
        if self.provisioning is None:
            return
        node_name = claim.status.node_name
        node = self.cluster.nodes.get(node_name)
        with self.provisioning._nominations_lock:
            if self._pass_noms is None:
                self._pass_noms = {}
                for uid, claim_name in self.provisioning.nominations.items():
                    self._pass_noms.setdefault(claim_name, []).append(uid)
            # nominations added to the live dict AFTER this pass's snapshot
            # (e.g. a replacement launched mid-pass) are not visible until
            # the NEXT reconcile rebuilds it — a one-interval bind deferral
            # for those pods, traded for dropping the O(claims x
            # nominations) live scan; the liveness re-check below guards
            # against binding a nomination pruned since the snapshot
            mine = [
                uid for uid in self._pass_noms.pop(claim.name, [])
                if self.provisioning.nominations.get(uid) == claim.name
            ]
            for uid in mine:
                del self.provisioning.nominations[uid]
        if node is None or not mine:
            # no nominations for this claim: skip the O(pods) usage scan —
            # paying it per REGISTERED claim per pass made registration the
            # dominant controller at fleet scale (the fleet simulator's
            # first attribution finding)
            return
        # Free-capacity check mirroring provisioning._apply_binds: a
        # nomination is a hint, not a reservation — binding past allocatable
        # would overcommit the node (e.g. a replace sized only for overflow).
        # Pods that don't fit stay pending and re-enter the next solve.
        if self._pass_usage is None:
            self._pass_usage = self.cluster.node_usage()
        used = self._pass_usage.get(node_name)
        free = node.allocatable.v - (used if used is not None else 0)
        for uid in mine:
            pod = self.cluster.pods.get(uid)
            if pod is None or not pod.is_pending():
                continue
            if (pod.requests.v > free + 1e-6).any():
                continue  # doesn't fit; provisioner re-solves it
            self.cluster.bind_pod(uid, node_name, now=self.clock.now())
            free = free - pod.requests.v
            # keep the shared snapshot honest for later claims this pass
            self._pass_usage[node_name] = (
                self._pass_usage.get(node_name, 0) + pod.requests.v
            )
