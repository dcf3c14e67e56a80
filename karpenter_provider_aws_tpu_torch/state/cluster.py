"""The Cluster store + Node model.

The JAX package's ``state/cluster.py``: every mutation through the store's
methods bumps a monotonic revision and appends to a bounded change journal,
which the incremental cluster encoder reads, and routes to the (nodepool,
zone) partition it dirties, whose own journal the partitioned encoder
(``ops/encode_partition.py``) reads. The partition views (``partition_*``)
name each node's partition, the journal entries routed there, and what
moved in one partition since a revision.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..models import labels as lbl
from ..models.nodeclaim import NodeClaim
from ..models.nodeclass import NodeClass
from ..models.nodepool import NodePool
from ..models.pdb import PodDisruptionBudget
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


# Bounded change-journal length: at the production reconcile cadence this
# covers thousands of mutations between encode passes; overflow simply
# forces one full re-encode (never a correctness loss). This is the FLOOR
# of the journal ladder — the store regrows its journals on a power-of-two
# ladder as the object population grows (see ``journal_cap_for``), so a
# 100k-node / 1M-pod store keeps enough window for steady 1% churn between
# passes to stay incremental.
JOURNAL_CAP = 4096

#: absolute journal ceiling (~entries; a tuple is ~100B, so the worst case
#: is ~400MB of journal across a multi-million-object store — past this the
#: full re-encode is cheaper than the window anyway)
JOURNAL_CAP_MAX = 1 << 22


def journal_cap_for(n_objects: int, floor: int = JOURNAL_CAP) -> int:
    """Journal cap on the power-of-two ladder: ~4 entries of headroom per
    tracked object, so a full churn sweep of the population fits in the
    window several times over before an overflow forces a rebuild."""
    cap = floor
    while cap < 4 * n_objects and cap < JOURNAL_CAP_MAX:
        cap *= 2
    return cap


class _Journal:
    """Bounded change journal with O(log n + k) reads.

    Entries are ``(rev, kind, name)`` with strictly increasing ``rev``, so
    ``since(rev)`` bisects to the first newer entry instead of scanning the
    whole window — at 100k nodes the partition windows ladder up to ~1M
    entries and a full-deque filter per consumer per pass was the dominant
    steady-state patch cost. Keeps deque(maxlen=cap) eviction semantics
    exactly: appending past ``maxlen`` drops the single oldest entry
    (amortized O(1) via a head offset compacted in bulk)."""

    __slots__ = ("maxlen", "_buf", "_revs", "_start")

    def __init__(self, iterable=(), maxlen: int = JOURNAL_CAP):
        self.maxlen = maxlen
        self._buf: list[tuple] = list(iterable)[-maxlen:]
        self._revs: list[int] = [e[0] for e in self._buf]
        self._start = 0

    def __len__(self) -> int:
        return len(self._buf) - self._start

    def __iter__(self):
        return iter(self._buf[self._start:])

    def __getitem__(self, i):
        if i < 0:
            return self._buf[i]
        return self._buf[self._start + i]

    def append(self, entry: tuple) -> None:
        if len(self._buf) - self._start >= self.maxlen:
            self._start += 1
            if self._start >= self.maxlen:  # amortized front compaction
                del self._buf[: self._start]
                del self._revs[: self._start]
                self._start = 0
        self._buf.append(entry)
        self._revs.append(entry[0])

    def since(self, rev: int) -> list[tuple]:
        """Entries with revision strictly greater than ``rev``, oldest
        first. Callers check their cursor against ``evicted_rev`` BEFORE
        calling (exactly as they did when this was a deque scan)."""
        lo = bisect_right(self._revs, rev, self._start)
        return self._buf[lo:]


class _Partition:
    """Per-partition change journal + revision bookkeeping (see Cluster).

    Entries carry the cluster's GLOBAL revision numbers, so one consumer
    can mix global and per-partition reads; ``rev`` is the newest global
    revision routed to this partition (cheap "did partition p change since
    rev r" checks without touching the journal)."""

    __slots__ = ("key", "rev", "journal", "evicted_rev", "nodes")

    def __init__(self, key: tuple, cap: int = 1024):
        self.key = key
        self.rev = 0
        self.journal: _Journal = _Journal(maxlen=cap)
        self.evicted_rev = 0  # newest global rev lost to the cap
        self.nodes = 0        # live node count (journal-ladder input)


#: Bumped by every tracked Node field write, across all clusters. The
#: incremental encoder snapshots it per pass: unchanged means NO node
#: attribute anywhere was touched, so the defensive per-row version scan
#: (which exists only to catch direct writes that bypass Cluster methods)
#: can be skipped entirely that pass.
NODE_WRITE_SEQ = _Seq()


class Cluster:
    """Thread-safe object store with the handful of indexed views the
    controllers need. All mutation goes through methods so tests can observe
    ordering; watches are replaced by level-triggered re-listing.

    Every mutation bumps a monotonic revision ``rev`` and appends a
    ``(rev, kind, name)`` entry to a bounded change journal. Consumers that
    keep derived snapshots (the incremental cluster/problem encoders, the
    zone-occupancy cache) call :meth:`changes_since` to learn exactly what
    moved since their snapshot revision — or that the journal rolled over
    and a full rebuild is due. For pods, ``name`` is the affected NODE name
    (bind/unbind journal the node whose tensors the change dirties; pending
    pods journal ``""``)."""

    def __init__(self, clock=None):
        self.clock = clock
        self._lock = threading.RLock()
        # Lifecycle observer (obs/sli.py LifecycleSLI): the sanctioned
        # mutation surface notifies it of pod/claim transitions. Preserved
        # across Environment.reset (which re-runs __init__ on the same
        # object) — the obs bundle outlives a store wipe and resets itself.
        self.observer = getattr(self, "observer", None)
        self.nodepools: dict[str, NodePool] = {}
        self.nodeclasses: dict[str, NodeClass] = {}
        self.nodeclaims: dict[str, NodeClaim] = {}
        self.nodes: dict[str, Node] = {}
        self.pods: dict[str, Pod] = {}
        self.pdbs: dict[str, PodDisruptionBudget] = {}
        # Control-plane version surfaced to the version provider (parity:
        # the discovery client behind version.go; fakes set this directly).
        self.server_version: str = "1.29"
        # Monotonic claim-store version: bumps on any nodeclaim add/remove/
        # provider-id change, so derived snapshots can cache per version.
        self.claims_seq: int = 0
        # Monotonic store revision + bounded change journal (see class doc).
        self.rev: int = 0
        self._journal: _Journal = _Journal(maxlen=JOURNAL_CAP)
        self._journal_evicted_rev: int = 0  # newest rev lost to the cap
        # Stable (nodepool, zone) partition index: every node maps to one
        # partition, and journal entries route to the partition(s) they
        # dirty IN ADDITION to the global journal. Per-partition revision
        # counters + journals let one churning zone stay incremental for
        # every other partition (ops/encode_partition.py), and the sharded
        # screen/solve paths shard the partition axis across devices.
        self._partitions: dict[tuple, _Partition] = {}
        self._node_part: dict[str, tuple] = {}  # node name -> partition key
        # Claim entries the router cannot place (no bound node yet) go to
        # ONE shared claims journal instead of broadcasting into every
        # partition's journal: a pending-claim storm (a big scale-up) must
        # not roll every quiet partition's window at once — that would be
        # the synchronized full-re-encode cliff the partition split exists
        # to remove. Capped on its own ladder over the claim population.
        self._claims_journal: _Journal = _Journal(maxlen=JOURNAL_CAP)
        self._claims_evicted_rev: int = 0
        self._claims_rev: int = 0
        # Epoch token: identifies THIS store incarnation. Environment.reset()
        # re-runs __init__ on the same object, so revision-keyed caches held
        # by other components key on the epoch object identity and can never
        # mistake a reset store (rev back at 0) for their old snapshot.
        self.epoch: object = object()
        # Incrementally-maintained instance-id index (the "indexed views"
        # this class promises): O(1) per mutation, so a 15k-message
        # interruption drain never re-lists the whole claim store per batch.
        self._claims_by_iid: dict[str, NodeClaim] = {}
        self._claim_iid: dict[str, str] = {}  # claim name -> indexed iid
        # Incrementally-maintained bound-pod index, consumed ONLY by
        # pods_on_nodes (the incremental encoder's per-patch fetch): O(1)
        # per sanctioned mutation instead of an O(pods) store scan per
        # encode. pods_by_node()/pods_on_node() intentionally stay full
        # scans — they are the source of truth even for pods whose
        # node_name was mutated outside Cluster methods.
        self._pods_index: dict[str, dict[str, Pod]] = {}  # node -> uid -> Pod
        self._pod_node: dict[str, str] = {}               # uid -> indexed node
        # Incrementally-maintained pending-pod index: pending_pods() is on
        # every provisioning/scheduling tick and was an O(pods) store scan
        # per pass (a quiet 255k-pod controller tick paid two of them). The
        # sanctioned mutation surface keeps it exact; a direct
        # ``pod.phase = ...`` write elsewhere desyncs POD_BIND_SEQ from the
        # snapshot below and forces one full rescan (never a stale answer).
        self._pending_index: dict[str, Pod] = {}
        self._pending_seq: int = -1
        # store-position ordinal per pod uid: ``pending_pods()`` must
        # return STORE (apply) order — the order the legacy full scan
        # produced and provisioning's packing decisions observe — while
        # the pending index itself accretes in pendingness-flip order
        self._pod_ord: dict[str, int] = {}
        self._pod_ord_next: int = 0

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    # -- bound-pod index ---------------------------------------------------
    def _pending_check(self) -> None:
        """Disarm the pending index if a pod ``phase``/``node_name`` write
        happened OUTSIDE the sanctioned surface since the last sync (the
        next ``pending_pods()`` rescans). Every sanctioned pod mutator
        calls this BEFORE its own field writes, so its own bumps are never
        mistaken for foreign ones (callers hold the lock)."""
        from ..models.pod import POD_BIND_SEQ

        if self._pending_seq >= 0 and POD_BIND_SEQ.v != self._pending_seq:
            self._pending_seq = -1
            self._pending_index = {}

    def _index_pod(self, pod: Pod) -> None:
        """Point the bound-pod index (and the pending index) at ``pod``'s
        current binding (callers hold the lock)."""
        from ..models.pod import POD_BIND_SEQ

        target = pod.node_name or ""
        cur = self._pod_node.get(pod.uid)
        if cur is not None and cur != target:
            bucket = self._pods_index.get(cur)
            if bucket is not None:
                bucket.pop(pod.uid, None)
        if target:
            self._pods_index.setdefault(target, {})[pod.uid] = pod
            self._pod_node[pod.uid] = target
        else:
            self._pod_node.pop(pod.uid, None)
        if self._pending_seq >= 0:  # index armed: keep it exact + resynced
            if pod.is_pending():
                self._pending_index[pod.uid] = pod
            else:
                self._pending_index.pop(pod.uid, None)
            self._pending_seq = POD_BIND_SEQ.v

    def _unindex_pod(self, uid: str) -> None:
        from ..models.pod import POD_BIND_SEQ

        cur = self._pod_node.pop(uid, None)
        if cur is not None:
            bucket = self._pods_index.get(cur)
            if bucket is not None:
                bucket.pop(uid, None)
        if self._pending_seq >= 0:
            self._pending_index.pop(uid, None)
            self._pending_seq = POD_BIND_SEQ.v

    # -- change journal ----------------------------------------------------
    @staticmethod
    def partition_key(node: "Node") -> tuple:
        """The stable partition identity of a node: (nodepool, zone)."""
        return (node.nodepool_name, node.zone())

    def _partition(self, key: tuple) -> _Partition:
        part = self._partitions.get(key)
        if part is None:
            part = self._partitions[key] = _Partition(key)
        return part

    def _route(self, part: _Partition, entry: tuple) -> None:
        j = part.journal
        if len(j) == j.maxlen:
            cap = journal_cap_for(8 * max(part.nodes, 1), floor=1024)
            if cap > j.maxlen:
                # ladder regrow BEFORE overflow: the window scales with the
                # partition population instead of silently rolling
                j.maxlen = cap
            else:
                part.evicted_rev = j[0][0]
        j.append(entry)
        part.rev = entry[0]

    def _record(self, kind: str, name: str) -> None:
        """Bump ``rev`` and journal one mutation (callers hold the lock).

        The entry also routes to the partition(s) it dirties: node/pod
        entries to the named node's partition, claim entries to the backing
        node's partition when known (broadcast otherwise — a claim flip the
        router cannot place must dirty every partition, never none).
        Pool/nodeclass/pdb entries stay global-only: the cluster encoder
        ignores them, and partition consumers read them from the store."""
        self.rev += 1
        j = self._journal
        if len(j) == j.maxlen:
            cap = journal_cap_for(len(self.nodes) + len(self.pods))
            if cap > j.maxlen:
                j.maxlen = cap
            else:
                self._journal_evicted_rev = j[0][0]
        entry = (self.rev, kind, name)
        j.append(entry)
        if kind in ("node", "pod"):
            if name:
                pkey = self._node_part.get(name)
                if pkey is None:
                    node = self.nodes.get(name)
                    if node is not None:
                        pkey = self.partition_key(node)
                        self._node_part[name] = pkey
                        self._partition(pkey).nodes += 1
                if pkey is not None:
                    part = self._partition(pkey)
                    self._route(part, entry)
                    if kind == "node":
                        node = self.nodes.get(name)
                        if node is None:
                            # node left the store: route the delete, drop
                            # the mapping so the slot is reclaimable
                            self._node_part.pop(name, None)
                            part.nodes = max(part.nodes - 1, 0)
                        else:
                            cur = self.partition_key(node)
                            if cur != pkey:
                                # a node hopping partitions (pool/zone label
                                # rewrite) dirties BOTH sides
                                self._node_part[name] = cur
                                part.nodes = max(part.nodes - 1, 0)
                                new = self._partition(cur)
                                new.nodes += 1
                                self._route(new, entry)
        elif kind == "claim":
            claim = self.nodeclaims.get(name)
            pkey = None
            if claim is not None and claim.status.node_name:
                pkey = self._node_part.get(claim.status.node_name)
            if pkey is not None:
                self._route(self._partition(pkey), entry)
            else:
                j = self._claims_journal
                if len(j) == j.maxlen:
                    cap = journal_cap_for(len(self.nodeclaims))
                    if cap > j.maxlen:
                        j.maxlen = cap
                    else:
                        self._claims_evicted_rev = j[0][0]
                j.append(entry)
                self._claims_rev = self.rev

    # -- partition views ---------------------------------------------------
    def partition_keys(self) -> list[tuple]:
        """Stable (insertion-ordered) list of known partition keys."""
        with self._lock:
            return list(self._partitions)

    def partition_rev(self, key: tuple) -> int:
        """Newest global revision routed to ``key`` (0 = never touched)."""
        with self._lock:
            part = self._partitions.get(key)
            return part.rev if part is not None else 0

    def partition_of(self, name: str) -> Optional[tuple]:
        """The partition a node's journal entries route to (None =
        unknown). This is the ROUTER mapping, not the node's live labels:
        the partitioned encoder keeps its row ownership consistent with
        entry routing, so a direct label write that 'moves' a node is
        simply re-encoded in place by its owning partition (exactness is
        per-node, not per-partition-assignment)."""
        with self._lock:
            return self._node_part.get(name)

    def partition_nodes(self) -> dict[tuple, set]:
        """Partition key -> set of node names (router view; full-build
        scoping input for the partitioned encoder)."""
        with self._lock:
            out: dict[tuple, set] = {}
            for name, key in self._node_part.items():
                out.setdefault(key, set()).add(name)
            return out

    def note_node_update(self, node: "Node") -> None:
        """Journal an in-place/direct mutation of a stored node. The
        ``Node.__setattr__`` version counter already catches direct writes
        for the encoders' defensive scan; journaling ALSO re-routes the
        partition mapping when the write moved the node across partitions
        (pool/zone label rewrite), dirtying both sides."""
        with self._lock:
            self._record("node", node.name)

    def partition_changes_since(self, key: tuple, rev: int) -> Optional[dict]:
        """Per-partition :meth:`changes_since`: mutations routed to ``key``
        after global revision ``rev`` — plus unplaced claim entries from
        the shared claims journal (every partition must see them) — as
        ``{kind: [names]}``. ``{}`` when nothing relevant moved since
        ``rev``, ``None`` when a bounded journal no longer covers
        ``(rev, now]`` (rebuild that partition)."""
        with self._lock:
            part = self._partitions.get(key)
            part_new = part is not None and part.rev > rev
            claims_new = self._claims_rev > rev
            if not part_new and not claims_new:
                return {}
            if part_new and rev < part.evicted_rev:
                return None
            if claims_new and rev < self._claims_evicted_rev:
                return None
            out: dict[str, list[str]] = {}
            if part_new:
                for _r, kind, name in part.journal.since(rev):
                    out.setdefault(kind, []).append(name)
            if claims_new:
                for _r, _kind, name in self._claims_journal.since(rev):
                    out.setdefault("claim", []).append(name)
            return out

    def changes_since(self, rev: int) -> Optional[dict[str, list[str]]]:
        """Mutations after ``rev`` as ``{kind: [names, in order]}``.

        Returns ``{}`` when nothing changed, and ``None`` when the bounded
        journal no longer covers ``(rev, now]`` (the caller must rebuild
        from scratch). Names repeat in mutation order — consumers that want
        a dirty SET dedup themselves; consumers that care about ordering
        (row allocation mirroring store insertion order) get it."""
        with self._lock:
            if rev == self.rev:
                return {}
            if rev < self._journal_evicted_rev:
                return None
            out: dict[str, list[str]] = {}
            for _r, kind, name in self._journal.since(rev):
                out.setdefault(kind, []).append(name)
            return out

    # -- apply/delete ------------------------------------------------------
    def apply(self, obj) -> None:
        with self._lock:
            if isinstance(obj, NodePool):
                self.nodepools[obj.name] = obj
                self._record("pool", obj.name)
            elif isinstance(obj, NodeClass):
                self.nodeclasses[obj.name] = obj
                self._record("nodeclass", obj.name)
            elif isinstance(obj, NodeClaim):
                self.nodeclaims[obj.name] = obj
                self.claims_seq += 1
                self._index_claim(obj)
                self._record("claim", obj.name)
                if self.observer is not None:
                    self.observer.claim_applied(obj, now=self._now())
            elif isinstance(obj, Node):
                self.nodes[obj.name] = obj
                self._record("node", obj.name)
            elif isinstance(obj, Pod):
                self._pending_check()
                prev = self.pods.get(obj.uid)
                if prev is None:  # dict overwrite keeps store position
                    self._pod_ord[obj.uid] = self._pod_ord_next
                    self._pod_ord_next += 1
                self.pods[obj.uid] = obj
                if prev is not None and prev is not obj and prev.node_name:
                    # replacement may move the binding: both nodes dirty
                    if prev.node_name != obj.node_name:
                        self._record("pod", prev.node_name)
                self._index_pod(obj)
                self._record("pod", obj.node_name or "")
                if self.observer is not None:
                    self.observer.pod_applied(obj, now=self._now())
            elif isinstance(obj, PodDisruptionBudget):
                self.pdbs[obj.name] = obj
                self._record("pdb", obj.name)
            else:
                raise TypeError(f"unknown object {type(obj)}")

    def delete(self, obj) -> None:
        with self._lock:
            if isinstance(obj, NodePool):
                self.nodepools.pop(obj.name, None)
                self._record("pool", obj.name)
            elif isinstance(obj, NodeClass):
                if obj.finalizers:
                    obj.deleted = True  # finalizer semantics: mark, don't drop
                else:
                    self.nodeclasses.pop(obj.name, None)
                self._record("nodeclass", obj.name)
            elif isinstance(obj, NodeClaim):
                if obj.finalizers:
                    # mark-only: membership and provider-id bindings are
                    # unchanged, so claim indexes stay valid (they read the
                    # live `deleted` flag off the shared object)
                    if not obj.deleted:
                        obj.deleted_at = self._now()
                    obj.deleted = True
                else:
                    self.nodeclaims.pop(obj.name, None)
                    self.claims_seq += 1
                    self._unindex_claim(obj)
                    if self.observer is not None:
                        self.observer.claim_gone(obj.name)
                self._record("claim", obj.name)
            elif isinstance(obj, Node):
                self.nodes.pop(obj.name, None)
                self._record("node", obj.name)
            elif isinstance(obj, Pod):
                self._pending_check()
                stored = self.pods.pop(obj.uid, None)
                self._pod_ord.pop(obj.uid, None)
                self._unindex_pod(obj.uid)
                node = self.nodes.get(obj.node_name)
                if node is not None:
                    node.last_pod_event = max(node.last_pod_event, self._now())
                self._record("pod", obj.node_name or "")
                if stored is not None and stored.node_name != obj.node_name:
                    self._record("pod", stored.node_name or "")
                if self.observer is not None:
                    self.observer.pod_deleted(obj.uid)
            elif isinstance(obj, PodDisruptionBudget):
                self.pdbs.pop(obj.name, None)
                self._record("pdb", obj.name)
            else:
                raise TypeError(f"unknown object {type(obj)}")

    def finalize(self, obj) -> None:
        """Remove finalizers and drop the (already deleted-marked) object."""
        with self._lock:
            obj.finalizers.clear()
            if isinstance(obj, NodeClaim):
                self.nodeclaims.pop(obj.name, None)
                self.claims_seq += 1
                self._unindex_claim(obj)
                self._record("claim", obj.name)
                if self.observer is not None:
                    self.observer.claim_gone(obj.name)
            elif isinstance(obj, NodeClass):
                self.nodeclasses.pop(obj.name, None)
                self._record("nodeclass", obj.name)

    def _index_claim(self, claim: NodeClaim) -> None:
        iid = claim.status.provider_id.rsplit("/", 1)[-1]
        old = self._claim_iid.get(claim.name)
        if old is not None and old != iid:
            # The stale entry may hold a *previous object* for this claim
            # name (re-apply builds a new NodeClaim), so match by name, not
            # object identity — otherwise interruption events would resolve
            # the old instance id to a defunct claim.
            prev = self._claims_by_iid.get(old)
            if prev is not None and prev.name == claim.name:
                self._claims_by_iid.pop(old, None)
        if iid:
            self._claims_by_iid[iid] = claim
            self._claim_iid[claim.name] = iid

    def _unindex_claim(self, claim: NodeClaim) -> None:
        iid = self._claim_iid.pop(claim.name, None)
        if iid is not None:
            # Match by name, not object identity: the delete may arrive with
            # a superseded object for this claim name (see _index_claim).
            prev = self._claims_by_iid.get(iid)
            if prev is not None and prev.name == claim.name:
                self._claims_by_iid.pop(iid, None)

    def claim_by_instance_id(self, instance_id: str) -> Optional[NodeClaim]:
        """O(1) lookup of the claim backing a cloud instance (parity: the
        per-batch instance-id map of interruption controller.go:254-292,
        kept fresh incrementally instead of rebuilt by LIST)."""
        with self._lock:
            return self._claims_by_iid.get(instance_id)

    # -- views -------------------------------------------------------------
    def pending_pods(self) -> list[Pod]:
        """Pending (schedulable) pods from the incrementally-maintained
        index: O(pending), not O(pods) — this read is on every
        provisioning/scheduling tick. Rebuilt from a full scan on first use
        and whenever POD_BIND_SEQ says a ``phase``/``node_name`` write
        bypassed the sanctioned surface (see ``_pending_check``)."""
        from ..models.pod import POD_BIND_SEQ

        with self._lock:
            if self._pending_seq < 0 or POD_BIND_SEQ.v != self._pending_seq:
                self._pending_index = {
                    p.uid: p for p in self.pods.values() if p.is_pending()
                }
                self._pending_seq = POD_BIND_SEQ.v
            out = list(self._pending_index.values())
            # STORE order, not index-accretion order: a pod that went
            # pending late (an eviction) must surface at its apply
            # position, exactly where the legacy full scan returned it —
            # provisioning's packing is order-sensitive and the replica
            # chaos envelope is pinned against that order. O(pending).
            out.sort(key=lambda p: self._pod_ord.get(p.uid, 1 << 62))
            return out

    def gang_bound_counts(self) -> dict[str, int]:
        """gang name -> live BOUND member count, one locked pass. Solve-time
        input for the all-or-nothing gate (scheduling/groups.enforce_gangs):
        members already running credit the gang's floor, so the pending
        remainder of a partially-bound gang can complete instead of being
        withheld forever against the full min_count."""
        out: dict[str, int] = {}
        with self._lock:
            for p in self.pods.values():
                if p.node_name:
                    g = p.gang_name()
                    if g:
                        out[g] = out.get(g, 0) + 1
        return out

    def node_usage(self) -> dict[str, "object"]:
        """node name -> summed bound-pod requests, in ONE locked pass over
        the pod store (callers used to run pods_on_node per node — O(nodes x
        pods) with a lock round-trip per node)."""
        out: dict[str, object] = {}
        with self._lock:
            for p in self.pods.values():
                if p.node_name:
                    cur = out.get(p.node_name)
                    out[p.node_name] = p.requests.v if cur is None else cur + p.requests.v
        return out

    def bind_pod(self, pod_uid: str, node_name: str, now: float = 0.0) -> None:
        with self._lock:
            self._pending_check()
            pod = self.pods[pod_uid]
            old = pod.node_name
            pod.node_name = node_name
            pod.phase = "Running"
            node = self.nodes.get(node_name)
            if node is not None:
                node.last_pod_event = max(node.last_pod_event, now)
            self._index_pod(pod)
            self._record("pod", node_name)
            if old and old != node_name:
                self._record("pod", old)
            if self.observer is not None:
                # bind time in the caller's clock base (controllers pass
                # clock.now()); falls back to store time when unstamped
                self.observer.pod_bound(
                    pod_uid, node_name, now=now if now else self._now()
                )

    def unbind_pod(self, pod_uid: str) -> None:
        """Release a pod back to Pending (the drain/evict path). The inverse
        of :meth:`bind_pod`, and like it the ONLY sanctioned way to change a
        stored pod's binding — a direct ``pod.node_name = ...`` write is
        invisible to the change journal and can serve stale tensors."""
        with self._lock:
            self._pending_check()
            pod = self.pods.get(pod_uid)
            if pod is None:
                return
            old = pod.node_name
            node = self.nodes.get(old)
            if node is not None:
                node.last_pod_event = max(node.last_pod_event, self._now())
            pod.node_name = ""
            pod.phase = "Pending"
            self._index_pod(pod)
            self._record("pod", old or "")
            if self.observer is not None:
                self.observer.pod_unbound(pod_uid, old or "", now=self._now())

    def note_pod_update(self, pod: Pod) -> None:
        """Journal an in-place/field mutation of a stored pod (labels,
        requests, annotations ...). Pair with ``Pod.bump_version()`` for
        container mutations; encoders otherwise cannot see the change."""
        with self._lock:
            self._record("pod", pod.node_name or "")

    def pods_on_node(self, node_name: str) -> list[Pod]:
        with self._lock:
            return [p for p in self.pods.values() if p.node_name == node_name]

    def nodeclass_by_pool(self, pools) -> dict:
        """pool name -> resolved NodeClass (or None). The per-pool map the
        solve and consolidation paths consume: nodeclass ephemeral rules
        (root volume, instanceStorePolicy) shape per-pool capacity. Locked
        snapshot like every other Cluster read: callers hand in the LIVE
        nodepools dict, which mutates under apply() from other threads."""
        with self._lock:
            items = list(
                pools.items() if hasattr(pools, "items")
                else ((p.name, p) for p in pools)
            )
            return {
                name: self.nodeclasses.get(pool.nodeclass_name)
                for name, pool in items
            }

    def pods_by_node(self) -> dict[str, list[Pod]]:
        """node name -> bound pods, in ONE locked pass over the pod store.
        Callers iterating nodes must use this instead of pods_on_node per
        node — that is O(nodes x pods) with a lock round-trip per node and
        was 6s of a 5k-node consolidation encode."""
        out: dict[str, list[Pod]] = {}
        with self._lock:
            for p in self.pods.values():
                if p.node_name:
                    out.setdefault(p.node_name, []).append(p)
        return out

    def pods_on_nodes(self, names) -> dict[str, list[Pod]]:
        """node name -> bound pods for exactly ``names``, from the
        incrementally-maintained bound-pod index: O(returned pods), however
        large the store. This is the incremental encoder's per-patch fetch;
        it sees every binding made through Cluster methods (the sanctioned
        mutation surface — bind_pod/unbind_pod/apply/delete)."""
        out: dict[str, list[Pod]] = {}
        with self._lock:
            for name in names:
                bucket = self._pods_index.get(name)
                if bucket:
                    out[name] = list(bucket.values())
        return out

    def node_by_provider_id(self, provider_id: str) -> Optional[Node]:
        with self._lock:
            for n in self.nodes.values():
                if n.provider_id == provider_id:
                    return n
            return None

    def claims_for_nodepool(self, nodepool_name: str) -> list[NodeClaim]:
        with self._lock:
            return [c for c in self.nodeclaims.values() if c.nodepool_name == nodepool_name]

    def claims_for_nodeclass(self, nodeclass_name: str) -> list[NodeClaim]:
        with self._lock:
            return [c for c in self.nodeclaims.values() if c.nodeclass_name == nodeclass_name]

    def in_use_by_nodepool(self) -> dict[str, ResourceVector]:
        """Capacity accounted against each NodePool's limits — launched
        claims count whether or not their node has registered yet."""
        with self._lock:
            out: dict[str, ResourceVector] = {}
            for claim in self.nodeclaims.values():
                if claim.deleted or not claim.is_launched():
                    continue
                acc = out.setdefault(claim.nodepool_name, ResourceVector())
                out[claim.nodepool_name] = acc + claim.status.capacity
            return out

    def snapshot_nodes(self) -> list[Node]:
        with self._lock:
            return list(self.nodes.values())

    def snapshot_claims(self) -> list[NodeClaim]:
        with self._lock:
            return list(self.nodeclaims.values())
