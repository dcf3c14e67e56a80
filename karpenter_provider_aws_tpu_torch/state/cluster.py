"""The Cluster store + Node model, with the change journal the incremental
cluster encoder reads.

``Node`` is the JAX package's ``state/cluster.py`` Node unchanged. ``Cluster``
is the reference's store without its partition router, pending-pod index,
gang counts, PDBs and lifecycle observer: every mutation through its methods
bumps a monotonic revision ``rev`` and appends ``(rev, kind, name)`` to a
bounded journal (``changes_since``), so ``ops.consolidate.encode_cluster``
patches the rows a change dirtied instead of re-encoding the cluster.
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Optional

from ..models import labels as lbl
from ..models.nodeclaim import NodeClaim
from ..models.nodepool import NodePool
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


# Bounded change-journal length: overflow forces one full re-encode (never a
# correctness loss). This is the FLOOR of the journal ladder — the store
# regrows its journal on a power-of-two ladder as the object population grows
# (see ``journal_cap_for``), so steady 1% churn between passes on a large
# store stays incremental.
JOURNAL_CAP = 4096

#: absolute journal ceiling (entries); past it the full re-encode is cheaper
#: than the window anyway
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
    ``since(rev)`` bisects to the first newer entry. Appending past
    ``maxlen`` drops the single oldest entry (amortized O(1) via a head
    offset compacted in bulk)."""

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
        first. Callers check their cursor against the evicted revision
        BEFORE calling."""
        lo = bisect_right(self._revs, rev, self._start)
        return self._buf[lo:]


#: Bumped by every tracked Node field write, across all clusters. The
#: incremental encoder snapshots it per pass: unchanged means NO node
#: attribute anywhere was touched, so its defensive per-row version scan
#: (which catches direct writes that bypass Cluster methods) is skipped.
NODE_WRITE_SEQ = _Seq()


class Cluster:
    """Thread-safe object store. All mutation goes through methods.

    Every mutation bumps a monotonic revision ``rev`` and appends a
    ``(rev, kind, name)`` entry to a bounded change journal; consumers that
    keep derived snapshots (the incremental cluster encoder) call
    :meth:`changes_since` to learn exactly what moved since their snapshot
    revision — or that the journal rolled over and a full rebuild is due.
    For pods, ``name`` is the affected NODE name (bind/unbind journal the
    node whose tensors the change dirties; pending pods journal ``""``)."""

    def __init__(self, clock=None):
        self.clock = clock
        self._lock = threading.RLock()
        self.nodepools: dict[str, NodePool] = {}
        # pool name -> nodeclass; this package has no NodeClass model yet,
        # so nothing here fills it (``nodeclass_by_pool`` reads None)
        self.nodeclasses: dict[str, object] = {}
        self.nodeclaims: dict[str, NodeClaim] = {}
        self.nodes: dict[str, Node] = {}
        self.pods: dict[str, Pod] = {}
        self.rev: int = 0
        self._journal: _Journal = _Journal(maxlen=JOURNAL_CAP)
        self._journal_evicted_rev: int = 0  # newest rev lost to the cap
        # Epoch token: identifies THIS store incarnation. Re-running
        # __init__ on the same object (an environment reset) makes a new
        # one, so revision-keyed caches held elsewhere key on its identity
        # and never mistake a reset store (rev back at 0) for their snapshot.
        self.epoch: object = object()
        # Incrementally-maintained bound-pod index, read ONLY by
        # pods_on_nodes (the incremental encoder's per-patch fetch).
        # pods_by_node()/pods_on_node() stay full scans — the source of
        # truth even for pods whose node_name was written outside Cluster
        # methods.
        self._pods_index: dict[str, dict[str, Pod]] = {}  # node -> uid -> Pod
        self._pod_node: dict[str, str] = {}               # uid -> indexed node

    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else 0.0

    # -- bound-pod index ---------------------------------------------------
    def _index_pod(self, pod: Pod) -> None:
        """Point the bound-pod index at ``pod``'s current binding (callers
        hold the lock)."""
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

    def _unindex_pod(self, uid: str) -> None:
        cur = self._pod_node.pop(uid, None)
        if cur is not None:
            bucket = self._pods_index.get(cur)
            if bucket is not None:
                bucket.pop(uid, None)

    # -- change journal ----------------------------------------------------
    def _record(self, kind: str, name: str) -> None:
        """Bump ``rev`` and journal one mutation (callers hold the lock).
        Before the journal would drop an entry, its cap climbs the ladder
        over the store's population; past the ladder the oldest entry goes
        and its revision becomes the oldest one ``changes_since`` can
        answer from."""
        self.rev += 1
        j = self._journal
        if len(j) == j.maxlen:
            cap = journal_cap_for(len(self.nodes) + len(self.pods))
            if cap > j.maxlen:
                j.maxlen = cap
            else:
                self._journal_evicted_rev = j[0][0]
        j.append((self.rev, kind, name))

    def note_node_update(self, node: Node) -> None:
        """Journal an in-place/direct mutation of a stored node. (The
        ``Node.__setattr__`` version counter already catches direct writes
        for the encoder's defensive scan.)"""
        with self._lock:
            self._record("node", node.name)

    def changes_since(self, rev: int) -> Optional[dict[str, list[str]]]:
        """Mutations after ``rev`` as ``{kind: [names, in order]}``.

        Returns ``{}`` when nothing changed, and ``None`` when the bounded
        journal no longer covers ``(rev, now]`` (the caller must rebuild
        from scratch). Names repeat in mutation order."""
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
            elif isinstance(obj, NodeClaim):
                self.nodeclaims[obj.name] = obj
                self._record("claim", obj.name)
            elif isinstance(obj, Node):
                self.nodes[obj.name] = obj
                self._record("node", obj.name)
            elif isinstance(obj, Pod):
                prev = self.pods.get(obj.uid)
                self.pods[obj.uid] = obj
                if prev is not None and prev is not obj and prev.node_name:
                    # replacement may move the binding: both nodes dirty
                    if prev.node_name != obj.node_name:
                        self._record("pod", prev.node_name)
                self._index_pod(obj)
                self._record("pod", obj.node_name or "")
            else:
                raise TypeError(f"unknown object {type(obj)}")

    def delete(self, obj) -> None:
        with self._lock:
            if isinstance(obj, NodePool):
                self.nodepools.pop(obj.name, None)
                self._record("pool", obj.name)
            elif isinstance(obj, NodeClaim):
                if obj.finalizers:
                    # finalizer semantics: mark, don't drop
                    if not obj.deleted:
                        obj.deleted_at = self._now()
                    obj.deleted = True
                else:
                    self.nodeclaims.pop(obj.name, None)
                self._record("claim", obj.name)
            elif isinstance(obj, Node):
                self.nodes.pop(obj.name, None)
                self._record("node", obj.name)
            elif isinstance(obj, Pod):
                stored = self.pods.pop(obj.uid, None)
                self._unindex_pod(obj.uid)
                node = self.nodes.get(obj.node_name)
                if node is not None:
                    node.last_pod_event = max(node.last_pod_event, self._now())
                self._record("pod", obj.node_name or "")
                if stored is not None and stored.node_name != obj.node_name:
                    self._record("pod", stored.node_name or "")
            else:
                raise TypeError(f"unknown object {type(obj)}")

    def finalize(self, obj) -> None:
        """Remove finalizers and drop the (already deleted-marked) claim."""
        with self._lock:
            obj.finalizers.clear()
            if isinstance(obj, NodeClaim):
                self.nodeclaims.pop(obj.name, None)
                self._record("claim", obj.name)

    # -- pod binding -------------------------------------------------------
    def bind_pod(self, pod_uid: str, node_name: str, now: float = 0.0) -> None:
        with self._lock:
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

    def unbind_pod(self, pod_uid: str) -> None:
        """Release a pod back to Pending (the drain/evict path). The inverse
        of :meth:`bind_pod`, and like it the ONLY sanctioned way to change a
        stored pod's binding — a direct ``pod.node_name = ...`` write is
        invisible to the change journal and can serve stale tensors."""
        with self._lock:
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

    def note_pod_update(self, pod: Pod) -> None:
        """Journal an in-place/field mutation of a stored pod (labels,
        requests, annotations ...). Pair with ``Pod.bump_version()`` for
        container mutations; encoders otherwise cannot see the change."""
        with self._lock:
            self._record("pod", pod.node_name or "")

    # -- views -------------------------------------------------------------
    def pods_on_node(self, node_name: str) -> list[Pod]:
        with self._lock:
            return [p for p in self.pods.values() if p.node_name == node_name]

    def nodeclass_by_pool(self, pools) -> dict:
        """pool name -> resolved nodeclass (or None): the per-pool map the
        replacement paths read for per-pool capacity. ``pools`` is a
        name -> NodePool mapping or a sequence of pools."""
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
        """node name -> bound pods, in ONE locked pass over the pod store."""
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
        it sees every binding made through Cluster methods."""
        out: dict[str, list[Pod]] = {}
        with self._lock:
            for name in names:
                bucket = self._pods_index.get(name)
                if bucket:
                    out[name] = list(bucket.values())
        return out

    def snapshot_nodes(self) -> list[Node]:
        with self._lock:
            return list(self.nodes.values())

    def snapshot_claims(self) -> list[NodeClaim]:
        with self._lock:
            return list(self.nodeclaims.values())
