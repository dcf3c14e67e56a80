"""Tensorization: pods + nodepool + catalog -> dense solve tensors.

The canonical encoding from SURVEY.md section 7.1:
 - ``requests[G, R]``  — deduped pod-group resource requests
 - ``counts[G]``       — multiplicity per group
 - ``compat[G, T]``    — requirements x taints x offering compatibility
 - ``capacity[T, R]``  — allocatable per type (catalog tensors)
 - ``price[G, T]``     — cheapest offering price usable by the group (inf if
                         none); group-dependent because capacity-type/zone
                         constraints differ per group
 - group order is FFD (decreasing dominant resource share), matching
   designs/bin-packing.md:29-31.

Everything here is host-side numpy; the solver hands the finished arrays
to the device as torch tensors.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import numpy as np

from ..catalog.provider import CatalogProvider, CatalogTensors
from ..models import labels as lbl
from ..models.nodepool import NodePool
from ..models.pod import Pod
from ..models.requirements import Operator, Requirement, Requirements
from ..models.resources import NUM_RESOURCES


def bucket(n: int, minimum: int = 8) -> int:
    """Next power of two >= n (>= minimum): the static-shape padding rule."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _ladder_bucket(n: int, minimum: int = 8) -> int:
    """Next value >= n on the {2^k, 1.5 * 2^k} ladder (overshoot <= 1.5x
    for one extra compile bucket per octave — same rule as the solver's
    node-row sizing)."""
    p = minimum
    while True:
        if n <= p:
            return p
        if n <= p * 3 // 2:
            return p * 3 // 2
        p *= 2


def water_fill(counts: dict, live, skew: int, P: int) -> tuple[dict, dict, int]:
    """Skew-capped greedy water-fill, batched by level.

    Exactly replicates the sequential rule (kube-scheduler's per-pod
    DoNotSchedule check): each pod goes to the lowest-(count, index) LIVE
    zone whose count would stay within ``floor + skew``, where ``floor`` is
    the min count over ALL zones in ``counts`` (dead zones pin it). The
    per-pod loop was the cold-encode hotspot at 10k+ spread pods; batching
    by level places every eligible min-level zone's pod in one step (the
    sequential order provably interleaves exactly that way: ties break by
    index, and raising the zones at the min level cannot change any
    selected zone's eligibility mid-level).

    Returns (updated counts, assignment per zone, placed).
    """
    zis = sorted(counts)
    c = np.array([counts[z] for z in zis], dtype=np.int64)
    is_live = np.array([z in live for z in zis], dtype=bool)
    assign = np.zeros(len(zis), dtype=np.int64)
    placed = 0
    while placed < P and len(zis):
        floor = int(c.min())
        elig = is_live & (c + 1 - floor <= skew)
        if not elig.any():
            break
        m = int(c[elig].min())
        sel = elig & (c == m)           # the working set S, all at level m
        n_sel = int(sel.sum())
        # Batch S upward by WHOLE LEVELS to the next barrier: the
        # sequential rule provably cycles S in index order level by level
        # until (a) the next ELIGIBLE zone's level is reached (it joins S),
        # (b) the floor/skew interaction changes — the floor is pinned by a
        # non-eligible zone at or below m (cap = pin + skew), or S climbs
        # onto a non-eligible zone's level (floor stops riding; recompute) —
        # or (c) the pod budget runs out.
        barrier = P
        above = elig & (c > m)
        if above.any():
            barrier = min(barrier, int(c[above].min()) - m)   # join
        non_elig = c[~elig]
        if non_elig.size:
            f0n = int(non_elig.min())
            barrier = min(
                barrier, (f0n + skew - m) if f0n <= m else (f0n - m)
            )
        full_levels = (P - placed) // n_sel
        delta = min(barrier, full_levels)
        if delta >= 1:
            c[sel] += delta
            assign[sel] += delta
            placed += delta * n_sel
            continue
        # budget < one full level: the remainder goes to S in index order
        idxs = np.flatnonzero(sel)[: P - placed]
        c[idxs] += 1
        assign[idxs] += 1
        placed += len(idxs)
    return (
        {z: int(v) for z, v in zip(zis, c)},
        {z: int(a) for z, a in zip(zis, assign)},
        placed,
    )


def balanced_fill(counts: dict, live, P: int) -> tuple[dict, int]:
    """Uncapped balanced fill over LIVE zones (the ScheduleAnyway
    relaxation): every pod to the lowest-(count, index) live zone. Closed
    form: raise minima to a common water level, remainder to the
    lowest-index zones at the level. Returns (assignment, placed)."""
    zis = [z for z in sorted(counts) if z in live]
    if not zis or P <= 0:
        return {}, 0
    c = np.array([counts[z] for z in zis], dtype=np.int64)
    order = np.argsort(c, kind="stable")
    cs = c[order]
    # find the largest level L with sum(max(0, L - c)) <= P
    prefix = np.cumsum(cs)
    k = len(cs)
    lo, hi = int(cs[0]), int(cs[-1]) + (P // k) + 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        j = int(np.searchsorted(cs, mid, side="left"))
        cost = mid * j - (int(prefix[j - 1]) if j else 0)
        if cost <= P:
            lo = mid
        else:
            hi = mid - 1
    L = lo
    j = int(np.searchsorted(cs, L, side="left"))
    cost = L * j - (int(prefix[j - 1]) if j else 0)
    assign = np.maximum(L - c, 0)
    r = P - cost
    if r > 0:
        at_level = np.flatnonzero(np.maximum(c, L) == L)  # index order
        assign[at_level[:r]] += 1
    return {z: int(a) for z, a in zip(zis, assign) if a}, int(assign.sum())


class ZoneOccupancy:
    """Per-zone counts of already-bound pods, for topology accounting.

    Zone anti-affinity/spread/affinity must see replicas that are *already
    running*, not just the pending ones — otherwise every scale-up restarts
    the balance from zero and co-locates with existing replicas. Built from
    (pod labels, zone) pairs; an empty selector matches every pod (the same
    convention as ``PodAffinityTerm.matches``)."""

    def __init__(self, entries: Optional[Sequence[tuple[Mapping[str, str], str]]] = None):
        # private copies of the label mappings: fingerprint() memoizes over
        # this content, so a caller mutating its own dict after construction
        # must not be able to desynchronize counts() from the fingerprint
        self._entries: list[tuple[dict[str, str], str]] = [
            (dict(labels), zone) for labels, zone in (entries or [])
        ]

    @classmethod
    def from_cluster(cls, cluster) -> "ZoneOccupancy":
        """Snapshot bound pods on nodes with a known zone (duck-typed: any
        object with ``pods_by_node()`` and ``snapshot_nodes()``)."""
        entries = []
        pods_by_node = cluster.pods_by_node()
        for node in cluster.snapshot_nodes():
            zone = node.zone()
            if not zone:
                continue
            for pod in pods_by_node.get(node.name, ()):
                entries.append((pod.labels, zone))
        return cls(entries)

    def counts(self, selector: Mapping[str, str]) -> dict[str, int]:
        """zone -> number of bound pods matching the label selector."""
        out: dict[str, int] = {}
        for labels, zone in self._entries:
            if all(labels.get(k) == v for k, v in selector.items()):
                out[zone] = out.get(zone, 0) + 1
        return out

    def fingerprint(self) -> frozenset:
        """Order-insensitive content identity, computed once. Lets the
        encoded-problem cache span occupancy-bearing solves: between
        reconciles the bound-pod snapshot is usually unchanged, and equal
        snapshots produce identical topology decisions. The EXACT multiset
        (not a hash of it) is returned so a hash collision can never serve
        another snapshot's encoding; frozenset caches its own hash, so key
        lookups stay O(1) after the first. The entries list is never mutated
        after construction (both constructors build it whole), so memoizing
        is sound."""
        fp = getattr(self, "_fingerprint", None)
        if fp is None:
            from collections import Counter

            # Counter keeps duplicate (labels, zone) pairs distinct — a
            # plain frozenset would collapse two identical pods into one
            fp = frozenset(
                Counter(
                    (tuple(sorted(labels.items())), zone)
                    for labels, zone in self._entries
                ).items()
            )
            self._fingerprint = fp
        return fp


@dataclass
class EncodedProblem:
    # Device-facing tensors (numpy; solver converts to jnp).
    requests: np.ndarray        # [G, R] float32
    counts: np.ndarray          # [G] int32
    compat: np.ndarray          # [G, T] bool
    capacity: np.ndarray        # [T, R] float32
    price: np.ndarray           # [G, T] float32, inf where unusable
    # Host-side decode metadata.
    group_pods: list[list[Pod]] = field(default_factory=list)   # per real group
    type_names: tuple[str, ...] = ()
    zones: tuple[str, ...] = ()
    nodepool: Optional[NodePool] = None
    # Joint per-group offering window (zone x capacity-type allowances) and
    # per-type live-offering window (ICE already masked). Joint — not two
    # marginal masks — so a (zone, captype) combination with no live offering
    # can never be advertised on a node.
    group_window: np.ndarray = None           # [G, Z, C] bool (C = NUM_CAPACITY_TYPES)
    type_window: np.ndarray = None            # [T, Z, C] bool
    # Marginal views kept for inspection/tests:
    group_zone_allowed: np.ndarray = None     # [G, Z] bool
    group_captype_allowed: np.ndarray = None  # [G, C] bool
    # Hostname-topology cap: max replicas of the group on one node.
    max_per_node: np.ndarray = None           # [G] int32
    # Required hostname co-location: the group is ONE summed super-pod
    # (count 1); decode expands it back into its pods on the single node.
    atomic: np.ndarray = None                 # [G] bool
    # Exotic types (bare metal): kept out of ranked launch alternatives when
    # standard types qualify (parity: instance.go:456-477
    # filterExoticInstanceTypes — metal only launches when requested or when
    # nothing else fits).
    type_exotic: np.ndarray = None            # [T] bool
    unencodable: list[tuple[Pod, str]] = field(default_factory=list)

    @property
    def num_groups(self) -> int:
        return len(self.group_pods)

    @property
    def num_pods(self) -> int:
        return int(self.counts.sum())


def _group_requirements(
    pod: Pod, nodepool: Optional[NodePool], include_preferences: bool = False
) -> Requirements:
    reqs = pod.requirements()
    if include_preferences and pod.preferred_node_affinity:
        for r in pod.preferred_node_affinity:
            reqs.add(r)
    if nodepool is not None:
        reqs = reqs.union(nodepool.scheduling_requirements())
    return reqs


_SKIP_KEYS = (lbl.TOPOLOGY_ZONE, lbl.CAPACITY_TYPE, lbl.HOSTNAME, lbl.NODEPOOL)

# Per-catalog-snapshot label matrices, keyed by the snapshot's name tuple
# (the tuple itself, not id() — ids are reused after GC).
_label_array_cache: dict[tuple, dict] = {}


def _label_arrays(types, names_key) -> dict:
    """key -> (object array of label values, float array for numerics) over T.

    Vectorizes requirement evaluation: one numpy pass per requirement key per
    group instead of a Python loop over all T types (the encode-side hot path).
    """
    cached = _label_array_cache.get(names_key)
    if cached is not None:
        return cached
    per_key: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    all_labels = [t.labels() for t in types]
    keys = set()
    for d in all_labels:
        keys.update(d)
    for key in keys:
        vals = np.array([d.get(key) for d in all_labels], dtype=object)
        fvals = np.full(len(all_labels), np.nan)
        for i, v in enumerate(vals):
            if v is not None:
                try:
                    fvals[i] = float(v)
                except ValueError:
                    pass
        per_key[key] = (vals, fvals)
    _label_array_cache.clear()  # one snapshot at a time is enough
    _label_array_cache[names_key] = per_key
    return per_key


def _contains_vec(vs, vals: np.ndarray, fvals: np.ndarray) -> np.ndarray:
    """Vectorized ValueSet.contains over a label-value array (None = absent)."""
    defined = np.array([v is not None for v in vals])
    ok = np.full(len(vals), vs.allow_defined)
    if vs.gt != -np.inf or vs.lt != np.inf:
        with np.errstate(invalid="ignore"):
            ok &= (fvals > vs.gt) & (fvals < vs.lt)
    if vs.complement:
        if vs.values:
            ok &= ~np.isin(vals, list(vs.values))
    else:
        ok &= np.isin(vals, list(vs.values))
    return np.where(defined, ok, vs.allow_undefined)


_UNSATISFIABLE = object()  # sentinel from _atomic_zone_mask


def _atomic_zone_mask(pod, occupancy, zone_names, Z, unit: int = 1):
    """Zone allowance for a co-located (atomic) group: the unit lands in
    ONE zone, so zone terms reduce to a zone mask. Returns a [Z] bool mask,
    None (unrestricted), or _UNSATISFIABLE (hard conflict)."""
    mask = np.ones(Z, dtype=bool)
    restricted = False
    zindex = {z: i for i, z in enumerate(zone_names)}

    def occ(selector):
        return occupancy.counts(selector) if occupancy is not None else {}

    for a in pod.anti_affinity:
        if a.topology_key != lbl.TOPOLOGY_ZONE:
            continue
        # zones already holding matching pods are off-limits (self or not)
        for z, c in occ(a.label_selector).items():
            if c > 0 and z in zindex:
                mask[zindex[z]] = False
                restricted = True
    for a in pod.affinity:
        if a.topology_key == lbl.TOPOLOGY_ZONE:
            seeded = [z for z, c in occ(a.label_selector).items() if c > 0]
            if seeded:
                m2 = np.zeros(Z, dtype=bool)
                for z in seeded:
                    if z in zindex:
                        m2[zindex[z]] = True
                mask &= m2
                restricted = True
    for c in pod.topology_spread:
        if (
            c.topology_key == lbl.TOPOLOGY_ZONE
            and c.when_unsatisfiable == "DoNotSchedule"
        ):
            # the whole unit in one zone gives that zone +unit matching
            # pods: satisfiable only when the skew bound tolerates it
            counts = occ(c.label_selector)
            floor = min(
                (counts.get(z, 0) for z in zone_names), default=0
            )
            if floor + c.max_skew < unit:
                return _UNSATISFIABLE
    return mask if restricted else None


#: Encoded-problem cache across reconcile passes. The provisioning loop
#: re-solves near-identical problems back to back (pending set unchanged
#: while launches are in flight); the reference caches its entire
#: instance-type list under a seqnum composite key for the same reason
#: (instancetype.go:121-139). Keyed on pod (id, version) pairs (safe against
#: id reuse because the cached problem itself keeps every pod alive), the
#: nodepool template hash, the catalog seqnum key, and — when a ZoneOccupancy
#: is supplied — its exact content fingerprint (equal bound-pod multisets
#: produce identical topology decisions). Only a caller-supplied tensors
#: snapshot bypasses the cache (a what-if view the key cannot distinguish).
#: CONTRACT: the (id, version) pod keys below only observe field
#: REASSIGNMENT (Pod.__setattr__). In-place mutation of a field's container
#: (``pod.labels[k] = v``) is invisible — such a caller must invoke
#: ``pod.bump_version()`` or reassign a fresh container, else this cache can
#: serve a stale encoding and launch capacity sized from old requests/
#: selectors. ``invalidate_problem_cache()`` is the big hammer for callers
#: that cannot touch the pods.
_PROBLEM_CACHE: "OrderedDict[tuple, EncodedProblem]" = OrderedDict()
_PROBLEM_CACHE_MAX = 8
_PROBLEM_CACHE_LOCK = threading.Lock()


def invalidate_problem_cache() -> None:
    """Drop every cached encoding (see the mutation contract above)."""
    with _PROBLEM_CACHE_LOCK:
        _PROBLEM_CACHE.clear()


def effective_capacity(capacity, types, nodeclass):
    """[T, R] allocatable with the EPHEMERAL column following the nodeclass:
    root EBS volume size by default, total instance store under the RAID0
    policy (types.go:218-244). Shared by the provisioning encode and the
    consolidation replacement screens so fit decisions agree everywhere.
    Returns ``capacity`` itself when there is no nodeclass to apply."""
    if nodeclass is None:
        return capacity
    from ..models.resources import EPHEMERAL as _EPH

    root_mib = float(nodeclass.root_volume_size_gib() * 1024)
    eph = np.full(len(types), root_mib, dtype=np.float32)
    if nodeclass.instance_store_policy == "RAID0":
        nvme_mib = np.array(
            [t.local_nvme_gib * 1024.0 for t in types], dtype=np.float32
        )
        eph = np.where(nvme_mib > 0, nvme_mib, eph)
    out = capacity.copy()
    out[:, _EPH] = eph
    return out


def _problem_cache_key(pods, catalog, nodepool, occupancy, allowed_types,
                       allow_reserved, include_preferences, tensors,
                       nodeclass=None, revision=None):
    # A caller-supplied tensors snapshot bypasses the cache entirely: it may
    # be a what-if view that catalog.cache_key() cannot distinguish.
    if tensors is not None or not pods:
        return None
    if allow_reserved is True:
        reserved_key = True
    elif allow_reserved:
        reserved_key = frozenset(allow_reserved)
    else:
        reserved_key = False
    if revision is not None:
        # Revision path: the caller asserts the pod list is a pure function
        # of ``revision`` (e.g. (cluster.epoch, cluster.rev, nominated set)
        # — the pending set is derived state). The O(len(pods)) id/version
        # tuples collapse to the revision token + a length sanity check;
        # everything below (catalog seqnums, pool/nodeclass hashes,
        # occupancy fingerprint) still participates, so offering, template,
        # and topology changes invalidate exactly as on the legacy path.
        pods_key = ("rev", revision, len(pods), id(pods[0]))
    else:
        # (id, version) pairs: the cached problem keeps every pod alive (so
        # ids cannot be recycled), and the version bumps on any sanctioned
        # scheduling-field reassignment (Pod.__setattr__) so a mutated pod
        # can never be served its stale encoding
        pods_key = (tuple(map(id, pods)), tuple(p._version for p in pods))
    # the DaemonSet overhead changes CAPACITY; it is process state outside
    # the pod/catalog keys, so it participates explicitly — re-registering
    # agents can never serve a stale encoding
    from . import overhead as _overhead

    return (
        pods_key,
        _overhead.seq(),
        # catalog.uid, not id(catalog): the cached problem does not keep the
        # catalog alive, so a freed catalog's address could be reused
        catalog.uid,
        catalog.cache_key(),
        (nodepool.name, nodepool.weight, nodepool.hash()) if nodepool else None,
        # ephemeral-storage capacity follows the nodeclass (RAID0 policy +
        # root volume size) -> different nodeclass, different tensors
        nodeclass.hash() if nodeclass is not None else None,
        frozenset(allowed_types) if allowed_types is not None else None,
        reserved_key,
        include_preferences,
        # occupancy participates by content fingerprint: between reconciles
        # the bound-pod snapshot is usually unchanged, and equal snapshots
        # produce identical topology decisions
        occupancy.fingerprint() if occupancy is not None else None,
    )


def encode_problem(
    pods: Sequence[Pod],
    catalog: CatalogProvider,
    nodepool: Optional[NodePool] = None,
    tensors: Optional[CatalogTensors] = None,
    occupancy: Optional[ZoneOccupancy] = None,
    allowed_types: Optional[set] = None,
    allow_reserved=True,
    include_preferences: bool = True,
    nodeclass=None,
    revision=None,
) -> EncodedProblem:
    """Build the dense solve tensors for one nodepool's candidate pods.

    Pods that cannot run on this nodepool at all (taints not tolerated,
    incompatible requirements) land in ``unencodable`` with a reason, the
    analogue of the reference's per-pod filtering before Solve
    (cloudprovider.go:253-264 resolveInstanceTypes).

    ``allow_reserved`` controls access to the shared catalog's reserved
    offerings, which belong to the nodeclasses whose selectors resolved
    them: ``True`` = all (single-tenant callers), ``False``/empty = none, or
    a set of ``(instance_type, zone)`` pairs = exactly this pool's own
    nodeclass reservations — pool A holding ANY reservation must not drain
    pool B's pre-paid capacity for a different (type, zone).

    ``revision`` (optional, opaque hashable): the cross-reconcile cache key
    uses it IN PLACE of the per-pod (id, version) tuples — an O(1) revision
    check instead of an O(pods) key rebuild. The caller must guarantee the
    pod list is fully determined by the revision (the provisioning loop
    passes ``(cluster.epoch, cluster.rev, frozenset(nominated))``).
    """
    ckey = _problem_cache_key(pods, catalog, nodepool, occupancy,
                              allowed_types, allow_reserved,
                              include_preferences, tensors,
                              nodeclass=nodeclass, revision=revision)
    if ckey is not None:
        with _PROBLEM_CACHE_LOCK:
            hit = _PROBLEM_CACHE.get(ckey)
            if hit is not None:
                _PROBLEM_CACHE.move_to_end(ckey)
                return hit

    tensors = tensors if tensors is not None else catalog.tensors()
    types = catalog.list()
    T = len(types)
    Z = len(tensors.zones)

    # Effective per-type capacity: ephemeral-storage follows the pool's
    # NODECLASS (GetInstanceTypes is per-NodePool + nodeclass in the
    # reference for exactly this reason). Computed HERE so the per-pod fit
    # prefilter and the solve tensor agree. Per-node agent reservations
    # (ops/overhead.py) come off every candidate type the same way — a
    # fresh node pays its DaemonSets before the first workload pod lands.
    from . import overhead as _overhead

    cap_eff = _overhead.apply(effective_capacity(tensors.capacity, types, nodeclass))

    # Per-problem offering availability: the reserved axis is masked down to
    # the pairs this pool may use; price/compat/type_window all derive from
    # this one array so the gate cannot be bypassed downstream.
    available = tensors.available
    if allow_reserved is not True:
        available = available.copy()
        rmask = np.zeros((T, Z), dtype=bool)
        if allow_reserved:  # a set of (type, zone) pairs
            tidx = {n: i for i, n in enumerate(tensors.names)}
            zidx = {z: i for i, z in enumerate(tensors.zones)}
            for tname, zname in allow_reserved:
                ti, zi = tidx.get(tname), zidx.get(zname)
                if ti is not None and zi is not None:
                    rmask[ti, zi] = True
        available[:, :, lbl.RESERVED_INDEX] &= rmask

    pool_reqs = nodepool.scheduling_requirements() if nodepool else Requirements()
    # startupTaints are exempt from toleration checks: they are expected to
    # be removed once the node is ready (karpenter startupTaints semantics).
    taints = list(nodepool.taints) if nodepool else []

    # -- group pods by scheduling key -------------------------------------
    # Dedup FIRST, then filter once per group: pods with equal keys are
    # interchangeable (scheduling_key covers requests, selectors, affinity,
    # tolerations, topology), so taint/compat checks on 50k pods collapse to
    # checks on ~dozens of groups — this is the per-pod loop the device design
    # moves off the hot path (SURVEY.md section 7).
    # Keyed by interned scheduling token. Gang members need per-gang groups
    # and the all-or-nothing commit, which this package does not carry yet:
    # an armed gang annotation is refused rather than packed as loose pods.
    from ..models.pod import gangs_enabled as _gangs_enabled

    gangs_on = _gangs_enabled()
    raw_groups: dict = {}
    for pod in pods:
        if gangs_on and pod.gang_name():
            raise NotImplementedError(
                f"pod {pod.name}: gang scheduling is not supported by the "
                "torch solver yet"
            )
        raw_groups.setdefault(pod.scheduling_token(), []).append(pod)
    groups: dict[int, list[Pod]] = {}
    unencodable: list[tuple[Pod, str]] = []
    for key, plist in raw_groups.items():
        pod = plist[0]
        if taints and not pod.tolerates_all(taints):
            unencodable.extend((p, "does not tolerate nodepool taints") for p in plist)
            continue
        reqs = pod.requirements()
        if not reqs.compatible(pool_reqs):
            unencodable.extend((p, "incompatible with nodepool requirements") for p in plist)
            continue
        # A hostname pin names an *existing* node; provisioning a fresh node
        # can never satisfy it (new nodes get new hostnames).
        if reqs.get(lbl.HOSTNAME).finite_values() is not None:
            unencodable.extend((p, "pinned to an existing node via hostname") for p in plist)
            continue
        groups[key] = plist

    # -- topology expansion ------------------------------------------------
    # Zone-level constraints are resolved HOST-side by splitting a group into
    # zone-pinned subgroups (balanced shares for topology spread, one pod per
    # zone for anti-affinity, a single zone for affinity); the device solver
    # then only ever sees per-group zone windows. Hostname-level constraints
    # become a per-group max-per-node cap enforced inside the scan
    # (SURVEY.md section 7.4: "topology as iterative masked rounds").
    zone_names = list(tensors.zones)
    pool_zone_vs = pool_reqs.get(lbl.TOPOLOGY_ZONE)

    live_zone_mask = available.any(axis=(0, 2))  # [Z] any live offering
    zone_index = {z: zi for zi, z in enumerate(zone_names)}

    # (pods, zone_pin, mpn, zone_mask, atomic) — zone_mask is an extra [Z]
    # allowance from non-self anti-affinity terms, applied when the group is
    # not pinned; atomic marks required-hostname-co-location groups (every
    # replica on ONE node: encoded as a single summed super-pod).
    expanded: list[tuple] = []
    for plist in groups.values():
        pod = plist[0]
        mpn = pod.hostname_cap()
        if pod.hostname_colocated():
            # Co-located group: zone splitting would scatter replicas
            # across zones/nodes — the whole group travels as one unit.
            # mpn=1 keeps it off pre-opened existing rows (their matching
            # occupancy is invisible to the solve) and caps one unit/node.
            self_sel = next(
                a.label_selector for a in pod.affinity
                if a.topology_key == lbl.HOSTNAME and a.matches(pod)
            )
            if occupancy is not None and any(
                c > 0 for c in occupancy.counts(self_sel).values()
            ):
                # the group is already seeded on some node: pending
                # replicas must JOIN it — that is the rebinder's job
                # (scheduling controller); a fresh node would split the
                # group. They pend if the seeded node is full, exactly
                # like kube-scheduler.
                unencodable.extend(
                    (p, "co-located group already running; replicas must "
                        "join its node") for p in plist
                )
                continue
            zmask = _atomic_zone_mask(pod, occupancy, zone_names, Z,
                                      unit=len(plist))
            if zmask is _UNSATISFIABLE:
                unencodable.extend(
                    (p, "hostname co-location conflicts with zone topology "
                        "spread (whole group lands in one zone)")
                    for p in plist
                )
                continue
            expanded.append((plist, None, 1, zmask, True))
            continue
        ztop = pod.zone_topology_term()
        allowed_z = [
            zi for zi, z in enumerate(zone_names)
            if pod.requirements().get(lbl.TOPOLOGY_ZONE).contains(z)
            and pool_zone_vs.contains(z)
        ]
        # Zones already holding pods matched by any NON-self zone
        # anti-affinity term are off-limits regardless of the pod's own
        # topology mode (e.g. a web pod that must avoid zones running db);
        # NON-self zone AFFINITY restricts to zones where the target
        # workload already runs (required co-zone with another app).
        anti_mask: Optional[np.ndarray] = None
        if occupancy is not None:
            other_terms = [
                a for a in pod.anti_affinity
                if a.topology_key == lbl.TOPOLOGY_ZONE and not a.matches(pod)
            ]
            other_aff = [
                a for a in pod.affinity
                if a.topology_key == lbl.TOPOLOGY_ZONE and not a.matches(pod)
            ]
            if other_terms or other_aff:
                anti_mask = np.ones(Z, dtype=bool)
                for a in other_terms:
                    for z, c in occupancy.counts(a.label_selector).items():
                        if c > 0 and z in zone_index:
                            anti_mask[zone_index[z]] = False
                unseeded_reason = ""
                for a in other_aff:
                    seeded = np.zeros(Z, dtype=bool)
                    hits = occupancy.counts(a.label_selector)
                    had_hits = any(c > 0 for c in hits.values())
                    for z, c in hits.items():
                        if c > 0 and z in zone_index:
                            seeded[zone_index[z]] = True
                    if not seeded.any():
                        # pending either way, but say WHY accurately
                        unseeded_reason = (
                            "required zone affinity: matching pods run only "
                            "in zones outside this nodepool"
                            if had_hits
                            else "required zone affinity: no matching pods "
                                 "are running in any zone"
                        )
                        break
                    anti_mask &= seeded
                if unseeded_reason:
                    unencodable.extend((p, unseeded_reason) for p in plist)
                    continue
                allowed_z = [zi for zi in allowed_z if anti_mask[zi]]
        if ztop is None or not allowed_z:
            expanded.append((plist, None, mpn, anti_mask, False))
            continue
        mode, skew, selector = ztop
        # Existing bound replicas matching the term's selector, per zone —
        # scale-ups must balance against them, not restart from zero.
        existing = occupancy.counts(selector) if occupancy is not None else {}
        e = {zi: existing.get(zone_names[zi], 0) for zi in allowed_z}
        live = {zi for zi in allowed_z if live_zone_mask[zi]}
        if mode == "affinity":
            # Co-locate: required zone affinity means landing where matching
            # pods already run; with no existing matches the group seeds its
            # own zone — prefer one with live offerings (ICE considered).
            seeded = [zi for zi in allowed_z if e[zi] > 0]
            if seeded:
                pin = next((zi for zi in seeded if zi in live), seeded[0])
            elif any(c > 0 for c in existing.values()):
                # seeded empty means every allowed zone has zero matches, so
                # any existing match necessarily runs in a disallowed zone.
                for pod_i in plist:
                    unencodable.append(
                        (pod_i, "zone affinity: matching pods run only in disallowed zones")
                    )
                continue
            else:
                pin = next((zi for zi in allowed_z if zi in live), allowed_z[0])
            expanded.append((plist, pin, mpn, None, False))
        elif mode == "anti":
            # Each replica needs a zone with NO matching pod, existing or new.
            empty = sorted(
                (zi for zi in allowed_z if e[zi] == 0),
                key=lambda zi: (zi not in live, zi),  # live zones first
            )
            for i, pod_i in enumerate(plist):
                if i < len(empty):
                    expanded.append(([pod_i], empty[i], mpn, None, False))
                else:
                    unencodable.append(
                        (pod_i, "zone anti-affinity: no zone without a matching pod left")
                    )
        else:  # spread / soft_spread: greedy water-fill w/ incremental skew
            # Place each pod in the lowest-count *live* zone that keeps
            # max-min skew <= max_skew over the allowed domain (dead/ICE'd
            # zones still count toward the domain minimum, so a fully-ICE'd
            # zone caps how high the others may grow — DoNotSchedule
            # semantics, kube-scheduler's per-pod check).
            counts, assign, placed = water_fill(e, live, skew, len(plist))
            if mode == "soft_spread" and placed < len(plist) and live:
                # ScheduleAnyway: the skew cap is a preference — relax it
                # for the remainder instead of failing, still favoring the
                # emptiest live zones (kube-scheduler scores, we round-robin)
                extra, more = balanced_fill(counts, live, len(plist) - placed)
                for zi, a in extra.items():
                    assign[zi] = assign.get(zi, 0) + a
                placed += more
            start = 0
            for zi in allowed_z:
                take = assign[zi]
                if take:
                    expanded.append((plist[start : start + take], zi, mpn, None, False))
                    start += take
            if mode == "soft_spread" and start < len(plist):
                # no live allowed zone at all: hand the rest to the generic
                # path unpinned (a preference must never make pods pend) —
                # keeping the non-self anti-affinity zone mask, which is a
                # HARD constraint
                expanded.append((plist[start:], None, mpn, anti_mask, False))
            else:
                for pod_i in plist[start:]:
                    unencodable.append(
                        (pod_i, "zone topology spread unsatisfiable (max skew / zone availability)")
                    )

    group_list = [e[0] for e in expanded]
    G = len(group_list)

    requests = np.zeros((max(G, 1), NUM_RESOURCES), dtype=np.float32)
    counts = np.zeros(max(G, 1), dtype=np.int32)
    compat = np.zeros((max(G, 1), T), dtype=bool)
    price = np.full((max(G, 1), T), np.inf, dtype=np.float32)
    zone_allowed = np.zeros((max(G, 1), Z), dtype=bool)
    captype_allowed = np.zeros((max(G, 1), lbl.NUM_CAPACITY_TYPES), dtype=bool)
    group_window = np.zeros((max(G, 1), Z, lbl.NUM_CAPACITY_TYPES), dtype=bool)
    max_per_node = np.full(max(G, 1), 1 << 30, dtype=np.int32)
    atomic = np.zeros(max(G, 1), dtype=bool)

    # Cache key: catalog seqnum + names — a refresh() bumps the seq even when
    # type names are unchanged, so stale label arrays can't be served.
    catalog_seq = tensors.key[0] if tensors.key else 0
    label_arrays = _label_arrays(types, (catalog.uid, catalog_seq, tensors.names))

    # Keys the nodepool stamps onto its nodes as template labels: satisfied by
    # construction on any launched node, never constraints on the type itself.
    provided_keys = set(nodepool.labels) if nodepool else set()

    # Launchability mask: types the caller knows cannot launch (e.g. no
    # compatible image resolves for the nodeclass) are excluded from the
    # solve entirely, instead of failing at CloudProvider.Create (parity:
    # amifamily Resolver dropping types no AMI maps to, resolver.go:123-162).
    if allowed_types is not None:
        base_ok = np.array([n in allowed_types for n in tensors.names], dtype=bool)
    else:
        base_ok = np.ones(T, dtype=bool)

    # Zone-pin expansion multiplies groups (one spread service -> one
    # subgroup per zone) but subgroups of the same original group share ALL
    # zone-independent work: requirements extraction, static label compat,
    # resource fit, and the per-(type, zone) price floor. Compute those once
    # per scheduling key; per subgroup only the [T, Z] zone combine remains.
    shared: dict = {}
    for gi, (plist, zone_pin, mpn, zone_mask, is_atomic) in enumerate(expanded):
        pod = plist[0]
        if is_atomic:
            # co-located group: one summed super-pod; the fit check below
            # then requires a type that holds the WHOLE group
            requests[gi] = np.sum([p.requests.v for p in plist], axis=0)
            counts[gi] = 1
            atomic[gi] = True
        else:
            requests[gi] = pod.requests.v
            counts[gi] = len(plist)
        max_per_node[gi] = mpn
        ck = pod.scheduling_token()
        hit = shared.get(ck)
        if hit is None:
            reqs = _group_requirements(pod, nodepool, include_preferences)
            # Offering-level allowances: which zones / capacity types may
            # serve this group (zone + capacity-type as requirements).
            zvs = reqs.get(lbl.TOPOLOGY_ZONE)
            cvs = reqs.get(lbl.CAPACITY_TYPE)
            zrow = np.array([zvs.contains(z) for z in tensors.zones])
            crow = np.array([cvs.contains(ct) for ct in lbl.CAPACITY_TYPES])

            # Static label compat, vectorized over T per requirement key.
            static_ok = base_ok.copy()
            for key, vs in reqs:
                if key in _SKIP_KEYS or key in provided_keys:
                    continue
                arrays = label_arrays.get(key)
                if arrays is None:
                    # No type defines this label; satisfiable only if
                    # absence is OK.
                    if not vs.allow_undefined:
                        static_ok[:] = False
                        break
                    continue
                static_ok &= _contains_vec(vs, *arrays)
                if not static_ok.any():
                    break

            fits = (pod.requests.v[None, :] <= cap_eff + 1e-6).all(axis=1)
            # (reserved-offering access is enforced via the masked
            # `available` array — price, compat, type_window derive from it.
            # Market state rides the same columns: an open reservation
            # window lands as (committed_price, True) in the RESERVED cell,
            # a reclaim-risk premium is already folded into the SPOT price
            # value — so the min below IS the market arbitrage and no shape
            # ever changes with the market on.)
            offer_tc = available & crow[None, None, :]           # [T, Z, C]
            price_tz = np.where(offer_tc, tensors.price, np.inf).min(axis=2)
            avail_tz = offer_tc.any(axis=2)                      # [T, Z]
            hit = (zrow, crow, static_ok, fits, price_tz, avail_tz)
            shared[ck] = hit
        zrow, crow, static_ok, fits, price_tz, avail_tz = hit
        if is_atomic:
            # the cached fit is per-pod; an atomic group needs a type that
            # holds the whole summed unit
            fits = (requests[gi][None, :] <= cap_eff + 1e-6).all(axis=1)

        zone_allowed[gi] = zrow
        if zone_mask is not None:
            zone_allowed[gi] &= zone_mask
        if zone_pin is not None:
            pin = np.zeros(Z, dtype=bool)
            pin[zone_pin] = True
            zone_allowed[gi] &= pin
        captype_allowed[gi] = crow
        group_window[gi] = zone_allowed[gi][:, None] & captype_allowed[gi][None, :]

        zmask = zone_allowed[gi]
        if zmask.all():
            offer_any = avail_tz.any(axis=1)
            row_price = price_tz.min(axis=1)
        elif zmask.any():
            offer_any = avail_tz[:, zmask].any(axis=1)
            row_price = price_tz[:, zmask].min(axis=1)
        else:
            offer_any = np.zeros(T, dtype=bool)
            row_price = np.full(T, np.inf, dtype=np.float32)
        row = static_ok & offer_any & fits
        compat[gi] = row
        price[gi] = np.where(row, row_price, np.inf)

    # -- FFD order: decreasing dominant share ------------------------------
    if G > 0:
        ref_cap = cap_eff.max(axis=0)
        ref_cap[ref_cap == 0] = 1.0
        dominant = (requests[:G] / ref_cap[None, :]).max(axis=1)
        order = np.argsort(-dominant, kind="stable")
        requests[:G] = requests[:G][order]
        counts[:G] = counts[:G][order]
        compat[:G] = compat[:G][order]
        price[:G] = price[:G][order]
        zone_allowed[:G] = zone_allowed[:G][order]
        captype_allowed[:G] = captype_allowed[:G][order]
        group_window[:G] = group_window[:G][order]
        max_per_node[:G] = max_per_node[:G][order]
        atomic[:G] = atomic[:G][order]
        group_list = [group_list[i] for i in order]

    # Per-pool kubelet maxPods clamps the pods axis of every candidate type
    # (parity: kubelet maxPods feeding types.go pods(); GetInstanceTypes is
    # per-NodePool in the reference for exactly this reason).
    capacity = cap_eff.astype(np.float32)
    kubelet = getattr(nodepool, "kubelet", None) if nodepool else None
    if kubelet is not None and kubelet.max_pods is not None:
        from ..models.resources import PODS as _PODS

        capacity = capacity.copy()
        capacity[:, _PODS] = np.minimum(capacity[:, _PODS], float(kubelet.max_pods))

    type_names = tensors.names
    type_window_out = available.copy()
    type_exotic = np.array(
        [
            getattr(t, "bare_metal", False)
            or getattr(t, "gpu_count", 0) > 0
            or getattr(t, "accelerator_count", 0) > 0
            for t in types
        ],
        dtype=bool,
    )

    # -- type-axis compaction ----------------------------------------------
    # Types NO group can use (incompatible, or infinite price everywhere)
    # can never be chosen by the scan, the refine pass, or the launch
    # ranking — yet they cost device work in every [.., T] program. A
    # category-pinned pool (the common case: c/m/r) uses ~half the catalog,
    # so compacting the axis cuts the scan's per-step width, the rank
    # program, and the upload bytes accordingly. The kept set is bucketed
    # on the {2^k, 1.5*2^k} ladder (bounded compile shapes as the usable
    # set drifts) and padded with never-usable filler (price inf, compat
    # false, empty windows). KARPENTER_TPU_PRUNE_TYPES=0 disables.
    if (
        G > 0
        and os.environ.get("KARPENTER_TPU_PRUNE_TYPES", "1") == "1"
    ):
        usable_t = compat[:G].any(axis=0) & np.isfinite(price[:G]).any(axis=0)
        kept = np.nonzero(usable_t)[0]
        K = len(kept)
        if 0 < K < T:
            TB = min(_ladder_bucket(K, minimum=64), T)
            if TB < T:
                Gb = compat.shape[0]
                cap_new = np.zeros((TB, capacity.shape[1]), dtype=np.float32)
                cap_new[:K] = capacity[kept]
                price_new = np.full((Gb, TB), np.inf, dtype=price.dtype)
                price_new[:, :K] = price[:, kept]
                compat_new = np.zeros((Gb, TB), dtype=bool)
                compat_new[:, :K] = compat[:, kept]
                win_new = np.zeros(
                    (TB,) + type_window_out.shape[1:], dtype=type_window_out.dtype
                )
                win_new[:K] = type_window_out[kept]
                exo_new = np.zeros(TB, dtype=bool)
                exo_new[:K] = type_exotic[kept]
                names_new = tuple(type_names[i] for i in kept) + tuple(
                    f"__pruned_{i}" for i in range(TB - K)
                )
                capacity, price, compat = cap_new, price_new, compat_new
                type_window_out, type_exotic, type_names = win_new, exo_new, names_new

    out = EncodedProblem(
        requests=requests,
        counts=counts,
        compat=compat,
        capacity=capacity,
        price=price,
        group_pods=group_list,
        type_names=type_names,
        zones=tensors.zones,
        nodepool=nodepool,
        group_window=group_window,
        type_window=type_window_out,
        group_zone_allowed=zone_allowed,
        group_captype_allowed=captype_allowed,
        max_per_node=max_per_node,
        atomic=atomic,
        # Exotic = never a silent launch *alternative*: bare-metal AND
        # accelerator hardware (reference filterExoticInstanceTypes,
        # instance.go:456-477 — GPU/Neuron types are excluded from ranked
        # options unless the committed choice itself is one, which the
        # ffd-side filter already special-cases via ``exotic[committed]``).
        type_exotic=type_exotic,
        unencodable=unencodable,
    )
    if ckey is not None:
        with _PROBLEM_CACHE_LOCK:
            _PROBLEM_CACHE[ckey] = out
            while len(_PROBLEM_CACHE) > _PROBLEM_CACHE_MAX:
                _PROBLEM_CACHE.popitem(last=False)
    return out


def pad_problem(p: EncodedProblem, group_bucket: Optional[int] = None) -> EncodedProblem:
    """Pad the group axis to a bucket size (a power of two), so a solve
    sees a handful of shapes."""
    G = p.requests.shape[0]
    GB = group_bucket or bucket(max(G, 1))
    if GB == G:
        return p
    pad = GB - G

    def padg(a, fill=0):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    return EncodedProblem(
        requests=padg(p.requests),
        counts=padg(p.counts),          # count 0 => no-op groups
        compat=padg(p.compat),
        capacity=p.capacity,
        price=padg(p.price, fill=np.inf),
        group_pods=p.group_pods,
        type_names=p.type_names,
        zones=p.zones,
        nodepool=p.nodepool,
        group_window=padg(p.group_window),
        type_window=p.type_window,
        group_zone_allowed=padg(p.group_zone_allowed),
        group_captype_allowed=padg(p.group_captype_allowed),
        max_per_node=padg(p.max_per_node, fill=1 << 30),
        atomic=padg(p.atomic) if p.atomic is not None else None,
        type_exotic=p.type_exotic,
        unencodable=p.unencodable,
    )
