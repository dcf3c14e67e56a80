"""The consolidation pass's device and host ops: batched "remove node i — do
its pods fit elsewhere?" on the device, the host validator behind it, and the
replacement paths.

The counterpart of the JAX package's ``ops/consolidate.py`` (BASELINE config
#4: multi-node consolidation of 5k live nodes):

- host encode: ``encode_cluster`` patches the journaled store's changed rows
  through the incremental encoder (``ops/encode_delta.py``) by default, or
  runs the full ``_encode_cluster`` (numpy, copied unchanged);
- ``repack_check``: the plain PyTorch version of the screen. The reference's
  vmap over candidates is a candidate batch dimension (chunked), its scan a
  loop over the slot axis;
- ``dispatch_screen`` / ``consolidatable``: the screen's inputs from the
  device-resident mirror (``ops/device_state.py``: uploaded once per encoder
  chain, patched row by row), or uploaded per ``ClusterTensors`` object for
  one without an encoder chain or with the mirror switched off; ONE launch
  of the hand-written repack kernel (``ops/repack_cuda.py``,
  ``csrc/repack.cu``) for a CUDA device and one device-to-host copy of the
  mask; the plain version for the CPU. There is no fallback from one to the
  other;
- ``repack_set_feasible``: the host validator (numpy, copied), the
  enforcement point behind the over-approximate screen, with the
  reference's ``free=``, ``return_free=`` and ``allow_overflow=`` for the
  replace paths;
- ``cheaper_replacement`` (one cheaper node for one node's pods) and
  ``replacement_for_groups`` (one new node absorbing a set's overflow):
  numpy, copied.

A large store of several (nodepool, zone) partitions encodes through the
partitioned encoder (``ops/encode_partition.py``), and its tensors screen
partition by partition, one repack launch and one device mirror each
(``_dispatch_screen_partitioned``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..models.resources import NUM_RESOURCES

_EPS = 1e-4
GMAX_DEFAULT = 32


_UNCAPPED = 1 << 30


@dataclass
class ZoneConstraint:
    """One zone-axis topology constraint of a pod group, validator-shaped.

    kind: 'anti' (self-matching zone anti-affinity: <=1 per zone, only
    zones with no matching pods), 'block' (non-self-matching anti term:
    zones with matching pods are off-limits, no per-zone cap otherwise),
    'spread' (DoNotSchedule max_skew budgeting), 'affinity' (only zones
    already holding matching pods; seed any single zone when none exist).
    ``match`` marks which groups' pods this constraint's selector counts.
    """

    kind: str
    skew: int
    match: np.ndarray   # [G] bool
    # The term's raw label selector (so a dumped constraint is debuggable).
    selector: Optional[dict] = None


@dataclass
class ClusterTensors:
    """Device-facing snapshot of live nodes + their pods."""

    node_names: list[str]
    nodepool_names: list[str]
    free: np.ndarray          # [N, R] allocatable - used
    price: np.ndarray         # [N] $/hr of the running offering
    requests: np.ndarray      # [G, R] deduped pod-group requests
    group_ids: np.ndarray     # [N, GMAX] int32 (0-padded; count 0 = unused)
    group_counts: np.ndarray  # [N, GMAX] int32
    compat: np.ndarray        # [G, N] bool: group may run on node
    disruption_cost: np.ndarray  # [N] float32 (consolidation.md:24-36 ranking)
    blocked: np.ndarray       # [N] bool: do-not-disrupt pod or overflow
    used_total: np.ndarray    # [N, R] resources of pods on the node
    group_pods: list[list] = field(default_factory=list)  # per group: pods
    # -- topology (repack is topology-aware, not blanket-blocked) --
    group_node_count: np.ndarray = None  # [G, N] int32 pods of g on n
    mpn: np.ndarray = None               # [G] int32 hostname cap (_UNCAPPED = none)
    hn_match: np.ndarray = None          # [G, G] bool: h's pods count toward
    #                                      g's hostname-selector occupancy
    cap: np.ndarray = None               # [G, N] float32 screen cap:
    #                                      0 = incompatible, else remaining
    #                                      hostname headroom (BIG = uncapped)
    zone_constraints: list = field(default_factory=list)  # per g: [ZoneConstraint]
    node_zone: list = field(default_factory=list)         # [N] zone names
    zones: list = field(default_factory=list)             # zone vocabulary
    node_zone_idx: np.ndarray = None     # [N] int32 index into zones
    node_captype: list = field(default_factory=list)      # [N] capacity types
    node_gang: np.ndarray = None         # [N] int32 MAX gang ordinal among the
    #                                      node's pods (0 = no gang member)

    def has_topology(self) -> bool:
        return bool((self.mpn < _UNCAPPED).any()) or any(
            c for c in self.zone_constraints
        )


def encode_cluster(cluster, catalog, gmax: int = GMAX_DEFAULT,
                   pods_by_node=None, incremental: Optional[bool] = None,
                   rev_floor: Optional[int] = None,
                   ) -> Optional[ClusterTensors]:
    """Snapshot ready nodes with claims into consolidation tensors.

    Incremental by default when the cluster exposes the change journal
    (``state.Cluster``): a persistent per-(cluster, catalog) encoder patches
    dirty node rows from the journal instead of re-tensorizing every node
    per pass, falling back to the full encode on journal overflow, catalog
    change, or heavy churn (``ops/encode_delta.py``).
    ``KARPENTER_TPU_INCREMENTAL_ENCODE=0`` or ``incremental=False`` takes
    the full encode. ``pods_by_node`` lets a caller share an already-built
    per-pass pod view, taken at revision ``rev_floor``.

    A store of more than one (nodepool, zone) partition and at least
    ``KARPENTER_TPU_PARTITION_MIN_NODES`` (8,192) nodes encodes through
    one incremental chain per partition, merged into one emission
    (``ops/encode_partition.py``; ``KARPENTER_TPU_PARTITION_ENCODE`` 1
    forces it, 0 turns it off)."""
    import os

    if incremental is None:
        incremental = (
            os.environ.get("KARPENTER_TPU_INCREMENTAL_ENCODE", "1") == "1"
            and getattr(cluster, "changes_since", None) is not None
        )
    if incremental:
        from .encode_delta import incremental_encode_cluster
        from .encode_partition import partition_encode_active, partitioned_encode_cluster

        if partition_encode_active(cluster):
            return partitioned_encode_cluster(
                cluster, catalog, gmax, pods_by_node=pods_by_node, rev_floor=rev_floor,
            )
        return incremental_encode_cluster(
            cluster, catalog, gmax, pods_by_node=pods_by_node, rev_floor=rev_floor,
        )
    return _encode_cluster(cluster, catalog, gmax, pods_by_node=pods_by_node)


def _encode_cluster(cluster, catalog, gmax: int,
                    pods_by_node=None, node_filter=None) -> Optional[ClusterTensors]:
    from ..models import labels as lbl

    # A node whose claim is already draining (deleted) is neither a
    # candidate nor a repack target — its capacity is going away.
    # ``node_filter`` (a name set) scopes the encode to one partition's
    # nodes (ops/encode_partition.py); eligibility rules are identical.
    claims = {c.name: c for c in cluster.snapshot_claims()}
    nodes = [
        n
        for n in cluster.snapshot_nodes()
        if n.ready
        and not n.cordoned
        and n.nodeclaim_name in claims
        and not claims[n.nodeclaim_name].deleted
        and (node_filter is None or n.name in node_filter)
    ]
    if not nodes:
        return None
    N = len(nodes)

    # ---- flatten pods over nodes; everything per-pod below is ONE pass ----
    if pods_by_node is None:
        pods_by_node = cluster.pods_by_node()
    node_pods = [pods_by_node.get(n.name, ()) for n in nodes]
    pods_flat = [p for plist in node_pods for p in plist]
    P = len(pods_flat)
    node_idx = np.repeat(
        np.arange(N, dtype=np.int64),
        np.fromiter((len(pl) for pl in node_pods), dtype=np.int64, count=N),
    )

    blocked = np.zeros(N, dtype=bool)
    disruption_cost = np.zeros(N, dtype=np.float32)
    node_gang = np.zeros(N, dtype=np.int32)
    used_total = np.zeros((N, NUM_RESOURCES), dtype=np.float32)
    group_ids = np.zeros((N, gmax), dtype=np.int32)
    group_counts = np.zeros((N, gmax), dtype=np.int32)
    group_list: list[list] = []
    if P:
        # interned (scheduling shape, labels) token per pod — one dict hash
        # per pod LIFETIME (memoized on the pod, version-guarded)
        tok = np.fromiter((p.group_token() for p in pods_flat), dtype=np.int64, count=P)
        uniq, gidx = np.unique(tok, return_inverse=True)
        G = len(uniq)
        order = np.argsort(gidx, kind="stable")
        bounds = np.searchsorted(gidx[order], np.arange(G + 1))
        group_list = [
            [pods_flat[i] for i in order[bounds[g]: bounds[g + 1]]]
            for g in range(G)
        ]
        requests = np.stack([g[0].requests.v for g in group_list]).astype(np.float32)
        # per-node totals: every pod of group g shares requests[g] exactly
        np.add.at(used_total, node_idx, requests[gidx])
        pcost = np.fromiter(
            (1.0 + p.deletion_cost() + p.priority / 1000.0 for p in pods_flat),
            dtype=np.float32, count=P,
        )
        np.add.at(disruption_cost, node_idx, pcost)
        # co-located groups move as ONE unit; the repack simulator places
        # per-pod, so nodes holding them are conservatively not disruption
        # candidates (single-replace still moves the whole node's pods to
        # one replacement, which is sound, but blocked gates both)
        flags = np.fromiter(
            (p.do_not_disrupt() or p.hostname_colocated() or p.gang_locked()
             for p in pods_flat),
            dtype=bool, count=P,
        )
        np.logical_or.at(blocked, node_idx, flags)
        # MAX gang ordinal per node (0 = none): consolidation treats a live
        # gang's nodes atomically
        ords = np.fromiter(
            (p.gang_ordinal() for p in pods_flat), dtype=np.int32, count=P,
        )
        np.maximum.at(node_gang, node_idx, ords)
        # (node, group) multiset -> per-node slots + [G, N] counts via one
        # unique over packed pairs (already sorted by node, then group)
        pair = node_idx * G + gidx
        upair, pcnt = np.unique(pair, return_counts=True)
        pn = (upair // G).astype(np.int64)
        pg = (upair % G).astype(np.int64)
        group_node_count = np.zeros((G, N), dtype=np.int32)
        group_node_count[pg, pn] = pcnt
        slot = np.arange(len(upair)) - np.searchsorted(pn, pn)
        keep = slot < gmax
        group_ids[pn[keep], slot[keep]] = pg[keep]
        group_counts[pn[keep], slot[keep]] = pcnt[keep]
        # too fragmented to encode; never silently skip
        blocked |= np.bincount(pn, minlength=N) > gmax
    else:
        G = 1
        requests = np.zeros((G, NUM_RESOURCES), dtype=np.float32)
        group_node_count = np.zeros((G, N), dtype=np.int32)

    # group x node compatibility: labels + taints, evaluated once per
    # distinct node CLASS (labels projected onto requirement-referenced
    # keys, plus taints) and scattered to nodes — thousands of nodes from a
    # handful of pools collapse to a few classes, so the G x N Python loop
    # becomes G x S with S tiny.
    compat = np.zeros((G, N), dtype=bool)
    if group_list:
        group_reqs = [g[0].requirements() for g in group_list]
        ref_keys = sorted({k for req in group_reqs for k in req.keys()})
        class_of_node = np.zeros(N, dtype=np.int64)
        class_idx: dict[tuple, int] = {}
        class_labels: list[dict] = []
        class_taints: list[tuple] = []
        for ni, node in enumerate(nodes):
            key = (
                tuple(node.labels.get(k) for k in ref_keys),
                tuple(node.taints),
            )
            ci = class_idx.get(key)
            if ci is None:
                ci = class_idx[key] = len(class_labels)
                class_labels.append(
                    {k: v for k, v in zip(ref_keys, key[0]) if v is not None}
                )
                class_taints.append(key[1])
            class_of_node[ni] = ci
        cmat = np.zeros((G, len(class_labels)), dtype=bool)
        for gi, req in enumerate(group_reqs):
            rep = group_list[gi][0]
            for ci in range(len(class_labels)):
                cmat[gi, ci] = req.satisfied_by_labels(
                    class_labels[ci]
                ) and rep.tolerates_all(class_taints[ci])
        compat = cmat[:, class_of_node]

    # -- topology metadata -------------------------------------------------
    reps = [pods[0] for pods in group_list]
    if reps:
        mpn = np.array([r.hostname_cap() for r in reps], dtype=np.int64)
        mpn = np.minimum(mpn, _UNCAPPED).astype(np.int32)
    else:
        # podless cluster: G is padded to 1, so mpn must be too (the cap
        # loop below indexes mpn[gi] for gi < G)
        mpn = np.full(G, _UNCAPPED, dtype=np.int32)

    def _matches(selector, pod) -> bool:
        return all(pod.labels.get(k) == v for k, v in selector.items())

    hn_match = np.zeros((G, G), dtype=bool)
    for gi, rep in enumerate(reps):
        if mpn[gi] >= _UNCAPPED:
            continue
        selectors = [
            t.label_selector
            for t in list(rep.anti_affinity) + list(rep.topology_spread)
            if getattr(t, "topology_key", "") == lbl.HOSTNAME
        ]
        for hj, other in enumerate(reps):
            hn_match[gi, hj] = any(_matches(sel, other) for sel in selectors)

    zone_constraints: list[list[ZoneConstraint]] = []
    for gi, rep in enumerate(reps):
        cons: list[ZoneConstraint] = []
        for a in rep.anti_affinity:
            if a.topology_key != lbl.TOPOLOGY_ZONE:
                continue
            row = np.array([_matches(a.label_selector, o) for o in reps])
            cons.append(
                ZoneConstraint(
                    kind="anti" if a.matches(rep) else "block", skew=1, match=row,
                    selector=dict(a.label_selector),
                )
            )
        # ALL zone terms, not just zone_topology_term()'s highest-precedence
        # one — a pod may carry several spreads/affinities, and dropping any
        # would make the repack proof unsound
        for c in rep.topology_spread:
            if (
                c.topology_key == lbl.TOPOLOGY_ZONE
                and c.when_unsatisfiable == "DoNotSchedule"
            ):
                row = np.array([_matches(c.label_selector, o) for o in reps])
                cons.append(
                    ZoneConstraint(kind="spread", skew=max(int(c.max_skew), 1),
                                   match=row, selector=dict(c.label_selector))
                )
        for a in rep.affinity:
            if a.topology_key == lbl.TOPOLOGY_ZONE:
                row = np.array([_matches(a.label_selector, o) for o in reps])
                cons.append(ZoneConstraint(kind="affinity", skew=0, match=row,
                                           selector=dict(a.label_selector)))
        zone_constraints.append(cons)

    # screen cap: compat gated, hostname headroom subtracted (the device
    # screen may over-approximate zone feasibility — the host validator is
    # the enforcement point — but hostname headroom is cheap and tightens it)
    cap = np.where(compat, np.float32(_UNCAPPED), np.float32(0.0))
    for gi in range(G):
        if mpn[gi] >= _UNCAPPED:
            continue
        occupied = hn_match[gi].astype(np.int32) @ group_node_count  # [N]
        cap[gi] = np.where(
            compat[gi], np.maximum(mpn[gi] - occupied, 0).astype(np.float32), 0.0
        )

    zone_names: list[str] = []
    zidx: dict[str, int] = {}
    node_zone: list[str] = []
    node_zone_idx = np.zeros(N, dtype=np.int32)
    for ni, node in enumerate(nodes):
        z = node.zone()
        if z not in zidx:
            zidx[z] = len(zone_names)
            zone_names.append(z)
        node_zone.append(z)
        node_zone_idx[ni] = zidx[z]

    from . import overhead as _overhead

    alloc = _overhead.apply(
        np.stack([n.allocatable.v for n in nodes]).astype(np.float32)
    )
    free = alloc - used_total
    price = np.zeros(N, dtype=np.float32)
    # price memo per (type, zone, captype): thousands of nodes collapse to
    # the distinct offerings actually running
    _price_memo: dict[tuple, float] = {}
    for ni, node in enumerate(nodes):
        ct_ = node.capacity_type()
        pkey = (node.instance_type(), node.zone(), ct_)
        hit = _price_memo.get(pkey)
        if hit is None:
            it = catalog.get(pkey[0])
            if it is None:
                hit = float("nan")  # sentinel: unknown type blocks the node
            elif ct_ == lbl.CAPACITY_TYPE_RESERVED:
                # pre-paid: running cost 0, same as the reserved offering
                # price — otherwise a reserved node looks replaceable by its
                # own reservation (win_price 0 < on-demand) and churns forever
                hit = 0.0
            elif ct_ == lbl.CAPACITY_TYPE_SPOT:
                hit = catalog.pricing.spot_price(it, pkey[1])
            else:
                hit = catalog.pricing.on_demand_price(it)
            _price_memo[pkey] = hit
        if hit != hit:  # NaN: type missing from the catalog snapshot
            price[ni] = 0.0
            blocked[ni] = True
        else:
            price[ni] = hit

    return ClusterTensors(
        node_names=[n.name for n in nodes],
        nodepool_names=[n.nodepool_name for n in nodes],
        free=free,
        price=price,
        requests=requests,
        group_ids=group_ids,
        group_counts=group_counts,
        compat=compat,
        disruption_cost=disruption_cost,
        blocked=blocked,
        used_total=used_total,
        group_pods=group_list,
        group_node_count=group_node_count,
        mpn=mpn,
        hn_match=hn_match,
        cap=cap,
        zone_constraints=zone_constraints,
        node_zone=node_zone,
        zones=zone_names,
        node_zone_idx=node_zone_idx,
        node_captype=[n.capacity_type() for n in nodes],
        node_gang=node_gang,
    )


def _cap_f32(cap: torch.Tensor) -> torch.Tensor:
    """The screen cap as float32: a bool compat matrix is 2^30 (uncapped)
    where compatible and 0 elsewhere; any other dtype (the uint16 wire, a
    float headroom) is its value."""
    if cap.dtype == torch.bool:
        return torch.where(cap, torch.tensor(float(_UNCAPPED), device=cap.device),
                           torch.tensor(0.0, device=cap.device))
    if cap.dtype == torch.uint16:
        cap = cap.to(torch.int32)
    return cap.to(torch.float32)


def repack_check(
    free: torch.Tensor,          # [N, R] float32
    requests: torch.Tensor,      # [G, R] float32
    group_ids: torch.Tensor,     # [N, S] int32 (node-indexed slot table)
    group_counts: torch.Tensor,  # [N, S] int32
    cap: torch.Tensor,           # [G, N] bool compat, or uint16/float cap
    #                              (0 = incompatible, else max additional
    #                              pods of g on n — the hostname headroom)
    candidates: torch.Tensor,    # [C] int node indices
    chunk: int = 512,
) -> torch.Tensor:
    """ok[C] (bool): the candidate's pods all fit on the other nodes' free
    capacity. The plain version of the repack kernel, with the reference's
    arithmetic in the reference's order: per slot, k[n] =
    min_r floor((free + 1e-4) / req) over req > 0, clamped to [0, 2^30],
    min with the cap row, 0 at the candidate itself; an exclusive prefix sum
    (int64) gives first-fit placements; ``free -= place * req``. Candidates
    run ``chunk`` at a time as a batch dimension; slots run in order.

    The same values, with less work: only the resource axes some group
    requests are carried (an axis no group requests has an infinite fit and
    is never debited); a slot whose count is 0 for every candidate of the
    chunk (it places nothing and debits nothing) is skipped, since the
    mirror pads the slot axis to 8 and large clusters carry one or two live
    slots; and the first slot a chunk runs reads each group's fit on the
    undebited free from one [G, N] table, so a candidate's own copy of free
    is made only when a later slot needs it."""
    axes = (requests > 0).any(dim=0)
    if not bool(axes.any()):
        axes[0] = True  # no request at all: one (infinite-fit) axis stands for all
    free, requests = free[:, axes], requests[:, axes]
    N, R = free.shape
    S = group_ids.shape[1]
    dev = free.device
    cap_f = _cap_f32(cap)
    with_req = requests > 0
    safe_req = torch.where(with_req, requests, torch.ones_like(requests))
    inf = torch.tensor(float("inf"), device=dev)

    def fit(f, g):
        """k before the self term: [..., N] from free ``f`` [..., N, R]."""
        ratio = torch.where(with_req[g].unsqueeze(-2),
                            torch.floor((f + _EPS) / safe_req[g].unsqueeze(-2)), inf)
        return torch.minimum(ratio.amin(dim=-1).clamp(0.0, float(_UNCAPPED)), cap_f[g])

    base_fit = None  # [G, N]: each group's fit on the undebited free
    out = []
    for start in range(0, candidates.shape[0], chunk):
        cand = candidates[start:start + chunk].long()
        B = cand.shape[0]
        rows = torch.arange(B, device=dev)
        gids = group_ids[cand].long()
        gcnt = group_counts[cand].long()
        live = [s for s in range(S) if bool((gcnt[:, s] != 0).any())]
        free_c = None  # [B, N, R] once a slot has debited
        leftover = torch.zeros(B, dtype=torch.int64, device=dev)
        for i, s in enumerate(live):
            g = gids[:, s]
            cnt = gcnt[:, s]
            if free_c is None:
                if base_fit is None:
                    base_fit = torch.stack([fit(free, torch.tensor(h, device=dev))
                                            for h in range(requests.shape[0])])
                k = base_fit[g]                                  # [B, N]
            else:
                k = fit(free_c, g)
            k[rows, cand] = 0.0
            k = k.to(torch.int64)
            cum_before = torch.cumsum(k, dim=1) - k
            place = torch.minimum((cnt.unsqueeze(1) - cum_before).clamp(min=0), k)
            leftover += cnt - place.sum(dim=1)
            if i + 1 < len(live):
                debit = place.to(torch.float32).unsqueeze(2) * requests[g].unsqueeze(1)
                free_c = (free.unsqueeze(0) if free_c is None else free_c) - debit
        out.append(leftover == 0)
    if not out:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    return torch.cat(out)


def _repack_backend(device: torch.device) -> str:
    """The backend that screens on ``device``: a pure function of the
    device. CUDA runs the repack kernel; the CPU runs the plain version."""
    if device.type == "cuda":
        return "cuda-repack"
    if device.type == "cpu":
        return "torch-plain"
    raise ValueError(f"no consolidation screen for device {device}")


def _resolve_device(device) -> torch.device:
    """``None`` means CUDA; CUDA that is missing raises (the CPU runs only
    when asked for)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to screen on the CPU"
        )
    return dev


def screen_cap_wire(ct: ClusterTensors) -> np.ndarray:
    """The screen's [G, N] capability matrix in wire form. uint16: the cap is
    the largest upload of the sweep; 60000 == uncapped (no node holds that
    many pods), exact otherwise."""
    screen_cap = ct.cap if ct.cap is not None else ct.compat
    if screen_cap.dtype != bool:
        screen_cap = np.minimum(screen_cap, 60000).astype(np.uint16)
    return screen_cap


def live_slots(group_counts: np.ndarray) -> np.ndarray:
    """Per-row LIVE slot count: one past the last nonzero slot."""
    gmax = group_counts.shape[-1]
    return np.where(
        group_counts > 0, np.arange(gmax, dtype=np.int32) + 1, 0
    ).max(axis=-1).astype(np.int32)


def live_slot_width(group_counts: np.ndarray) -> int:
    """Smallest power-of-two slot width covering every LIVE slot (one past
    the last nonzero — exact for any table, since zero-count slots are
    no-ops wherever they sit). A production cluster's nodes carry a handful
    of distinct pod groups (the 5k-node config4 cluster: 1), while the
    tensors pad to GMAX=32."""
    if not group_counts.size:
        return 1
    s = int(live_slots(group_counts).max())
    w = 1
    while w < s:
        w *= 2
    return min(w, group_counts.shape[1] if group_counts.ndim == 2 else w)


#: provenance of the last screen: backend, device name, residency of its
#: inputs, ms per stage
LAST_SCREEN: dict = {}

#: Ratcheted screen-shape buckets: each axis's bucket may only grow beyond
#: the current need (bounded at 4x it), so a cluster that shrank across a
#: ladder boundary keeps the mirror's larger, inert-padded shapes, and one
#: giant cluster cannot tax every later tiny one forever.
_SCREEN_BUCKET_HW: dict[str, int] = {}


def _screen_bucket_hw(kind: str, value: int) -> int:
    cur = _SCREEN_BUCKET_HW.get(kind, 0)
    if value > cur:
        _SCREEN_BUCKET_HW[kind] = value
        return value
    return min(cur, value * 4)


def reset_screen_buckets() -> None:
    """Tests: forget the ratcheted screen-shape buckets."""
    _SCREEN_BUCKET_HW.clear()


class _PendingScreen:
    """An in-flight repack screen: ``wait()`` copies the mask to the host
    (the one device-to-host copy) and returns the can_delete mask."""

    def __init__(self, wait):
        self.wait = wait


def consolidatable(ct: ClusterTensors, chunk: int = 512, device=None) -> np.ndarray:
    """can_delete[N]: the repack screen over every node. ``device=None``
    means CUDA (the repack kernel) and raises where there is none;
    ``device="cpu"`` runs the plain version."""
    return dispatch_screen(ct, chunk, device).wait()


def dispatch_screen(ct: ClusterTensors, chunk: int = 512, device=None) -> _PendingScreen:
    """Launch the screen and defer the device-to-host copy of the mask to
    ``wait()``. The mask is memoized per ``ct`` object and backend (the
    answer is a pure function of the tensors).

    Partitioned tensors (``ops/encode_partition.py``, more than one
    partition) screen each partition against its OWN device mirror and
    concatenate the masks (``KARPENTER_TPU_PARTITION_SCREEN=0`` screens the
    merged tensors whole). A partition-local repack is a sound tightening of
    the global screen: a node whose pods fit on the other nodes of its
    partition fits on the other nodes of the cluster, so every node it
    passes the global screen passes too; the host validator
    (``repack_set_feasible`` on the merged tensors) stays the enforcement
    point either way."""
    import os

    dev = _resolve_device(device)
    backend = _repack_backend(dev)
    t0 = time.perf_counter()
    parts = ct.__dict__.get("_partitions")
    if parts and len(parts) > 1 and os.environ.get(
        "KARPENTER_TPU_PARTITION_SCREEN", "1"
    ) == "1":
        return _dispatch_screen_partitioned(ct, parts, chunk, dev, f"partitioned({backend})", t0)
    memo = ct.__dict__.get("_screen_mask_memo")
    if memo is not None and memo[1] == backend:
        from . import device_state

        out = memo[0].copy()
        # the mirror is still current for this ct: the pass was answered
        # with the state resident and no bytes moved
        device_state.note_hit(ct, dev)
        LAST_SCREEN.clear()
        LAST_SCREEN.update(backend=backend, device=_device_name(dev), memo_hit=True,
                           wall_ms=(time.perf_counter() - t0) * 1e3)
        return _PendingScreen(wait=lambda: out)
    waiter, stages = _screen(ct, chunk, dev)
    done: dict = {}

    def _wait() -> np.ndarray:
        if "out" not in done:
            t_fetch = time.perf_counter()
            out = waiter()
            stages["fetch_ms"] = (time.perf_counter() - t_fetch) * 1e3
            done["out"] = out
            ct.__dict__["_screen_mask_memo"] = (out.copy(), backend)
            LAST_SCREEN.clear()
            LAST_SCREEN.update(backend=backend, device=_device_name(dev), memo_hit=False,
                               wall_ms=(time.perf_counter() - t0) * 1e3, **stages)
        return done["out"]

    return _PendingScreen(wait=_wait)


def _dispatch_screen_partitioned(ct: ClusterTensors, parts, chunk: int, dev: torch.device,
                                 backend: str, t0: float) -> _PendingScreen:
    """Per-partition screen: every partition's screen is dispatched (its
    inputs from that partition's own device mirror, its kernel launched)
    before any mask is fetched, and the global mask is the concatenation in
    the partitions' node-axis order. The merged ``ct`` keeps its own mask
    memo, under ``backend`` (``partitioned(<backend>)``), apart from the
    partitions' memos and from a whole screen of the same tensors."""
    N = len(ct.node_names)
    off = 0
    for _key, part_ct, p_off, n in parts:
        if p_off != off or n != len(part_ct.node_names):
            raise ValueError(f"the partitions do not tile the node axis at offset {off}")
        off += n
    if off != N:
        raise ValueError(f"the partitions cover {off} of {N} nodes")
    memo = ct.__dict__.get("_screen_mask_memo")
    if memo is not None and memo[1] == backend:
        out = memo[0].copy()
        LAST_SCREEN.clear()
        LAST_SCREEN.update(backend=backend, device=_device_name(dev), memo_hit=True,
                           partitions=len(parts), wall_ms=(time.perf_counter() - t0) * 1e3)
        return _PendingScreen(wait=lambda: out)
    pendings = [(p_off, n, dispatch_screen(part_ct, chunk, dev))
                for _key, part_ct, p_off, n in parts]
    done: dict = {}

    def _wait() -> np.ndarray:
        if "out" not in done:
            out = np.zeros(N, dtype=bool)
            screens = []
            for p_off, n, pending in pendings:
                out[p_off:p_off + n] = pending.wait()
                screens.append(dict(LAST_SCREEN))
            done["out"] = out
            ct.__dict__["_screen_mask_memo"] = (out.copy(), backend)
            LAST_SCREEN.clear()
            LAST_SCREEN.update(backend=backend, device=_device_name(dev), memo_hit=False,
                               partitions=len(parts), residency="partitioned",
                               part_screens=screens,
                               wall_ms=(time.perf_counter() - t0) * 1e3)
        return done["out"]

    return _PendingScreen(wait=_wait)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def screen_arrays(ct: ClusterTensors) -> dict:
    """The screen's inputs as host arrays, in ``repack_check``'s argument
    order: free, requests, the slot tables sliced to the live width, the
    uint16 (or bool) cap wire and the candidate vector (every node)."""
    N = len(ct.node_names)
    S = live_slot_width(ct.group_counts)
    G = ct.requests.shape[0]
    gids = np.ascontiguousarray(ct.group_ids[:, :S], dtype=np.int32)
    gcounts = np.ascontiguousarray(ct.group_counts[:, :S], dtype=np.int32)
    live = gcounts > 0
    if live.any() and not ((gids[live] >= 0) & (gids[live] < G)).all():
        raise ValueError("a live slot names a group outside [0, G)")
    return {
        "free": np.ascontiguousarray(ct.free, dtype=np.float32),
        "requests": np.ascontiguousarray(ct.requests, dtype=np.float32),
        "group_ids": gids,
        "group_counts": gcounts,
        "cap": np.ascontiguousarray(screen_cap_wire(ct)),
        "candidates": np.arange(N, dtype=np.int32),
    }


def _device_inputs(ct: ClusterTensors, dev: torch.device) -> dict:
    """``screen_arrays`` on ``dev``, uploaded once per ``ct`` object."""
    memo = ct.__dict__.setdefault("_screen_device", {})
    hit = memo.get(dev)
    if hit is None:
        hit = memo[dev] = {k: torch.from_numpy(v).to(dev)
                           for k, v in screen_arrays(ct).items()}
    return hit


def _screen(ct: ClusterTensors, chunk: int, dev: torch.device):
    """The screen body: returns (waiter, stage ms and residency). The inputs
    come from the device-resident mirror (hit, patch or upload), or, for a
    ``ct`` without an encoder chain or with the mirror switched off, from an
    upload of this ``ct``'s arrays. The mirror's buffers are padded: rows
    past the live ``N`` have zero free and zero cap, groups past ``G`` zero
    requests, slots past the live width count 0; the candidates are the
    live rows only, so the mask is the unpadded screen's answer. The
    inputs' device picks the kernel or the plain version inside
    ``repack_cuda.repack_check``; there is no fallback between them."""
    from . import device_state, repack_cuda

    t0 = time.perf_counter()
    resident, residency = device_state.acquire_screen_tensors(ct, dev)
    if resident is not None:
        free, requests, gids, gcounts, cap, cand, _n_live = resident
    else:
        x = _device_inputs(ct, dev)
        free, requests, gids, gcounts, cap, cand = (
            x[k] for k in ("free", "requests", "group_ids", "group_counts", "cap",
                           "candidates"))
    stages = {"residency": residency, "upload_ms": (time.perf_counter() - t0) * 1e3}
    t1 = time.perf_counter()
    ok = repack_cuda.repack_check(free, requests, gids, gcounts, cap, cand, chunk=chunk)
    stages["launch_ms"] = (time.perf_counter() - t1) * 1e3
    blocked = ct.blocked

    def waiter() -> np.ndarray:
        # an empty node is trivially "repackable"; emptiness is handled
        # separately
        return ok.cpu().numpy() & ~blocked

    return waiter, stages


def repack_feasible_numpy(ct: ClusterTensors, free: np.ndarray, i: int) -> Optional[np.ndarray]:
    """Host-side re-validation of a single candidate against a *current* free
    matrix. Returns the updated free matrix on success, None on failure."""
    return repack_set_feasible(ct, [i], free=free, return_free=True)


def _zone_budgets(
    con: ZoneConstraint, zcnt: np.ndarray, elig: Optional[np.ndarray] = None
) -> np.ndarray:
    """Per-zone placement budget for one constraint given current matching
    counts ``zcnt[Z]``. Budgets are sound caps: any assignment within them
    keeps the constraint satisfied (spread uses the initial-minimum bound,
    which is conservative but never wrong).

    ``elig[Z]`` marks zones holding at least one surviving node compatible
    with the placing group. Spread skew is computed over eligible domains
    only (a zero count from a zone the group can never schedule into must
    not pin the budget — the reference's skew domain is the set of eligible
    topology values)."""
    Z = zcnt.shape[0]
    if con.kind == "anti":
        return np.where(zcnt == 0, 1, 0).astype(np.int64)
    if con.kind == "block":
        return np.where(zcnt == 0, np.int64(_UNCAPPED), 0)
    if con.kind == "spread":
        if elig is not None and elig.any():
            floor = int(zcnt[elig].min())
        else:
            floor = int(zcnt.min()) if Z else 0
        return np.maximum(floor + con.skew - zcnt, 0).astype(np.int64)
    if con.kind == "affinity":
        if (zcnt > 0).any():
            return np.where(zcnt > 0, np.int64(_UNCAPPED), 0)
        # no matching pods anywhere: seed exactly one zone (the caller's
        # greedy fill naturally lands the whole group in the first zone
        # that fits once we mark budgets single-zone-exclusive)
        return np.full(Z, np.int64(-1))  # sentinel: single-seed mode
    return np.full(Z, np.int64(_UNCAPPED))


def repack_set_feasible(
    ct: ClusterTensors,
    candidate_ids,
    free: Optional[np.ndarray] = None,
    return_free: bool = False,
    allow_overflow: bool = False,
):
    """Can ALL candidates' pods repack onto the *surviving* nodes (every
    non-candidate)? This is the reference's multi-node consolidation
    simulation (designs/consolidation.md:9-15): the whole set is removed at
    once, so a candidate can never serve as a repack target for another.

    The simulation is TOPOLOGY-AWARE. Hostname-capped groups respect
    per-node selector-matched occupancy (updated as pods land); zone
    anti-affinity / DoNotSchedule spread / zone affinity place within sound
    per-zone budgets computed from live counts after the candidate set's
    removal. This is the enforcement point behind the (possibly
    over-approximate) device screen.

    ``allow_overflow=True`` returns ``(free, overflow)`` where overflow maps
    group id -> pods that found no survivor — the N->1 replacement path
    absorbs them on one new node. Without it, any leftover fails the check.

    ``free`` starts the simulation from a caller's current free matrix
    instead of ``ct.free``; ``return_free=True`` returns the free matrix
    after the placement (None when the set does not repack).

    Boolean verdicts are memoized per (ct emission, candidate tuple): the
    answer is a pure function of the tensors, and the binary search over
    cost-ordered prefixes re-validates the same prefixes against the same
    unchanged ct.
    """
    _bool_mode = free is None and not return_free and not allow_overflow
    _memo = _mkey = None
    if _bool_mode:
        _memo = ct.__dict__.setdefault("_repack_memo", {})
        _mkey = tuple(candidate_ids)
        hit = _memo.get(_mkey)
        if hit is not None:
            return hit
    free = (ct.free if free is None else free).copy()
    N = free.shape[0]
    G = ct.requests.shape[0]
    Z = max(len(ct.zones), 1)
    survivors = np.ones(N, dtype=bool)
    for c in candidate_ids:
        survivors[c] = False

    has_topo = ct.cap is not None and ct.has_topology()
    cap_work = None
    zone_cnt = None
    if has_topo:
        cap_work = ct.cap.astype(np.int64).copy()
        # matching counts per (group, zone) with the candidate set removed
        surv_cnt = ct.group_node_count * survivors[None, :]  # [G, N]
        per_zone = np.zeros((G, Z), dtype=np.int64)
        for z in range(Z):
            per_zone[:, z] = surv_cnt[:, ct.node_zone_idx == z].sum(axis=1)
        # zone_cnt[g][ci] = counts matching constraint ci of group g
        zone_cnt = [
            [con.match.astype(np.int64) @ per_zone for con in cons]
            for cons in (ct.zone_constraints or [[] for _ in range(G)])
        ]

    overflow: dict[int, int] = {}
    _elig_zone_cache: dict[int, np.ndarray] = {}

    def _place_group(g: int, cnt: int) -> int:
        """First-fit cnt pods of group g onto survivors; returns leftover."""
        nonlocal free
        req = ct.requests[g]
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(
                req[None, :] > 0,
                np.floor((free + _EPS) / np.where(req > 0, req, 1.0)[None, :]),
                np.inf,
            )
        # clamp BEFORE the int cast: an all-zero request (BestEffort group)
        # has ratio inf, and inf.astype(int64) is garbage
        k = np.clip(np.where(survivors, ratio.min(axis=1), 0), 0, float(_UNCAPPED))
        k = k.astype(np.int64)
        if has_topo:
            k = np.minimum(k, cap_work[g])
        else:
            k = np.where(ct.compat[g], k, 0)
        cons = ct.zone_constraints[g] if (has_topo and ct.zone_constraints) else []
        if not cons:
            cum_before = np.cumsum(k) - k
            place = np.clip(cnt - cum_before, 0, k)
        else:
            if g not in _elig_zone_cache:
                ok_nodes = ct.compat[g] & survivors  # [N]
                _elig_zone_cache[g] = np.array(
                    [bool(ok_nodes[ct.node_zone_idx == z].any()) for z in range(Z)]
                )
            elig_z = _elig_zone_cache[g]
            budgets = [
                _zone_budgets(c, zone_cnt[g][ci], elig=elig_z)
                for ci, c in enumerate(cons)
            ]
            seed = [b for b in budgets if (b < 0).any()]  # affinity seed mode
            budgets = [b for b in budgets if not (b < 0).any()]
            place = np.zeros(N, dtype=np.int64)
            remaining = cnt

            def zone_quota(z: int) -> int:
                q = min((int(b[z]) for b in budgets), default=_UNCAPPED)
                return max(q, 0)

            zone_order = range(Z)
            if seed:
                # zone affinity with no matching pods anywhere: the whole
                # group must land in ONE zone; try zones by available fit
                fit_per_zone = [
                    int(k[ct.node_zone_idx == z].sum()) for z in range(Z)
                ]
                zone_order = sorted(range(Z), key=lambda z: -fit_per_zone[z])[:1]
            for z in zone_order:
                if remaining <= 0:
                    break
                quota = min(zone_quota(z), remaining)
                if quota <= 0:
                    continue
                in_z = ct.node_zone_idx == z
                kz = np.where(in_z, k, 0)
                cum_before = np.cumsum(kz) - kz
                take = np.clip(quota - cum_before, 0, kz)
                place += take
                remaining -= int(take.sum())
        placed = int(place.sum())
        free -= place[:, None] * req[None, :]
        if has_topo and placed:
            # hostname occupancy: landed pods count toward every group whose
            # hostname selectors match this group's labels
            hit = ct.hn_match[:, g]
            if hit.any():
                cap_work[hit] = np.maximum(cap_work[hit] - place[None, :], 0)
            # zone occupancy for every constraint counting this group
            placed_per_zone = np.zeros(Z, dtype=np.int64)
            for z in range(Z):
                placed_per_zone[z] = int(place[ct.node_zone_idx == z].sum())
            for g2 in range(G):
                for ci, con in enumerate(ct.zone_constraints[g2]):
                    if con.match[g]:
                        zone_cnt[g2][ci] += placed_per_zone
        return cnt - placed

    # Aggregate each group's pods across the WHOLE candidate set and place
    # group totals (group-major order, same as the forward FFD): one
    # _place_group call per group instead of one per (candidate, slot).
    # Any feasible assignment proves the set repacks — the aggregated
    # first-fit is such an assignment.
    cand_arr = np.asarray(list(candidate_ids), dtype=np.int64)
    totals = np.bincount(
        ct.group_ids[cand_arr].ravel(),
        weights=ct.group_counts[cand_arr].ravel(),
        minlength=G,
    ).astype(np.int64)
    pending: dict[int, int] = {}
    for g in np.nonzero(totals)[0]:
        g = int(g)
        leftover = _place_group(g, int(totals[g]))
        if leftover > 0:
            pending[g] = leftover
    # Zone budgets are placement-DEPENDENT: spread floors water-fill upward
    # as matched pods land, and affinity zones open when a later group's
    # matching pods arrive — but _place_group computes budgets once at
    # entry. Re-place every leftover until a full sweep makes no progress.
    # Without topology, budgets are capacity-only and capacity never
    # grows — skip.
    progressed = has_topo
    while pending and progressed:
        progressed = False
        for g in list(pending):
            leftover = _place_group(g, pending[g])
            if leftover < pending[g]:
                progressed = True
            if leftover == 0:
                del pending[g]
            else:
                pending[g] = leftover
    for g, leftover in pending.items():
        if not allow_overflow:
            if _bool_mode:
                if len(_memo) > 256:
                    _memo.clear()
                _memo[_mkey] = False
            return None if return_free else False
        overflow[g] = overflow.get(g, 0) + leftover
    if allow_overflow:
        return free, overflow
    if _bool_mode:
        if len(_memo) > 256:
            _memo.clear()
        _memo[_mkey] = True
    return free if return_free else True


def delete_prefix(ct: ClusterTensors, mask: np.ndarray) -> list[int]:
    """The delete decision of the reference's disruption pass
    (``controllers/disruption.py:1093-1138``) with every node eligible: rows
    ordered by ``disruption_cost`` (stable), those the screen passed, and
    the largest prefix ``repack_set_feasible`` accepts, by binary search."""
    rows = np.argsort(ct.disruption_cost, kind="stable")
    candidates = [int(ni) for ni in rows if mask[ni]]
    lo, hi = 0, len(candidates)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid == 0 or repack_set_feasible(ct, candidates[:mid]):
            lo = mid
        else:
            hi = mid - 1
    return candidates[:lo]


def optimizer_replace_sets(
    ct: ClusterTensors,
    candidates,
    max_set: int = 16,
    proposals: int = 8,
    seed: int = 0,
) -> list:
    """Seeded subset proposals for the N->1 multi-replace chooser: the
    optimizer lane's consolidation arm, copied from the JAX package.

    The baseline chooser walks cost-ordered PREFIXES of the candidate
    list, so a replaceable set that skips a middle candidate (one whose
    pods block the single-node overflow absorb) is invisible to it. This
    proposes the leave-one-out subsets of the top prefix, then
    ``proposals`` price-biased random subsets of the candidate rows; the
    caller evaluates every proposal (``repack_set_feasible`` and
    ``replacement_for_groups``) and commits only a strictly cheaper, fully
    validated set.

    Deterministic: the RNG is seeded from (seed, the candidate rows), so
    the same snapshot proposes the same sets."""
    import random as _random

    cand = [int(i) for i in candidates][:32]
    if len(cand) < 3:
        return []  # the prefix walk already enumerates every subset
    rng = _random.Random(f"{seed}:{','.join(map(str, cand))}")
    price = {i: max(float(ct.price[i]), 1e-6) for i in cand}
    out: list = []
    seen: set = set()
    # systematic leave-one-out of the top prefix FIRST: the canonical
    # blocked-prefix shape is one candidate whose pods force an expensive
    # shared replacement, so dropping exactly it is enumerated, not sampled
    head = cand[: min(max_set, len(cand))]
    if len(head) >= 3:
        for i in range(len(head)):
            subset = sorted(head[:i] + head[i + 1:])
            key = tuple(subset)
            if key not in seen:
                seen.add(key)
                out.append(subset)
    n_target = len(out) + proposals
    for _ in range(proposals * 4):
        if len(out) >= n_target:
            break
        size = rng.randint(2, min(max_set, len(cand)))
        pool = list(cand)
        subset: list[int] = []
        while pool and len(subset) < size:
            # price-biased sample without replacement: expensive rows are
            # where replacement savings live
            total = sum(price[i] for i in pool)
            draw = rng.random() * total
            acc = 0.0
            pick = pool[-1]
            for i in pool:
                acc += price[i]
                if draw <= acc:
                    pick = i
                    break
            pool.remove(pick)
            subset.append(pick)
        key = tuple(sorted(subset))
        if key in seen:
            continue
        seen.add(key)
        out.append(sorted(subset))
    return out


def replacement_for_groups(
    ct: ClusterTensors,
    overflow: dict,
    catalog,
    pool_name: str,
    nodepools: Optional[dict] = None,
    margin: float = 0.15,
    price_cap: float = float("inf"),
    set_has_spot: bool = False,
    spot_to_spot: bool = False,
    nodeclass_by_pool: Optional[dict] = None,
) -> Optional[tuple]:
    """Cheapest single node absorbing ``overflow`` (group id -> pod count):
    the one-new-node tail of multi-node consolidation replace
    (designs/consolidation.md:63-65; deprovisioning_test.go:391-395).

    Returns (type_name, price, offering_options) or None. Conservative
    rules: overflow groups with zone constraints are rejected (the new
    node's zone can't be proven safe without occupancy simulation);
    hostname caps are enforced against the combined overflow (everything
    lands on ONE node); reserved offerings are not drawn (the single-node
    replace path owns reservation bookkeeping).
    """
    from ..models import labels as lbl
    from ..models.requirements import Requirements
    from .encode import _SKIP_KEYS, _contains_vec, _label_arrays

    if not overflow:
        return None
    gids = sorted(overflow)
    for g in gids:
        if ct.zone_constraints and ct.zone_constraints[g]:
            return None
    # hostname caps: all overflow pods co-locate on the new node
    if ct.mpn is not None and ct.hn_match is not None:
        for g in gids:
            if ct.mpn[g] >= _UNCAPPED:
                continue
            matching = sum(
                cnt for h, cnt in overflow.items() if ct.hn_match[g, h]
            )
            if matching > int(ct.mpn[g]):
                return None

    tensors = catalog.tensors()
    types = catalog.list()
    T = len(types)
    Z = len(tensors.zones)
    catalog_seq = tensors.key[0] if tensors.key else 0
    label_arrays = _label_arrays(types, (catalog.uid, catalog_seq, tensors.names))

    def static_mask(reqs: Requirements) -> np.ndarray:
        row = np.ones(T, dtype=bool)
        for key, vs in reqs:
            if key in _SKIP_KEYS:
                continue
            arrays = label_arrays.get(key)
            if arrays is None:
                if not vs.allow_undefined:
                    row[:] = False
                    break
                continue
            row &= _contains_vec(vs, *arrays)
        return row

    pool = (nodepools or {}).get(pool_name)
    node_compat = np.ones(T, dtype=bool)
    window = np.ones((Z, lbl.NUM_CAPACITY_TYPES), dtype=bool)
    if pool is not None:
        preqs = Requirements(pool.requirements)
        node_compat &= static_mask(preqs)
        zvs = preqs.get(lbl.TOPOLOGY_ZONE)
        cvs = preqs.get(lbl.CAPACITY_TYPE)
        window &= np.array([zvs.contains(z) for z in tensors.zones])[:, None]
        window &= np.array([cvs.contains(c) for c in lbl.CAPACITY_TYPES])[None, :]
    total = np.zeros(ct.requests.shape[1], dtype=np.float32)
    for g in gids:
        rep = ct.group_pods[g][0]
        reqs = rep.requirements()
        node_compat &= static_mask(reqs)
        zvs = reqs.get(lbl.TOPOLOGY_ZONE)
        cvs = reqs.get(lbl.CAPACITY_TYPE)
        window &= np.array([zvs.contains(z) for z in tensors.zones])[:, None]
        window &= np.array([cvs.contains(c) for c in lbl.CAPACITY_TYPES])[None, :]
        total += ct.requests[g] * overflow[g]
    if not window.any():
        return None

    allowed = tensors.available & window[None, :, :]
    allowed[:, :, lbl.RESERVED_INDEX] = False  # see docstring
    from .encode import effective_capacity

    cap = effective_capacity(
        tensors.capacity, types, (nodeclass_by_pool or {}).get(pool_name)
    )
    fits = (total[None, :] <= cap + 1e-4).all(axis=1)

    def _usable(a):
        wp = np.where(a, tensors.price, np.inf).min(axis=(1, 2))
        u = node_compat & fits & np.isfinite(wp)
        u &= wp < price_cap * (1.0 - margin) - 1e-9
        return u, wp

    if set_has_spot and allowed[:, :, lbl.SPOT_INDEX].any():
        # same SpotToSpotConsolidation gate as the single-node path: a set
        # containing spot nodes only lands on a spot replacement when the
        # gate is on AND >= MIN_TYPES_FOR_SPOT_TO_SPOT cheaper spot-capable
        # types exist
        spot_only = np.zeros_like(allowed)
        spot_only[:, :, lbl.SPOT_INDEX] = allowed[:, :, lbl.SPOT_INDEX]
        u_spot, _ = _usable(spot_only)
        if not spot_to_spot or int(u_spot.sum()) < MIN_TYPES_FOR_SPOT_TO_SPOT:
            allowed = allowed.copy()
            allowed[:, :, lbl.SPOT_INDEX] = False
    usable, win_price = _usable(allowed)
    if not usable.any():
        return None
    t = int(np.where(usable, win_price, np.inf).argmin())
    offering_options = [
        (tensors.zones[zi], lbl.CAPACITY_TYPES[ci])
        for zi in range(Z)
        for ci in range(lbl.NUM_CAPACITY_TYPES)
        if allowed[t, zi, ci]
    ]
    return tensors.names[t], float(win_price[t]), offering_options


# Core parity: MinInstanceTypesForSpotToSpotConsolidation — a spot node may
# only be replaced by another spot offering when at least this many cheaper
# instance types exist, otherwise consolidation walks the fleet toward the
# top of the spot market and gets interrupted right back.
MIN_TYPES_FOR_SPOT_TO_SPOT = 15


#: process-level class cache for cheaper_replacement, keyed inside on one
#: (catalog snapshot, pool set, nodeclass set) signature — see the cache
#: comment in the function body. Values are pure functions of their keys,
#: so sharing across environments/runs is sound (and determinism-neutral).
#: Publication is build-then-swap under the lock: a caller whose mkey
#: differs builds a FRESH state object and swaps it in, so a concurrent
#: pass in another environment keeps its own consistent reference instead
#: of reading a cleared-and-half-repopulated dict. Same-key dict fills
#: race benignly (idempotent values, GIL-atomic ops).
_REPLACE_CLASS_CACHE: dict = {}
_REPLACE_CLASS_LOCK = threading.Lock()
_REPLACE_DEC_CAP = 262144


def cheaper_replacement(
    ct: ClusterTensors, catalog, nodepools: Optional[dict] = None, margin: float = 0.15,
    reserved_allow: Optional[dict] = None, spot_to_spot: bool = False,
    nodeclass_by_pool: Optional[dict] = None,
    candidates: Optional[list] = None,
) -> list:
    """[(node_index, type_name, new_price)] single-node replace candidates:
    all the node's pods fit one cheaper instance type (consolidation.md
    'replace with a single cheaper node'). The replacement must satisfy the
    node's NodePool requirements, not just the pods'.

    ``margin`` demands a meaningful saving (default 15%) — with zero margin,
    zonal spot-price jitter makes replace oscillate forever: every pass finds
    an epsilon-cheaper offering for the node it just created.

    ``spot_to_spot`` is the core SpotToSpotConsolidation feature gate
    (default off, like upstream): a running SPOT node is never replaced by
    another spot offering unless the gate is on AND at least
    ``MIN_TYPES_FOR_SPOT_TO_SPOT`` cheaper spot-capable types qualify —
    spot->on-demand/reserved replacements are always considered.

    ``candidates`` bounds the per-node loop to the given tensor rows (the
    disruption controller passes its validated eligibility set — on a big
    fleet with no eligible node the all-rows walk was pure waste); None
    keeps the legacy every-row sweep."""
    from ..models.requirements import Requirements
    from .encode import _SKIP_KEYS, _contains_vec, _label_arrays

    tensors = catalog.tensors()
    types = catalog.list()
    T = len(types)
    catalog_seq = tensors.key[0] if tensors.key else 0
    label_arrays = _label_arrays(types, (catalog.uid, catalog_seq, tensors.names))
    min_price = tensors.min_price()  # [T]
    from .encode import effective_capacity

    _cap_memo: dict = {}

    def _cap_for(pool_name):
        # per-pool effective capacity (nodeclass ephemeral rules); one
        # adjusted copy per pool, not per node
        if pool_name not in _cap_memo:
            _cap_memo[pool_name] = effective_capacity(
                tensors.capacity, types, (nodeclass_by_pool or {}).get(pool_name)
            )
        return _cap_memo[pool_name]

    def static_mask(reqs: Requirements) -> np.ndarray:
        row = np.ones(T, dtype=bool)
        for key, vs in reqs:
            if key in _SKIP_KEYS:
                continue
            arrays = label_arrays.get(key)
            if arrays is None:
                if not vs.allow_undefined:
                    row[:] = False
                    break
                continue
            row &= _contains_vec(vs, *arrays)
        return row

    from ..models import labels as lbl

    Z = len(tensors.zones)
    # Per-ct memo for everything derivable from (catalog snapshot, pools):
    # the incremental encoder returns the SAME ct object across unchanged
    # passes, so the [G, T] compat matrix, pool masks/windows, and group
    # windows are computed once per (snapshot, pool set) instead of per
    # pass.
    memo = ct.__dict__.setdefault("_replace_memo", {})
    pools_sig = tuple(sorted(
        (name, pool.hash()) for name, pool in (nodepools or {}).items()
    ))
    nc_sig = tuple(sorted(
        (name, nc.hash() if nc is not None else None)
        for name, nc in (nodeclass_by_pool or {}).items()
    ))
    mkey = (catalog.uid, tensors.key, pools_sig, nc_sig)
    # Token-keyed class cache, shared across emissions AND encoders: a
    # churn pass emits a NEW ClusterTensors, but a group's [T] compat row, its
    # (zone, captype) window, and the per-node-CLASS replacement decision
    # are pure functions of the group's interned ``group_token`` under one
    # (catalog snapshot, pool set) — the same identity the encoders use
    # for group equality. Keying on tokens instead of per-ct group indices
    # means 1%-churn passes re-score only genuinely NEW classes instead of
    # rebuilding the matrix and re-scoring every candidate per emission.
    with _REPLACE_CLASS_LOCK:
        cache = _REPLACE_CLASS_CACHE.get("state")
    if cache is None or cache.get("key") != mkey:
        cache = {"key": mkey, "rows": {}, "gw": {}, "dec": {}}
        # spec requirements only — template *labels* are stamped onto
        # nodes, not constraints the instance type must itself satisfy
        pool_masks: dict[str, np.ndarray] = {}
        pool_windows: dict[str, np.ndarray] = {}  # [Z, C] allowance
        for name, pool in (nodepools or {}).items():
            reqs = Requirements(pool.requirements)
            pool_masks[name] = static_mask(reqs)
            zvs = reqs.get(lbl.TOPOLOGY_ZONE)
            cvs = reqs.get(lbl.CAPACITY_TYPE)
            zrow = np.array([zvs.contains(z) for z in tensors.zones])
            crow = np.array([cvs.contains(ct_) for ct_ in lbl.CAPACITY_TYPES])
            pool_windows[name] = zrow[:, None] & crow[None, :]
        cache["pool_masks"] = pool_masks
        cache["pool_windows"] = pool_windows
        with _REPLACE_CLASS_LOCK:
            # fully built before publication; a concurrent different-key
            # pass that swapped first just wins (we keep OUR reference)
            _REPLACE_CLASS_CACHE["state"] = cache
    pool_masks = cache["pool_masks"]
    pool_windows = cache["pool_windows"]
    if memo.get("key") != mkey:
        memo.clear()
        memo["key"] = mkey
        # group identity: interned consolidation tokens (models/pod.py)
        tokens = [
            pods[0].group_token() if pods else None
            for pods in ct.group_pods
        ]
        # group x type compat via the same vectorized path as encode,
        # computed only for tokens the class cache hasn't seen
        G = ct.requests.shape[0]
        compat_t = np.ones((G, T), dtype=bool)
        rows = cache["rows"]
        for gi, pods in enumerate(ct.group_pods):
            row = rows.get(tokens[gi])
            if row is None:
                reqs = pods[0].requirements()
                row = np.ones(T, dtype=bool)
                for key, vs in reqs:
                    if key in (lbl.TOPOLOGY_ZONE, lbl.CAPACITY_TYPE,
                               lbl.HOSTNAME, lbl.NODEPOOL):
                        continue
                    arrays = label_arrays.get(key)
                    if arrays is None:
                        if not vs.allow_undefined:
                            row[:] = False
                            break
                        continue
                    row &= _contains_vec(vs, *arrays)
                rows[tokens[gi]] = row
            compat_t[gi] = row
        memo["tokens"] = tokens
        memo["compat_t"] = compat_t
    tokens = memo["tokens"]
    compat_t = memo["compat_t"]

    def group_window(gi: int) -> np.ndarray:
        reqs = ct.group_pods[gi][0].requirements()
        zvs = reqs.get(lbl.TOPOLOGY_ZONE)
        cvs = reqs.get(lbl.CAPACITY_TYPE)
        zrow = np.array([zvs.contains(z) for z in tensors.zones])
        crow = np.array([cvs.contains(ct_) for ct_ in lbl.CAPACITY_TYPES])
        return zrow[:, None] & crow[None, :]

    out = []
    N = len(ct.node_names)
    present = ct.group_counts > 0  # [N, GMAX]
    gw_cache: dict = cache["gw"]  # token -> [Z, C] window
    # Hard reserved counts, tracked across candidates within this pass: a
    # single free reservation slot may justify at most ONE replacement —
    # later candidates must price against market capacity or stay put.
    res_left = np.zeros((T, Z), dtype=np.int64)
    type_idx = {n: i for i, n in enumerate(tensors.names)}
    zone_idx = {z: i for i, z in enumerate(tensors.zones)}
    # Window-aware slot accounting: a capacity block outside its
    # [start_s, end_s) purchase window contributes no slots, so a
    # replacement can never be justified by a reservation that will have
    # expired by the time the new node launches (market/offerings.py).
    _clk = getattr(catalog, "_clock", None)
    _now = _clk.now() if _clk is not None else None
    for r in catalog.reservations.list():
        if _now is not None and hasattr(r, "open_at") and not r.open_at(_now):
            continue
        ti, zi = type_idx.get(r.instance_type), zone_idx.get(r.zone)
        if ti is not None and zi is not None:
            res_left[ti, zi] += r.remaining
    # Reservation isolation, per (type, zone): a replacement may only land
    # on the reserved pairs its own pool's nodeclass resolved. reserved_allow
    # maps pool -> set of (instance_type, zone); None = no gating (legacy
    # single-tenant callers); unknown pools get nothing.
    pool_rmask: dict[str, np.ndarray] = {}
    if reserved_allow is not None:
        for pname, pairs in reserved_allow.items():
            m = np.zeros((T, Z), dtype=bool)
            if pairs is True:
                m[:] = True
            elif pairs:
                for tname, zname in pairs:
                    ti, zi = type_idx.get(tname), zone_idx.get(zname)
                    if ti is not None and zi is not None:
                        m[ti, zi] = True
            pool_rmask[pname] = m
        no_access = np.zeros((T, Z), dtype=bool)
    fallback = np.ones((Z, lbl.NUM_CAPACITY_TYPES), dtype=bool)
    # Per-node-CLASS decision cache: thousands of nodes collapse to the
    # distinct (pool, group set, zone, captype, price, fill) combinations
    # actually present, within a pass and — because the memo lives on the
    # (token-keyed) class cache — across passes, emissions, and encoder
    # rebuilds. Disabled whenever hard reservation slots are in play:
    # those decisions mutate res_left and may not be replayed.
    dec: dict = cache["dec"]
    if len(dec) > _REPLACE_DEC_CAP:  # unbounded fills are a leak, not a cache
        dec.clear()
    _MISS = object()
    cacheable = not bool(res_left.any())
    # Whole-result memo: on an unchanged ct (same emission object across
    # warm passes) with the same pool set / margins and NO hard reservation
    # slots in play, the entire candidate list is deterministic — the
    # per-node loop below is pure repeat work on every quiet reconcile.
    ra_sig = (
        None if reserved_allow is None
        else tuple(sorted(
            (p, True if v is True else tuple(sorted(v)) if v else ())
            for p, v in reserved_allow.items()
        ))
    )
    rows_iter = (
        range(N) if candidates is None
        else [int(i) for i in candidates]
    )
    out_key = (
        margin, spot_to_spot, ra_sig,
        None if candidates is None else tuple(rows_iter),
    )
    if cacheable:
        hit = memo.get("out")
        if hit is not None and hit[0] == out_key:
            return list(hit[1])
    for i in rows_iter:
        if ct.blocked[i] or not present[i].any():
            continue
        gids = ct.group_ids[i][present[i]]
        dkey = None
        if cacheable:
            dkey = (
                ct.nodepool_names[i],
                tuple(sorted({tokens[int(g)] for g in gids})),
                ct.node_zone[i] if ct.node_zone else None,
                ct.node_captype[i] if ct.node_captype else None,
                float(ct.price[i]),
                ct.used_total[i].tobytes(),
                margin, spot_to_spot,
            )
            hit = dec.get(dkey, _MISS)
            if hit is not _MISS:
                if hit is not None:
                    out.append((i,) + hit)
                continue
        node_compat = compat_t[gids].all(axis=0)  # [T]
        pool_mask = pool_masks.get(ct.nodepool_names[i])
        if pool_mask is not None:
            node_compat = node_compat & pool_mask
        # joint (zone, captype) window: pool allowance x every group on the
        # node — the replacement must be launchable where its pods may run
        window = pool_windows.get(ct.nodepool_names[i], fallback).copy()
        zone_pinned = False
        for g in gids:
            g = int(g)
            tok = tokens[g]
            if tok not in gw_cache:
                gw_cache[tok] = group_window(g)
            window &= gw_cache[tok]
            if ct.zone_constraints and ct.zone_constraints[g]:
                zone_pinned = True
        if zone_pinned:
            # zone-topology pods move as one unit: pinning the replacement
            # to the node's current zone keeps every zone count unchanged,
            # so spread/anti/affinity stay satisfied by construction
            zrow = np.array([z == ct.node_zone[i] for z in tensors.zones])
            window &= zrow[:, None]
        if not window.any():
            if dkey is not None:
                dec[dkey] = None
            continue
        # price per type restricted to the allowed, live offerings;
        # reserved only where slots remain unclaimed this pass AND the
        # node's pool holds the reservation
        allowed = tensors.available & window[None, :, :]
        allowed[:, :, lbl.RESERVED_INDEX] &= res_left > 0
        if reserved_allow is not None:
            allowed[:, :, lbl.RESERVED_INDEX] &= pool_rmask.get(
                ct.nodepool_names[i], no_access
            )
        cap_i = _cap_for(ct.nodepool_names[i])
        fits = (ct.used_total[i][None, :] <= cap_i + 1e-4).all(axis=1)

        def _score(a):
            wp = np.where(a, tensors.price, np.inf).min(axis=(1, 2))
            u = (
                node_compat & fits & np.isfinite(wp)
                & (wp < ct.price[i] * (1.0 - margin) - 1e-9)
            )
            return u, wp

        usable, win_price = _score(allowed)
        if (
            ct.node_captype
            and ct.node_captype[i] == lbl.CAPACITY_TYPE_SPOT
            and allowed[:, :, lbl.SPOT_INDEX].any()
        ):
            # SpotToSpotConsolidation gate: spot->spot needs the gate on AND
            # enough cheaper SPOT-CAPABLE types (cheapness via on-demand
            # offerings doesn't diversify the spot pool) to stay off the
            # top of the spot market
            spot_only = np.zeros_like(allowed)
            spot_only[:, :, lbl.SPOT_INDEX] = allowed[:, :, lbl.SPOT_INDEX]
            u_spot, _ = _score(spot_only)
            if not spot_to_spot or int(u_spot.sum()) < MIN_TYPES_FOR_SPOT_TO_SPOT:
                non_spot = allowed.copy()
                non_spot[:, :, lbl.SPOT_INDEX] = False
                allowed = non_spot
                usable, win_price = _score(allowed)
        if usable.any():
            t = int(np.where(usable, win_price, np.inf).argmin())
            zi_win, ci_win = np.unravel_index(
                np.argmin(np.where(allowed[t], tensors.price[t], np.inf)), (Z, lbl.NUM_CAPACITY_TYPES)
            )
            if ci_win == lbl.RESERVED_INDEX:
                res_left[t, zi_win] -= 1  # this candidate claims the slot
            offering_options = [
                (tensors.zones[zi], lbl.CAPACITY_TYPES[ci])
                for zi in range(Z)
                for ci in range(lbl.NUM_CAPACITY_TYPES)
                if allowed[t, zi, ci]
            ]
            result = (tensors.names[t], float(win_price[t]), offering_options)
            if dkey is not None:  # cacheable => reserved can't have won
                dec[dkey] = result
            out.append((i,) + result)
        elif dkey is not None:
            dec[dkey] = None
    if cacheable:
        memo["out"] = (out_key, list(out))
    return out
