"""The consolidation screen: batched "remove node i — do its pods fit
elsewhere?" on the device, and the host validator behind it.

The counterpart of the JAX package's ``ops/consolidate.py`` for the screen
(BASELINE config #4: multi-node consolidation of 5k live nodes):

- host encode: ``encode_cluster`` / ``_encode_cluster`` snapshot the live
  nodes and their pods into ``ClusterTensors`` (numpy, copied unchanged);
- ``repack_check``: the plain PyTorch version of the screen. The reference's
  vmap over candidates is a candidate batch dimension (chunked), its scan a
  loop over the slot axis;
- ``dispatch_screen`` / ``consolidatable``: one upload per ``ClusterTensors``
  object, ONE launch of the hand-written repack kernel
  (``ops/repack_cuda.py``, ``csrc/repack.cu``) for a CUDA device and one
  device-to-host copy of the mask; the plain version for the CPU. There is
  no fallback from one to the other;
- ``repack_set_feasible``: the host validator (numpy, copied; its boolean
  verdict only, which is what the delete decision reads), the enforcement
  point behind the over-approximate screen.

Not carried by this package yet, and refused when asked for: the
incremental encoder (``encode_cluster(..., incremental=True)``) and
partitioned tensors (``_partitions``).
"""

from __future__ import annotations

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
                   ) -> Optional[ClusterTensors]:
    """Snapshot ready nodes with claims into consolidation tensors: the
    reference's full encode (``_encode_cluster``).

    ``incremental=True`` asks for the reference's journal-patching encoder,
    which this package does not carry: it raises ``NotImplementedError``.
    ``None`` (the default) takes the full encode, as the reference does for
    a cluster without a change journal. ``pods_by_node`` lets a caller share
    an already-built per-pass pod view."""
    if incremental:
        raise NotImplementedError(
            "the incremental cluster encoder is not ported; use incremental=False"
        )
    return _encode_cluster(cluster, catalog, gmax, pods_by_node=pods_by_node)


def _encode_cluster(cluster, catalog, gmax: int,
                    pods_by_node=None) -> Optional[ClusterTensors]:
    from ..models import labels as lbl

    # A node whose claim is already draining (deleted) is neither a
    # candidate nor a repack target — its capacity is going away.
    claims = {c.name: c for c in cluster.snapshot_claims()}
    nodes = [
        n
        for n in cluster.snapshot_nodes()
        if n.ready
        and not n.cordoned
        and n.nodeclaim_name in claims
        and not claims[n.nodeclaim_name].deleted
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
    run ``chunk`` at a time as a batch dimension; slots run in order."""
    N, R = free.shape
    S = group_ids.shape[1]
    dev = free.device
    cap_f = _cap_f32(cap)
    with_req = requests > 0
    safe_req = torch.where(with_req, requests, torch.ones_like(requests))
    inf = torch.tensor(float("inf"), device=dev)
    nodes = torch.arange(N, device=dev)
    out = []
    for start in range(0, candidates.shape[0], chunk):
        cand = candidates[start:start + chunk].long()
        B = cand.shape[0]
        free_c = free.unsqueeze(0).expand(B, N, R).clone()
        gids = group_ids[cand].long()
        gcnt = group_counts[cand].long()
        other = nodes.unsqueeze(0) != cand.unsqueeze(1)  # [B, N]
        leftover = torch.zeros(B, dtype=torch.int64, device=dev)
        for s in range(S):
            g = gids[:, s]
            cnt = gcnt[:, s]
            req = requests[g]                                    # [B, R]
            ratio = torch.where(
                with_req[g].unsqueeze(1),
                torch.floor((free_c + _EPS) / safe_req[g].unsqueeze(1)),
                inf,
            )                                                    # [B, N, R]
            k = ratio.amin(dim=-1).clamp(0.0, float(_UNCAPPED))
            k = torch.minimum(k, cap_f[g])                       # [B, N]
            k = torch.where(other, k, torch.zeros_like(k)).to(torch.int64)
            cum_before = torch.cumsum(k, dim=1) - k
            place = torch.minimum((cnt.unsqueeze(1) - cum_before).clamp(min=0), k)
            free_c = free_c - place.to(torch.float32).unsqueeze(2) * req.unsqueeze(1)
            leftover += cnt - place.sum(dim=1)
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


#: provenance of the last screen: backend, device name, ms per stage
LAST_SCREEN: dict = {}


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
    answer is a pure function of the tensors)."""
    if ct.__dict__.get("_partitions"):
        raise NotImplementedError("partitioned cluster tensors are not ported")
    dev = _resolve_device(device)
    backend = _repack_backend(dev)
    t0 = time.perf_counter()
    memo = ct.__dict__.get("_screen_mask_memo")
    if memo is not None and memo[1] == backend:
        out = memo[0].copy()
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
    """The screen body: returns (waiter, stage ms). The inputs' device picks
    the kernel or the plain version inside ``repack_cuda.repack_check``;
    there is no fallback between them."""
    from . import repack_cuda

    t0 = time.perf_counter()
    x = _device_inputs(ct, dev)
    stages = {"upload_ms": (time.perf_counter() - t0) * 1e3}
    t1 = time.perf_counter()
    ok = repack_cuda.repack_check(
        x["free"], x["requests"], x["group_ids"], x["group_counts"],
        x["cap"], x["candidates"], chunk=chunk,
    )
    stages["launch_ms"] = (time.perf_counter() - t1) * 1e3
    blocked = ct.blocked

    def waiter() -> np.ndarray:
        # an empty node is trivially "repackable"; emptiness is handled
        # separately
        return ok.cpu().numpy() & ~blocked

    return waiter, stages


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


def repack_set_feasible(ct: ClusterTensors, candidate_ids) -> bool:
    """Can ALL candidates' pods repack onto the *surviving* nodes (every
    non-candidate)? This is the reference's multi-node consolidation
    simulation (designs/consolidation.md:9-15): the whole set is removed at
    once, so a candidate can never serve as a repack target for another.

    The simulation is TOPOLOGY-AWARE. Hostname-capped groups respect
    per-node selector-matched occupancy (updated as pods land); zone
    anti-affinity / DoNotSchedule spread / zone affinity place within sound
    per-zone budgets computed from live counts after the candidate set's
    removal. This is the enforcement point behind the (possibly
    over-approximate) device screen. Any leftover fails the check.

    Verdicts are memoized per (ct object, candidate tuple): the answer is a
    pure function of the tensors, and a binary search over cost-ordered
    prefixes re-validates the same prefixes against the same unchanged ct.
    (The reference's ``free=``, ``return_free=`` and ``allow_overflow=``
    options serve its replace paths, which this package does not carry.)
    """
    _memo = ct.__dict__.setdefault("_repack_memo", {})
    _mkey = tuple(candidate_ids)
    hit = _memo.get(_mkey)
    if hit is not None:
        return hit
    free = ct.free.copy()
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
    if len(_memo) > 256:
        _memo.clear()
    _memo[_mkey] = not pending
    return not pending


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
