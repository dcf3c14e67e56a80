"""Incremental (delta-aware) cluster-state encoding: the JAX package's
``ops/encode_delta.py``, copied (pure numpy).

A full ``ops/consolidate.py::_encode_cluster`` re-tensorizes the whole
cluster every pass. This module keeps ONE persistent encoder per (cluster,
catalog, gmax) that:

 - snapshots the full encode once (``_encode_cluster`` — the single source of
   truth for the encoding semantics), converting it into padded, patchable
   buffers whose node/group axes sit on the ``{2^k, 1.5*2^k}`` ladder;
 - patches dirty node ROWS from the cluster's bounded change journal
   (``state.Cluster.changes_since``): pod bind/unbind, node add/delete,
   nodeclaim updates each dirty exactly the rows they touch;
 - re-emits ``ClusterTensors`` from the buffers (gathering live rows/groups),
   or returns the previous emission object unchanged when nothing moved —
   downstream per-``ct`` memos (the screen mask, the replacement memo) then
   survive passes;
 - falls back to a full re-encode on journal overflow, catalog snapshot /
   seqnum change, store epoch change, heavy churn (patching most of the
   cluster is slower than re-encoding it), or every
   ``KARPENTER_TPU_ENCODE_REFRESH_EVERY`` passes (belt-and-braces against
   unsanctioned in-place mutations the journal cannot see).

The contract is EXACT equivalence: a patched emission must describe the same
cluster as a from-scratch ``_encode_cluster`` — same values, with row/group
order allowed to differ (all consumers index through the name lists).
``canonical_form`` normalizes both for the comparison.

Outcomes are counted in ``ENCODE_COUNTS`` (hit / patch / full, and the rows a
patch rewrote), and ``LAST_ENCODE`` names the last pass's mode and, for a
full build, its cause — plain module counters that tests and
``chip_smoke.py`` read.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np

from ..models import labels as lbl
from ..models.resources import NUM_RESOURCES
from . import overhead as _overhead
from .encode import _ladder_bucket

_UNCAPPED = 1 << 30

#: dirty fraction above which a full re-encode beats row patching
PATCH_FRAC = 0.5


def _refresh_every() -> int:
    return int(os.environ.get("KARPENTER_TPU_ENCODE_REFRESH_EVERY", "128"))


#: passes by outcome since the last ``reset_encode_counts`` (``patch_rows``:
#: rows the patches rewrote); every count also goes to the reference's
#: metric series (``karpenter_encode_cache_total{path="cluster"}`` with the
#: cause of a full build, ``karpenter_encode_patch_rows_total``), which
#: never reset
ENCODE_COUNTS: dict = {"hit": 0, "patch": 0, "full": 0, "patch_rows": 0}
#: the last pass: ``mode`` (hit / patch / full), ``cause`` of a full build,
#: ``dirty`` rows of a patch
LAST_ENCODE: dict = {}


def reset_encode_counts() -> None:
    for k in ENCODE_COUNTS:
        ENCODE_COUNTS[k] = 0
    LAST_ENCODE.clear()


def _count(mode: str, cause: str = "", dirty: int = 0) -> None:
    from ..metrics import ENCODE_CACHE, ENCODE_PATCH_ROWS

    ENCODE_COUNTS[mode] += 1
    ENCODE_COUNTS["patch_rows"] += dirty
    if mode == "full" and cause:
        ENCODE_CACHE.inc(path="cluster", outcome=mode, cause=cause)
    else:
        ENCODE_CACHE.inc(path="cluster", outcome=mode)
    if dirty:
        ENCODE_PATCH_ROWS.inc(dirty)
    LAST_ENCODE.clear()
    LAST_ENCODE.update(mode=mode, cause=cause, dirty=dirty)


def _matches(selector, pod) -> bool:
    return all(pod.labels.get(k) == v for k, v in selector.items())


class _EncoderState:
    """Patchable padded buffers + bookkeeping for one (cluster, catalog)."""

    def __init__(self, gmax: int):
        self.gmax = gmax
        self.lock = threading.RLock()
        self.epoch = None          # cluster.epoch at build
        self.rev = -1
        self.catalog_key = None
        self.passes_since_full = 0
        self.emitted: Optional[object] = None
        # -- node axis (slots [0, n_hi); live[i] marks occupied) -----------
        self.NB = 0
        self.n_hi = 0
        self.row_of: dict[str, int] = {}
        self.claim_row: dict[str, int] = {}
        self.row_name: list = []
        self.row_pool: list = []
        self.row_claim: list = []
        self.row_nver: list = []
        self.row_captype: list = []
        self.row_tokens: list = []   # per slot: dict[token -> list[Pod]]
        self.live = np.zeros(0, dtype=bool)
        self.alloc = np.zeros((0, NUM_RESOURCES), dtype=np.float32)
        self.used = np.zeros((0, NUM_RESOURCES), dtype=np.float32)
        self.dcost = np.zeros(0, dtype=np.float32)
        self.blocked = np.zeros(0, dtype=bool)
        self.price = np.zeros(0, dtype=np.float32)
        self.zidx = np.zeros(0, dtype=np.int32)
        self.row_class = np.zeros(0, dtype=np.int64)
        # max interned gang ordinal among the row's pods (0 = none): the
        # node_gang column disruption uses to treat a gang's nodes as one
        # unit. int32 like zidx; ladder-padded
        # with the node axis so arming gangs never moves tensor shapes.
        self.gang = np.zeros(0, dtype=np.int32)
        # process-state fingerprints folded into state validity: flipping
        # the gang kill switch or re-registering DaemonSet overhead must
        # force a full rebuild, not patch around stale blocked/alloc rows
        self.gangs_armed = None
        self.overhead_seq = None
        # -- group axis (slots [0, g_hi); refcount 0 == zombie) ------------
        self.GB = 0
        self.g_hi = 0
        self.gid_of: dict[int, int] = {}
        self.g_token: list = []
        self.g_rep: list = []
        self.g_refcount = np.zeros(0, dtype=np.int64)
        self.g_requests = np.zeros((0, NUM_RESOURCES), dtype=np.float32)
        self.g_mpn = np.zeros(0, dtype=np.int32)
        self.gnc = np.zeros((0, 0), dtype=np.int32)      # [GB, NB]
        self.compat = np.zeros((0, 0), dtype=bool)        # [GB, NB]
        self.hn_match = np.zeros((0, 0), dtype=bool)      # [GB, GB]
        self.g_hn_sel: list = []       # per gid: list of hostname selectors
        self.g_zone_terms: list = []   # per gid: list[(kind, skew, selector)]
        self.g_zc_match: list = []     # per gid: list[np.ndarray over GB]
        self.g_pods: dict[int, dict[int, list]] = {}  # gid -> row -> pods
        # -- node classes (labels projected on ref_keys, + taints) ---------
        self.ref_keys: tuple = ()
        self.class_idx: dict = {}
        self.class_labels: list = []
        self.class_taints: list = []
        self.class_compat = np.zeros((0, 0), dtype=bool)  # [GB, C]
        # -- misc ----------------------------------------------------------
        self.zones: list[str] = []
        self.zone_idx: dict[str, int] = {}
        self.price_memo: dict = {}
        # Known-but-ineligible nodes (not ready / cordoned / claim draining)
        # -> node._version at last look. The defensive version scan covers
        # these too, so a direct ``node.cordoned = False`` flip-back (no
        # journal entry) re-admits the node instead of losing it forever.
        self.parked: dict[str, int] = {}
        # NODE_WRITE_SEQ snapshot: the defensive scan runs only when some
        # Node field was written since the last pass (see state.cluster).
        self.node_seq = -1
        # emission bookkeeping for the fast-path patch (see _emit)
        self.emit_pos: dict[int, int] = {}   # row slot -> emitted position
        self.emit_gpos: dict[int, int] = {}  # gid -> emitted position
        self.emit_gids = np.zeros(0, dtype=np.int64)  # emitted gid order
        self.membership_changed = True       # rows/groups/zones set changed
        self.touched_gids: set[int] = set()  # gids whose pod lists changed

    # -- growth --------------------------------------------------------------
    def _grow_nodes(self, need: int) -> None:
        nb = _ladder_bucket(max(need, 8), minimum=8)
        if nb <= self.NB:
            return
        pad = nb - self.NB

        def padn(a, axis):
            widths = [(0, 0)] * a.ndim
            widths[axis] = (0, pad)
            return np.pad(a, widths)

        self.live = padn(self.live, 0)
        self.alloc = padn(self.alloc, 0)
        self.used = padn(self.used, 0)
        self.dcost = padn(self.dcost, 0)
        self.blocked = padn(self.blocked, 0)
        self.price = padn(self.price, 0)
        self.zidx = padn(self.zidx, 0)
        self.row_class = padn(self.row_class, 0)
        self.gang = padn(self.gang, 0)
        self.gnc = padn(self.gnc, 1)
        self.compat = padn(self.compat, 1)
        for lst, fill in (
            (self.row_name, None), (self.row_pool, ""), (self.row_claim, ""),
            (self.row_nver, -1), (self.row_captype, ""),
        ):
            lst.extend([fill] * pad)
        self.row_tokens.extend({} for _ in range(pad))
        self.NB = nb

    def _grow_groups(self, need: int) -> None:
        gb = _ladder_bucket(max(need, 8), minimum=8)
        if gb <= self.GB:
            return
        pad = gb - self.GB

        def padg(a, axes):
            widths = [(0, 0)] * a.ndim
            for ax in axes:
                widths[ax] = (0, pad)
            return np.pad(a, widths)

        self.g_refcount = padg(self.g_refcount, (0,))
        self.g_requests = padg(self.g_requests, (0,))
        self.g_mpn = padg(self.g_mpn, (0,))
        self.gnc = padg(self.gnc, (0,))
        self.compat = padg(self.compat, (0,))
        self.hn_match = padg(self.hn_match, (0, 1))
        self.class_compat = padg(self.class_compat, (0,))
        self.g_zc_match = [
            [np.pad(m, (0, pad)) for m in terms] for terms in self.g_zc_match
        ]
        self.g_token.extend([None] * pad)
        self.g_rep.extend([None] * pad)
        self.g_hn_sel.extend([] for _ in range(pad))
        self.g_zone_terms.extend([] for _ in range(pad))
        self.g_zc_match.extend([] for _ in range(pad))
        self.GB = gb

    def _compact_nodes(self) -> None:
        """Gather live rows to the slot front (order preserved) so deleted
        nodes' slots are reclaimed instead of growing NB forever."""
        keep = np.flatnonzero(self.live[: self.n_hi])
        k = len(keep)
        for a_name in ("alloc", "used", "dcost", "blocked", "price",
                       "zidx", "row_class", "gang", "live"):
            a = getattr(self, a_name)
            out = np.zeros_like(a)
            out[:k] = a[keep]
            setattr(self, a_name, out)
        self.gnc[:, :k] = self.gnc[:, keep]
        self.gnc[:, k:] = 0
        self.compat[:, :k] = self.compat[:, keep]
        self.compat[:, k:] = False
        for a_name, fill in (
            ("row_name", None), ("row_pool", ""), ("row_claim", ""),
            ("row_nver", -1), ("row_captype", ""),
        ):
            lst = getattr(self, a_name)
            new = [lst[i] for i in keep] + [fill] * (self.NB - k)
            setattr(self, a_name, new)
        self.row_tokens = [self.row_tokens[i] for i in keep] + [
            {} for _ in range(self.NB - k)
        ]
        remap = {int(old): new for new, old in enumerate(keep)}
        self.g_pods = {
            gid: {remap[r]: pods for r, pods in bucket.items() if r in remap}
            for gid, bucket in self.g_pods.items()
        }
        self.n_hi = k
        self.row_of = {self.row_name[i]: i for i in range(k)}
        self.claim_row = {self.row_claim[i]: i for i in range(k)}
        self.membership_changed = True


def _zone_of(state: _EncoderState, zone: str) -> int:
    zi = state.zone_idx.get(zone)
    if zi is None:
        zi = state.zone_idx[zone] = len(state.zones)
        state.zones.append(zone)
        state.membership_changed = True  # emitted zone vocabulary grows
    return zi


def _node_price(state: _EncoderState, catalog, node) -> float:
    """Per-offering running price (mirror of the full encode's memo; NaN =
    unknown type, which blocks the node). Reserved stays marginal-price 0
    regardless of the reservation window's committed price: the commitment
    is sunk whether or not the node runs, so consolidating ONTO it is the
    win and consolidating it AWAY is never one."""
    ct_ = node.capacity_type()
    pkey = (node.instance_type(), node.zone(), ct_)
    hit = state.price_memo.get(pkey)
    if hit is None:
        it = catalog.get(pkey[0])
        if it is None:
            hit = float("nan")
        elif ct_ == lbl.CAPACITY_TYPE_RESERVED:
            hit = 0.0
        elif ct_ == lbl.CAPACITY_TYPE_SPOT:
            hit = catalog.pricing.spot_price(it, pkey[1])
        else:
            hit = catalog.pricing.on_demand_price(it)
        state.price_memo[pkey] = hit
    return hit


# -- node classes -----------------------------------------------------------

def _class_key(state: _EncoderState, node) -> tuple:
    return (
        tuple(node.labels.get(k) for k in state.ref_keys),
        tuple(node.taints),
    )


def _class_of(state: _EncoderState, node) -> int:
    key = _class_key(state, node)
    ci = state.class_idx.get(key)
    if ci is None:
        ci = state.class_idx[key] = len(state.class_labels)
        labels = {k: v for k, v in zip(state.ref_keys, key[0]) if v is not None}
        state.class_labels.append(labels)
        state.class_taints.append(key[1])
        if ci >= state.class_compat.shape[1]:
            grow = max(8, state.class_compat.shape[1])
            state.class_compat = np.pad(state.class_compat, ((0, 0), (0, grow)))
        for gid in range(state.g_hi):
            rep = state.g_rep[gid]
            if rep is None:
                continue
            state.class_compat[gid, ci] = rep.requirements().satisfied_by_labels(
                labels
            ) and rep.tolerates_all(key[1])
    return ci


def _rebuild_classes(state: _EncoderState, cluster) -> None:
    """A new group referenced a label key outside ``ref_keys``: the node
    class projection is too coarse — recompute it for every live row."""
    keys = set()
    for gid in range(state.g_hi):
        rep = state.g_rep[gid]
        if rep is not None:
            keys.update(rep.requirements().keys())
    state.ref_keys = tuple(sorted(keys))
    state.class_idx = {}
    state.class_labels = []
    state.class_taints = []
    state.class_compat = np.zeros((state.GB, 8), dtype=bool)
    nodes = cluster.nodes
    for row in np.flatnonzero(state.live[: state.n_hi]):
        node = nodes.get(state.row_name[row])
        if node is None:
            continue
        ci = _class_of(state, node)
        state.row_class[row] = ci
        state.compat[:, row] = state.class_compat[:, ci]


# -- groups -----------------------------------------------------------------

def _ensure_group(state: _EncoderState, cluster, token: int, rep) -> int:
    gid = state.gid_of.get(token)
    if gid is not None:
        if state.g_refcount[gid] == 0:
            state.g_rep[gid] = rep  # revival: token-equal reps interchangeable
            state.membership_changed = True
        return gid
    if state.g_hi >= state.GB:
        state._grow_groups(state.g_hi + 1)
    gid = state.g_hi
    state.g_hi += 1
    state.membership_changed = True
    state.gid_of[token] = gid
    state.g_token[gid] = token
    state.g_rep[gid] = rep
    state.g_refcount[gid] = 0
    state.g_requests[gid] = np.asarray(rep.requests.v).astype(np.float32)
    mpn = min(int(rep.hostname_cap()), _UNCAPPED)
    state.g_mpn[gid] = np.int32(mpn)
    # hostname selector-occupancy matrix (both directions for the new gid)
    sels = []
    if mpn < _UNCAPPED:
        sels = [
            t.label_selector
            for t in list(rep.anti_affinity) + list(rep.topology_spread)
            if getattr(t, "topology_key", "") == lbl.HOSTNAME
        ]
    state.g_hn_sel[gid] = sels
    for j in range(state.g_hi):
        other = state.g_rep[j]
        if other is None:
            continue
        if sels:
            state.hn_match[gid, j] = any(_matches(s, other) for s in sels)
        if state.g_hn_sel[j]:
            state.hn_match[j, gid] = any(
                _matches(s, rep) for s in state.g_hn_sel[j]
            )
    # zone terms, in the full encoder's construction order
    terms: list = []
    for a in rep.anti_affinity:
        if a.topology_key == lbl.TOPOLOGY_ZONE:
            terms.append((
                "anti" if a.matches(rep) else "block", 1,
                dict(a.label_selector),
            ))
    for c in rep.topology_spread:
        if (
            c.topology_key == lbl.TOPOLOGY_ZONE
            and c.when_unsatisfiable == "DoNotSchedule"
        ):
            terms.append(("spread", max(int(c.max_skew), 1),
                          dict(c.label_selector)))
    for a in rep.affinity:
        if a.topology_key == lbl.TOPOLOGY_ZONE:
            terms.append(("affinity", 0, dict(a.label_selector)))
    state.g_zone_terms[gid] = terms
    match_rows = []
    for _, _, sel in terms:
        m = np.zeros(state.GB, dtype=bool)
        for j in range(state.g_hi):
            other = state.g_rep[j]
            if other is not None:
                m[j] = _matches(sel, other)
        match_rows.append(m)
    state.g_zc_match[gid] = match_rows
    # every EXISTING constraint's match vector gains the new rep
    for j in range(state.g_hi - 1):
        for (kind, skew, sel), m in zip(state.g_zone_terms[j] or (),
                                        state.g_zc_match[j] or ()):
            m[gid] = _matches(sel, rep)
    # compat: node-class projection; widen ref_keys first if needed (and
    # bootstrap the class structure on the 0 -> 1 group transition, when a
    # podless full build never materialized it)
    reqs = rep.requirements()
    if any(k not in state.ref_keys for k in reqs.keys()) or not state.class_labels:
        _rebuild_classes(state, cluster)
    else:
        for ci in range(len(state.class_labels)):
            state.class_compat[gid, ci] = reqs.satisfied_by_labels(
                state.class_labels[ci]
            ) and rep.tolerates_all(state.class_taints[ci])
        rows = np.flatnonzero(state.live[: state.n_hi])
        if len(rows):
            state.compat[gid, rows] = state.class_compat[
                gid, state.row_class[rows]
            ]
    return gid


# -- row patching -----------------------------------------------------------

def _clear_row_pods(state: _EncoderState, row: int) -> None:
    for token, pods in state.row_tokens[row].items():
        gid = state.gid_of[token]
        state.g_refcount[gid] -= len(pods)
        if state.g_refcount[gid] == 0:
            state.membership_changed = True  # group died: emitted set shrinks
        state.gnc[gid, row] = 0
        state.touched_gids.add(gid)
        bucket = state.g_pods.get(gid)
        if bucket is not None:
            bucket.pop(row, None)
    state.row_tokens[row] = {}
    state.used[row] = 0.0
    state.dcost[row] = 0.0
    state.blocked[row] = False
    state.gang[row] = 0


def _remove_row(state: _EncoderState, row: int) -> None:
    _clear_row_pods(state, row)
    state.membership_changed = True
    state.live[row] = False
    state.row_of.pop(state.row_name[row], None)
    state.claim_row.pop(state.row_claim[row], None)
    state.row_name[row] = None
    state.row_claim[row] = ""
    state.compat[:, row] = False
    state.price[row] = 0.0
    state.alloc[row] = 0.0


def _alloc_row(state: _EncoderState, name: str) -> int:
    if state.n_hi >= state.NB:
        if int(state.live[: state.n_hi].sum()) < state.n_hi:
            state._compact_nodes()
        if state.n_hi >= state.NB:
            state._grow_nodes(state.n_hi + 1)
    row = state.n_hi
    state.n_hi += 1
    state.membership_changed = True
    state.live[row] = True
    state.row_name[row] = name
    state.row_of[name] = row
    return row


def _fill_row(state: _EncoderState, cluster, catalog, row, node, claim,
              plist, node_version: int) -> None:
    # ``node_version`` was read before ANY other node field: a concurrent
    # field write after that read makes the row re-patch next pass
    # (over-invalidation) instead of going stale
    state.row_nver[row] = node_version
    state.row_pool[row] = node.nodepool_name
    if state.row_claim[row] != claim.name:
        state.claim_row.pop(state.row_claim[row], None)
    state.row_claim[row] = claim.name
    state.claim_row[claim.name] = row
    zi = _zone_of(state, node.zone())
    if state.zidx[row] != zi:
        # a live row hopping zones can retire a zone from the emitted
        # vocabulary — the fast-path emit cannot express that
        state.membership_changed = True
        state.zidx[row] = zi
    state.row_captype[row] = node.capacity_type()
    state.alloc[row] = _overhead.apply(
        np.asarray(node.allocatable.v).astype(np.float32)
    )
    # pods -> groups; accumulate in pod order with float32 adds, exactly
    # like the full encoder's np.add.at, so values are byte-identical
    d: dict[int, list] = {}
    used = np.zeros(NUM_RESOURCES, dtype=np.float32)
    dcost = np.float32(0.0)
    blocked = False
    gang = 0
    for p in plist:
        d.setdefault(p.group_token(), []).append(p)
    state.row_tokens[row] = d
    for token, pods in d.items():
        gid = _ensure_group(state, cluster, token, pods[0])
        state.g_refcount[gid] += len(pods)
        state.gnc[gid, row] = len(pods)
        state.touched_gids.add(gid)
        state.g_pods.setdefault(gid, {})[row] = pods
    for p in plist:
        used += state.g_requests[state.gid_of[p.group_token()]]
        dcost = np.float32(
            dcost + np.float32(1.0 + p.deletion_cost() + p.priority / 1000.0)
        )
        if p.do_not_disrupt() or p.hostname_colocated() or p.gang_locked():
            blocked = True
        gang = max(gang, p.gang_ordinal())
    state.used[row] = used
    state.dcost[row] = dcost
    state.gang[row] = gang
    blocked = blocked or len(d) > state.gmax
    hit = _node_price(state, catalog, node)
    if hit != hit:  # NaN: type missing from the catalog snapshot
        state.price[row] = 0.0
        blocked = True
    else:
        state.price[row] = hit
    state.blocked[row] = blocked
    ci = _class_of(state, node)
    state.row_class[row] = ci
    state.compat[:, row] = state.class_compat[:, ci]
    # rows with no pods keep gnc column zero for every group — already true
    # after _clear_row_pods / fresh allocation


def _process_node(state: _EncoderState, cluster, catalog, name, plist) -> bool:
    """Re-evaluate one node; True when a row was rewritten or removed
    (False = the name resolved to a parked/absent node and no buffer
    changed — the patch-rows metric counts only real row work)."""
    node = cluster.nodes.get(name)
    claim = None
    ver = -1
    if node is not None:
        ver = node._version  # BEFORE the eligibility field reads (see _fill_row)
        if node.ready and not node.cordoned:
            claim = cluster.nodeclaims.get(node.nodeclaim_name)
            if claim is not None and claim.deleted:
                claim = None
    row = state.row_of.get(name)
    if claim is None:
        if row is not None:
            _remove_row(state, row)
        if node is None:
            state.parked.pop(name, None)  # gone from the store entirely
        else:
            state.parked[name] = ver
        return row is not None
    state.parked.pop(name, None)
    if row is None:
        row = _alloc_row(state, name)
    else:
        _clear_row_pods(state, row)
    _fill_row(state, cluster, catalog, row, node, claim, plist, ver)
    return True


# -- emission ---------------------------------------------------------------

def _emit_slot_width(max_live: int, gmax: int) -> int:
    """Slot-table width for an EMISSION: power-of-two covering the widest
    live row, floored at 4 (headroom so a node gaining a 2nd/3rd group
    patches in place instead of re-emitting), capped at gmax.

    Emissions carry ``[N, width]`` group tables instead of ``[N, gmax]``:
    production nodes host 1-2 distinct consolidation groups while gmax is
    32, and the full-width tables would be padding COPIED on every
    copy-on-write patch. Every consumer already slices by
    ``live_slot_width`` (computed
    from the array), so width is a representation detail; the canonical
    form compares slot tables as {token: count} dicts either way."""
    w = 4
    cap = max(min(max_live, gmax), 1)
    while w < cap:
        w *= 2
    return min(w, max(gmax, 1))


def _emit(state: _EncoderState):
    from .consolidate import ClusterTensors, ZoneConstraint

    rows = np.flatnonzero(state.live[: state.n_hi])
    if not len(rows):
        state.emitted = None
        return None
    N = len(rows)
    gids = np.flatnonzero(state.g_refcount[: state.g_hi] > 0)
    G = max(len(gids), 1)

    # zone compaction: only zones live rows reference, in vocabulary order
    present = np.unique(state.zidx[rows])
    zmap = np.zeros(max(len(state.zones), 1), dtype=np.int32)
    zones_e = []
    for k, zi in enumerate(present):
        zmap[zi] = k
        zones_e.append(state.zones[int(zi)])
    node_zone_idx = zmap[state.zidx[rows]].astype(np.int32)
    node_zone = [state.zones[int(zi)] for zi in state.zidx[rows]]

    free = state.alloc[rows] - state.used[rows]
    blocked = state.blocked[rows].copy()

    if len(gids):
        requests = state.g_requests[gids].copy()
        gnc_e = state.gnc[np.ix_(gids, rows)].astype(np.int32)
        compat_e = state.compat[np.ix_(gids, rows)].copy()
        mpn_e = state.g_mpn[gids].copy()
        hn_e = state.hn_match[np.ix_(gids, gids)].copy()
        # per-row slot tables from the [G, N] counts (same packing rule as
        # the full encoder: ascending group id, first gmax slots kept),
        # emitted at the live slot width (see _emit_slot_width)
        t = gnc_e.T                      # [N, G]
        live_counts = (t > 0).sum(axis=1)
        S_em = _emit_slot_width(
            int(live_counts.max()) if len(live_counts) else 0, state.gmax
        )
        group_ids = np.zeros((N, S_em), dtype=np.int32)
        group_counts = np.zeros((N, S_em), dtype=np.int32)
        rnz, cnz = np.nonzero(t)
        if len(rnz):
            slot = np.arange(len(rnz)) - np.searchsorted(rnz, rnz)
            keep = slot < S_em
            group_ids[rnz[keep], slot[keep]] = cnz[keep]
            group_counts[rnz[keep], slot[keep]] = t[rnz[keep], cnz[keep]]
        cap = np.where(compat_e, np.float32(_UNCAPPED), np.float32(0.0))
        for k in range(len(gids)):
            if mpn_e[k] >= _UNCAPPED:
                continue
            occupied = hn_e[k].astype(np.int32) @ gnc_e
            cap[k] = np.where(
                compat_e[k],
                np.maximum(mpn_e[k] - occupied, 0).astype(np.float32), 0.0,
            )
        zone_constraints = []
        for k, gid in enumerate(gids):
            cons = []
            for (kind, skew, sel), m in zip(state.g_zone_terms[gid],
                                            state.g_zc_match[gid]):
                cons.append(ZoneConstraint(kind=kind, skew=skew,
                                           match=m[gids].copy(),
                                           selector=sel))
            zone_constraints.append(cons)
        group_pods = LazyGroupPods(
            [_lazy_group_pods(state, int(gid)) for gid in gids]
        )
    else:
        # podless cluster: mirror the full encoder's G=1 dummy group
        requests = np.zeros((1, NUM_RESOURCES), dtype=np.float32)
        gnc_e = np.zeros((1, N), dtype=np.int32)
        compat_e = np.zeros((1, N), dtype=bool)
        mpn_e = np.full(1, _UNCAPPED, dtype=np.int32)
        hn_e = np.zeros((1, 1), dtype=bool)
        cap = np.where(compat_e, np.float32(_UNCAPPED), np.float32(0.0))
        zone_constraints = []
        group_pods = []
        S_em = _emit_slot_width(0, state.gmax)
        group_ids = np.zeros((N, S_em), dtype=np.int32)
        group_counts = np.zeros((N, S_em), dtype=np.int32)

    out = ClusterTensors(
        node_names=[state.row_name[i] for i in rows],
        nodepool_names=[state.row_pool[i] for i in rows],
        free=free,
        price=state.price[rows].copy(),
        requests=requests,
        group_ids=group_ids,
        group_counts=group_counts,
        compat=compat_e,
        disruption_cost=state.dcost[rows].copy(),
        blocked=blocked,
        used_total=state.used[rows].copy(),
        group_pods=group_pods,
        group_node_count=gnc_e,
        mpn=mpn_e,
        hn_match=hn_e,
        cap=cap,
        zone_constraints=zone_constraints,
        node_zone=node_zone,
        zones=zones_e,
        node_zone_idx=node_zone_idx,
        node_captype=[state.row_captype[i] for i in rows],
        node_gang=state.gang[rows].copy(),
    )
    state.emitted = out
    state.emit_pos = {int(r): k for k, r in enumerate(rows)}
    state.emit_gids = np.asarray(gids, dtype=np.int64)
    state.emit_gpos = {int(g): k for k, g in enumerate(gids)}
    state.membership_changed = False
    state.touched_gids = set()
    # residency chain token: downstream device-resident mirrors key their
    # persistent buffers on the encoder identity (ops/device_state.py); a
    # re-emitted membership change carries no patch metadata, forcing the
    # mirror to re-upload (exactly the fallback the fast path avoids)
    out.__dict__["_device_chain"] = state
    return out


class LazyGroupPods:
    """List-like ``group_pods`` whose per-group pod lists materialize on
    first access.

    Rebuilding a churned group's flat pod list eagerly is O(pods in the
    group) per pass, which a large single-group cluster would pay on every
    steady-state emission. Hot consumers only
    read ``pods[0]`` (group representatives) or ``len(ct.group_pods)``;
    full materialization (canonical_form, nomination commits) is rare and
    pays the build exactly once per emission.

    Elements are either concrete lists (carried over from the previous
    emission) or zero-arg callables over SNAPSHOTTED state (the per-row
    bucket dicts are replaced, never mutated in place, so a shallow dict
    copy pins the emission-time content whatever the encoder does next).
    Built results cache in a side table so the SLOT objects stay stable:
    emissions chained across passes carry a slot over by identity, and
    materialization must never perturb it."""

    __slots__ = ("_items", "_built")

    def __init__(self, items: list):
        self._items = items  # each: list | callable -> list
        self._built: dict[int, list] = {}

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def _get(self, g: int):
        it = self._items[g]
        if callable(it):
            got = self._built.get(g)
            if got is None:
                got = self._built[g] = it()
            return got
        return it

    def __getitem__(self, g):
        if isinstance(g, slice):
            return [self._get(i) for i in range(*g.indices(len(self._items)))]
        return self._get(g)

    def __iter__(self):
        for g in range(len(self._items)):
            yield self._get(g)


class _SnapshotPods:
    """Zero-arg callable building the flat pod list of a snapshotted row
    bucket."""

    __slots__ = ("snap",)

    def __init__(self, snap: dict):
        self.snap = snap

    def __call__(self) -> list:
        out: list = []
        for r in sorted(self.snap):
            out.extend(self.snap[r])
        return out


def _lazy_group_pods(state: _EncoderState, gid: int):
    bucket = state.g_pods.get(gid)
    if not bucket:
        return []
    # row lists are replaced, never mutated in place: a shallow copy pins
    # the emission-time content
    return _SnapshotPods(dict(bucket))


def _carry_group_pods(prev_pods, g: int):
    """The previous emission's slot for group ``g`` WITHOUT materializing
    it (keeps untouched groups lazy across pass chains, depth-free, and
    preserves slot identity).
    Prefers an already-built list so a carried slot never rebuilds."""
    if isinstance(prev_pods, LazyGroupPods):
        it = prev_pods._items[g]
        if callable(it):
            return prev_pods._built.get(g, it)
        return it
    return prev_pods[g]


def _emit_fast(state: _EncoderState, prev, dirty_rows: list[int]):
    """Patch the previous emission in copy-on-write fashion.

    Valid ONLY when the live row set, live group set, and zone vocabulary
    are unchanged (``membership_changed`` is False): every dirty row then
    maps to an existing emitted position, and the group-axis arrays
    (requests/mpn/hn_match/zone_constraints) plus zone metadata can be
    shared with the previous emission object outright."""
    from .consolidate import ClusterTensors

    gpos = state.emit_gpos
    gids = state.emit_gids
    # emissions carry live-width slot tables (_emit_slot_width): a dirty
    # row that outgrew the previous emission's width cannot patch in
    # place — re-emit at the next ladder bucket instead (rare)
    W_prev = prev.group_ids.shape[1]
    if any(len(state.row_tokens[r]) > W_prev for r in dirty_rows):
        return _emit(state)
    free = prev.free.copy()
    price = prev.price.copy()
    used = prev.used_total.copy()
    dcost = prev.disruption_cost.copy()
    blocked = prev.blocked.copy()
    gnc_e = prev.group_node_count.copy()
    compat_e = prev.compat.copy()
    cap = prev.cap.copy() if prev.cap is not None else None
    group_ids = prev.group_ids.copy()
    group_counts = prev.group_counts.copy()
    pools = list(prev.nodepool_names)
    captype = list(prev.node_captype)
    G = len(gids)
    # Batched row rewrite: one fancy-indexed numpy op per buffer instead of
    # a per-dirty-row python loop of [G]-vector ops (a 1% churn pass on a
    # large cluster rewrites many rows; the loop overhead, not the
    # arithmetic, would dominate).
    rows_a = np.asarray(dirty_rows, dtype=np.int64)
    pos_a = np.asarray([state.emit_pos[r] for r in dirty_rows],
                       dtype=np.int64)
    free[pos_a] = state.alloc[rows_a] - state.used[rows_a]
    price[pos_a] = state.price[rows_a]
    used[pos_a] = state.used[rows_a]
    dcost[pos_a] = state.dcost[rows_a]
    blocked[pos_a] = state.blocked[rows_a]
    gang = (
        prev.node_gang.copy()
        if prev.node_gang is not None
        else np.zeros(len(prev.node_names), dtype=np.int32)
    )
    gang[pos_a] = state.gang[rows_a]
    for r, pos in zip(dirty_rows, pos_a):
        pools[pos] = state.row_pool[r]
        captype[pos] = state.row_captype[r]
    if G:
        cols = state.gnc[np.ix_(gids, rows_a)].astype(np.int32)   # [G, k]
        gnc_e[:, pos_a] = cols
        ccols = state.compat[np.ix_(gids, rows_a)]
        compat_e[:, pos_a] = ccols
        # per-row slot tables: few live tokens per row — stays a loop
        group_ids[pos_a] = 0
        group_counts[pos_a] = 0
        for r, pos in zip(dirty_rows, pos_a):
            slot = 0
            for gk in sorted(gpos[state.gid_of[t]]
                             for t in state.row_tokens[r]):
                if slot >= W_prev:
                    break
                group_ids[pos, slot] = gk
                group_counts[pos, slot] = gnc_e[gk, pos]
                slot += 1
        if cap is not None:
            cap[:, pos_a] = np.where(ccols, np.float32(_UNCAPPED),
                                     np.float32(0.0))
            capped = np.flatnonzero(state.g_mpn[gids] < _UNCAPPED)
            if len(capped):
                hn_int = prev.hn_match.astype(np.int32)
                occ = hn_int[capped] @ cols                       # [c, k]
                mpn_c = state.g_mpn[gids[capped]]
                cap[np.ix_(capped, pos_a)] = np.where(
                    ccols[capped],
                    np.maximum(mpn_c[:, None] - occ, 0).astype(np.float32),
                    0.0,
                )
    group_pods = prev.group_pods
    if state.touched_gids:
        items = [
            _carry_group_pods(prev.group_pods, k)
            for k in range(len(prev.group_pods))
        ]
        for gid in state.touched_gids:
            k = gpos.get(gid)
            if k is not None:
                items[k] = _lazy_group_pods(state, gid)
        group_pods = LazyGroupPods(items)
    out = ClusterTensors(
        node_names=prev.node_names,
        nodepool_names=pools,
        free=free,
        price=price,
        requests=prev.requests,
        group_ids=group_ids,
        group_counts=group_counts,
        compat=compat_e,
        disruption_cost=dcost,
        blocked=blocked,
        used_total=used,
        group_pods=group_pods,
        group_node_count=gnc_e,
        mpn=prev.mpn,
        hn_match=prev.hn_match,
        cap=cap,
        zone_constraints=prev.zone_constraints,
        node_zone=prev.node_zone,
        zones=prev.zones,
        node_zone_idx=prev.node_zone_idx,
        node_captype=captype,
        node_gang=gang,
    )
    state.emitted = out
    state.touched_gids = set()
    # device-residency patch metadata: the emission differs from ``prev``
    # in EXACTLY these node positions (group-axis arrays are shared), so a
    # device-resident mirror of ``prev`` becomes a mirror of ``out`` via
    # one scatter update of these rows — no full re-upload
    # (ops/device_state.py walks this chain).
    out.__dict__["_device_chain"] = state
    out.__dict__["_patch_base"] = prev
    out.__dict__["_patch_positions"] = np.asarray(
        sorted(state.emit_pos[r] for r in dirty_rows), dtype=np.int32
    )
    return out


# -- full (re)build ---------------------------------------------------------

def _full_build(state: _EncoderState, cluster, catalog, gmax,
                pods_by_node=None, rev_floor=None):
    from ..state.cluster import NODE_WRITE_SEQ
    from .consolidate import _encode_cluster

    rev0 = cluster.rev if rev_floor is None else rev_floor
    seq0 = NODE_WRITE_SEQ.v
    ct = _encode_cluster(cluster, catalog, gmax, pods_by_node=pods_by_node)
    lock = state.lock  # held by the caller — must survive the re-init
    state.__init__(gmax)
    state.lock = lock
    state.epoch = cluster.epoch
    state.rev = rev0
    state.node_seq = seq0
    state.catalog_key = catalog.cache_key()
    state.passes_since_full = 0
    from ..models.pod import gangs_enabled as _gangs_enabled

    state.gangs_armed = _gangs_enabled()
    state.overhead_seq = _overhead.seq()
    # every node NOT in the encoding is parked with its current version so
    # direct-mutation flips back to eligibility are caught by the scan
    tracked = set(ct.node_names) if ct is not None else set()
    for name, node in cluster.nodes.items():
        if name not in tracked:
            state.parked[name] = node._version
    if ct is None:
        state.emitted = None
        return None
    N = len(ct.node_names)
    state._grow_nodes(N)
    state.n_hi = N
    state.live[:N] = True
    nodes = cluster.nodes
    state.zones = list(ct.zones)
    state.zone_idx = {z: i for i, z in enumerate(state.zones)}
    state.zidx[:N] = ct.node_zone_idx
    state.price[:N] = ct.price
    state.used[:N] = ct.used_total
    state.dcost[:N] = ct.disruption_cost
    state.blocked[:N] = ct.blocked
    if ct.node_gang is not None:
        state.gang[:N] = ct.node_gang
    alloc_rows = []
    for i, name in enumerate(ct.node_names):
        node = nodes.get(name)
        state.row_name[i] = name
        state.row_of[name] = i
        state.row_pool[i] = ct.nodepool_names[i]
        state.row_captype[i] = ct.node_captype[i] if ct.node_captype else ""
        if node is not None:
            state.row_nver[i] = node._version
            state.row_claim[i] = node.nodeclaim_name
            state.claim_row[node.nodeclaim_name] = i
            # net of the per-node agent reservation, same as _fill_row —
            # the torn branch below is ALREADY net (ct.free is), so the
            # overhead applies per live row, never to the stack
            alloc_rows.append(_overhead.apply(
                np.asarray(node.allocatable.v, dtype=np.float32)
            ))
        else:  # torn snapshot: reconstruct so free still emits exactly
            alloc_rows.append(ct.free[i] + ct.used_total[i])
    state.alloc[:N] = np.stack(alloc_rows).astype(np.float32)
    # groups (the dummy podless group is NOT materialized: g_hi stays 0 and
    # emission recreates it, exactly like the full encoder does)
    has_pods = bool(ct.group_pods)
    if has_pods:
        G = len(ct.group_pods)
        state._grow_groups(G)
        state.g_hi = G
        state.g_requests[:G] = ct.requests[:G]
        state.g_mpn[:G] = ct.mpn[:G]
        state.gnc[:G, :N] = ct.group_node_count
        state.compat[:G, :N] = ct.compat
        state.hn_match[:G, :G] = ct.hn_match
        for gid, pods in enumerate(ct.group_pods):
            rep = pods[0]
            token = rep.group_token()
            state.g_token[gid] = token
            state.g_rep[gid] = rep
            state.gid_of[token] = gid
            state.g_refcount[gid] = len(pods)
            state.g_pods[gid] = {}
            mpn = int(state.g_mpn[gid])
            state.g_hn_sel[gid] = [
                t.label_selector
                for t in list(rep.anti_affinity) + list(rep.topology_spread)
                if getattr(t, "topology_key", "") == lbl.HOSTNAME
            ] if mpn < _UNCAPPED else []
            cons = ct.zone_constraints[gid] if ct.zone_constraints else []
            state.g_zone_terms[gid] = [
                (c.kind, c.skew, dict(c.selector or {})) for c in cons
            ]
            state.g_zc_match[gid] = [
                np.pad(np.asarray(c.match, dtype=bool),
                       (0, state.GB - len(c.match)))
                for c in cons
            ]
            for p in pods:
                r = state.row_of.get(p.node_name)
                if r is not None:
                    state.row_tokens[r].setdefault(token, []).append(p)
                    state.g_pods[gid].setdefault(r, []).append(p)
        # node classes (same projection the full encoder used)
        keys = set()
        for gid in range(state.g_hi):
            keys.update(state.g_rep[gid].requirements().keys())
        state.ref_keys = tuple(sorted(keys))
        for i, name in enumerate(ct.node_names):
            node = nodes.get(name)
            if node is not None:
                state.row_class[i] = _class_of(state, node)
    # trim the emitted slot tables to the live ladder width (the delta
    # emissions' representation — see _emit_slot_width): canonical content
    # is identical (consumers slice by live_slot_width), and every later
    # copy-on-write patch then copies ~gmax/width fewer slot-table bytes
    import dataclasses as _dc

    from .consolidate import live_slot_width as _lsw

    S_em = _emit_slot_width(_lsw(ct.group_counts), gmax)
    if S_em < ct.group_ids.shape[1]:
        ct = _dc.replace(
            ct,
            group_ids=np.ascontiguousarray(ct.group_ids[:, :S_em]),
            group_counts=np.ascontiguousarray(ct.group_counts[:, :S_em]),
        )
    state.emitted = ct
    state.emit_pos = {i: i for i in range(N)}
    G = len(ct.group_pods)
    state.emit_gids = np.arange(G, dtype=np.int64)
    state.emit_gpos = {g: g for g in range(G)}
    state.membership_changed = False
    state.touched_gids = set()
    ct.__dict__["_device_chain"] = state
    return ct


# -- dirty-set computation ----------------------------------------------------

def _collect_dirty(state: _EncoderState, cluster, changes) -> dict:
    """Dirty node names for one pass: journal entries first (store order),
    then the defensive version scan that catches direct attribute writes
    on live objects. The scan runs only when SOME Node field was written
    since the state's last look (NODE_WRITE_SEQ) — binds/unbinds don't
    count as node writes, so the steady-churn path skips the O(rows) walk
    entirely."""
    from ..state.cluster import NODE_WRITE_SEQ

    dirty: dict[str, None] = {}
    for name in changes.get("node", ()):
        dirty[name] = None
    for name in changes.get("pod", ()):
        if name:
            dirty[name] = None
    for cname in changes.get("claim", ()):
        claim = cluster.nodeclaims.get(cname)
        if claim is not None and claim.status.node_name:
            dirty[claim.status.node_name] = None
        row = state.claim_row.get(cname)
        if row is not None and state.row_name[row] is not None:
            dirty[state.row_name[row]] = None
    node_seq = NODE_WRITE_SEQ.v
    if node_seq != state.node_seq:
        nodes = cluster.nodes
        claims = cluster.nodeclaims
        for row in np.flatnonzero(state.live[: state.n_hi]):
            name = state.row_name[row]
            node = nodes.get(name)
            if node is None or node._version != state.row_nver[row]:
                dirty[name] = None
                continue
            claim = claims.get(state.row_claim[row])
            if claim is None or claim.deleted:
                dirty[name] = None
        for name, ver in list(state.parked.items()):
            node = nodes.get(name)
            if node is None:
                state.parked.pop(name, None)
            elif node._version != ver:
                dirty[name] = None
        state.node_seq = node_seq
    return dirty


# -- entry ------------------------------------------------------------------

_STATES_ATTR = "_cluster_encoders"


def incremental_encode_cluster(cluster, catalog, gmax, pods_by_node=None,
                               rev_floor=None):
    """Persistent-encoder entry behind ``ops.consolidate.encode_cluster``."""
    states = cluster.__dict__.setdefault(_STATES_ATTR, {})
    key = (catalog.uid, gmax)
    state = states.get(key)
    if state is None:
        state = states[key] = _EncoderState(gmax)

    with state.lock:
        # ``rev_floor`` is the revision at which the caller's pods_by_node
        # view was taken: changes landing after it re-patch next pass
        # instead of being silently absorbed into a stale snapshot.
        rev_now = cluster.rev if rev_floor is None else rev_floor
        catalog_key = catalog.cache_key()
        mode, cause = "patch", ""
        if state.epoch is not cluster.epoch:
            mode, cause = "full", "epoch"
        elif state.catalog_key != catalog_key:
            mode, cause = "full", "catalog"
        elif state.passes_since_full >= _refresh_every() > 0:
            mode, cause = "full", "refresh_interval"
        else:
            from ..models.pod import gangs_enabled as _gangs_enabled

            if (state.gangs_armed != _gangs_enabled()
                    or state.overhead_seq != _overhead.seq()):
                # the gang kill switch flipped or the per-node agent
                # reservation changed: every row's blocked/gang/alloc
                # content is suspect, not just the journaled ones
                mode, cause = "full", "gang_plane"
        changes = None
        if mode != "full":
            changes = cluster.changes_since(state.rev)
            if changes is None:
                mode, cause = "full", "journal_overflow"
        if mode == "full":
            _count("full", cause)
            return _full_build(state, cluster, catalog, gmax,
                               pods_by_node=pods_by_node, rev_floor=rev_floor)

        dirty = _collect_dirty(state, cluster, changes)

        if not dirty:
            state.rev = max(state.rev, rev_now)
            state.passes_since_full += 1
            _count("hit")
            return state.emitted

        live_n = int(state.live[: state.n_hi].sum())
        if len(dirty) > PATCH_FRAC * max(live_n, 1):
            _count("full", "dirty_ratio")
            return _full_build(state, cluster, catalog, gmax,
                               pods_by_node=pods_by_node, rev_floor=rev_floor)

        if pods_by_node is not None:
            pods_for = {n: pods_by_node.get(n, []) for n in dirty}
        else:
            pods_for = cluster.pods_on_nodes(dirty)
        rows_rewritten = 0
        for name in dirty:
            if _process_node(state, cluster, catalog, name,
                             pods_for.get(name, ())):
                rows_rewritten += 1
        state.rev = rev_now
        state.passes_since_full += 1
        if state.emitted is not None and not state.membership_changed:
            dirty_rows = [state.row_of[n] for n in dirty
                          if n in state.row_of]
            if not dirty_rows and not state.touched_gids:
                # every dirty name was parked/absent: the buffers are
                # untouched — keep the emission object (and with it,
                # every downstream per-ct memo) identical
                out = state.emitted
            else:
                out = _emit_fast(state, state.emitted, dirty_rows)
        else:
            out = _emit(state)
        _count("patch", dirty=rows_rewritten)
        return out


def invalidate_cluster_encoders(cluster) -> None:
    """Drop every persistent encoder for ``cluster`` (tests / big hammer)."""
    cluster.__dict__.pop(_STATES_ATTR, None)


# -- canonical comparison (the exactness contract) ----------------------------

def canonical_form(ct) -> Optional[dict]:
    """Order-independent content view of a ``ClusterTensors``.

    Node rows are keyed by node name and group rows by the group token (both
    unique), zones by name; slot tables become per-node {token: count} maps.
    Two encodings of the same cluster state — full or incrementally patched —
    must produce EQUAL canonical forms (exact values, no tolerance)."""
    if ct is None:
        return None
    node_order = sorted(range(len(ct.node_names)), key=lambda i: ct.node_names[i])
    G = len(ct.group_pods)
    tokens = [pods[0].group_token() for pods in ct.group_pods]
    group_order = sorted(range(G), key=lambda g: tokens[g])
    out = {
        "nodes": [ct.node_names[i] for i in node_order],
        "pools": [ct.nodepool_names[i] for i in node_order],
        "free": ct.free[node_order],
        "price": ct.price[node_order],
        "used": ct.used_total[node_order],
        "dcost": ct.disruption_cost[node_order],
        "blocked": ct.blocked[node_order],
        "gang": ct.node_gang[node_order] if ct.node_gang is not None else None,
        "captype": [ct.node_captype[i] for i in node_order] if ct.node_captype else [],
        "zone": [ct.node_zone[i] for i in node_order],
        "tokens": sorted(tokens),
        "requests": ct.requests[group_order] if G else ct.requests,
        "mpn": ct.mpn[group_order] if G else ct.mpn,
        "gnc": ct.group_node_count[np.ix_(group_order, node_order)]
        if G else ct.group_node_count[:, node_order],
        "compat": ct.compat[np.ix_(group_order, node_order)]
        if G else ct.compat[:, node_order],
        "cap": ct.cap[np.ix_(group_order, node_order)]
        if G and ct.cap is not None else None,
        "hn": ct.hn_match[np.ix_(group_order, group_order)] if G else None,
        "pods": [
            sorted(p.uid for p in ct.group_pods[g]) for g in group_order
        ],
        # Slot tables compare as {token: count}; a node with more distinct
        # groups than gmax slots keeps an encoder-order-dependent subset
        # (and is blocked either way), so overflow rows compare by marker.
        "slots": [
            (
                "overflow"
                if G and int((ct.group_node_count[:, i] > 0).sum())
                > ct.group_ids.shape[1]
                else {
                    tokens[int(g)]: int(c)
                    for g, c in zip(ct.group_ids[i], ct.group_counts[i])
                    if c > 0
                }
            )
            for i in node_order
        ],
        "zcons": [
            sorted(
                (
                    c.kind, c.skew,
                    tuple(sorted((c.selector or {}).items())),
                    tuple(sorted(
                        tokens[int(j)]
                        for j in np.flatnonzero(np.asarray(c.match))
                    )),
                )
                for c in (ct.zone_constraints[g] if ct.zone_constraints else [])
            )
            for g in group_order
        ],
    }
    return out


def canonical_equal(a, b) -> list[str]:
    """Compare two canonical forms; returns a list of differing keys."""
    if a is None or b is None:
        return [] if a is b else ["presence"]
    bad = []
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            if vb is None or va.shape != vb.shape or not np.array_equal(va, vb):
                bad.append(k)
        elif va != vb:
            bad.append(k)
    return bad
