"""Partition-aware incremental cluster encoding: the scale tier.

The JAX package's ``ops/encode_partition.py``, pure numpy. The single-chain
encoder (``ops/encode_delta.py``) makes a steady pass O(dirty rows), but its
fallback ladder is global: one zone churning past the dirty-ratio threshold
(or rolling the one bounded journal) re-encodes the whole cluster. This
module keeps ONE persistent encoder chain per (nodepool, zone) PARTITION,
fed by the store's per-partition change journals (``state/cluster.py``):

 - every partition patches or rebuilds on its own: a churn burst in one
   zone rebuilds that zone's rows only, and every other partition's pass is
   a revision check;
 - the partitions' emissions are merged into ONE ``ClusterTensors`` whose
   ``canonical_form`` equals a from-scratch global encode exactly;
 - the merged emission carries the copy-on-write patch chain
   (``_patch_base`` / ``_patch_positions``) the single-chain encoder emits,
   and its own ``_device_chain`` (the ``_PartitionedEncoder``); each
   partition's tensors carry their OWN chain, so the partitioned screen
   (``ops/consolidate.py`` ``_dispatch_screen_partitioned``) keeps one
   device mirror per partition (``ops/device_state.py``);
 - ``_partitions`` on the merged emission, ``[(key, part ct, offset, n)]``,
   names the partitions' slices of the node axis.

Cross-partition blocks (a group's compatibility with another partition's
nodes, hostname-selector occupancy across partitions, zone-constraint match
vectors) are computed from the same predicates the global encoder uses and
memoized per interned group token, so a steady merge touches only the
partitions that changed.

The partitions advance on a small pool of host threads (the chains are
independent, each under its own lock). The threads run numpy only and never
touch a CUDA tensor: the device mirrors are patched later, by the screen,
on the caller's thread.

Outcomes: each partition's on ``karpenter_encode_cache_total{path=
"cluster_part"}``, the merged pass's through ``encode_delta``'s counters
(``ENCODE_COUNTS``, ``LAST_ENCODE``, which also names the partitions'
outcomes) on ``path="cluster"``; ``karpenter_encode_partitions`` holds the
partition count.

Knobs: ``KARPENTER_TPU_PARTITION_ENCODE`` (1 force on / 0 off / auto:
clusters of at least ``KARPENTER_TPU_PARTITION_MIN_NODES`` nodes, default
8,192, in more than one partition); ``KARPENTER_TPU_PARTITION_PATCH_WORKERS``
(the advance pool's workers, 0 serial; default one per partition, at most
min(8, cores)).
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..models import labels as lbl
from ..models.resources import NUM_RESOURCES
from .encode_delta import (
    LAST_ENCODE,
    _EncoderState,
    _UNCAPPED,
    LazyGroupPods,
    PATCH_FRAC,
    _carry_group_pods,
    _collect_dirty,
    _count,
    _emit,
    _emit_fast,
    _full_build,
    _matches,
    _process_node,
    _refresh_every,
    _remove_row,
    group_rep,
)

_PSTATES_ATTR = "_cluster_part_encoders"


def _count_part(outcome: str, cause: str = "") -> None:
    """One partition's outcome on ``karpenter_encode_cache_total{path=
    "cluster_part"}`` (the cause of a full rebuild rides along)."""
    from ..metrics import ENCODE_CACHE

    if cause:
        ENCODE_CACHE.inc(path="cluster_part", outcome=outcome, cause=cause)
    else:
        ENCODE_CACHE.inc(path="cluster_part", outcome=outcome)


class _MergedPods:
    """Lazy flat pod list for one merged group: concatenates the sources'
    per-part lists (part order) on first access. ``first()`` serves the
    representative without materializing anything — merged emissions stay
    O(changed) even when a 255k-pod group rides along untouched."""

    __slots__ = ("sources",)

    def __init__(self, sources: list):
        self.sources = sources  # [(part group_pods, k), ...] in part order

    def __call__(self) -> list:
        out: list = []
        for pods, k in self.sources:
            out.extend(pods[k])
        return out

    def first(self):
        for pods, k in self.sources:
            rep = group_rep(pods, k)
            if rep is not None:
                return rep
        return None


#: shared advance pool: partitions patch concurrently (the per-partition
#: chains are independent, each under its own state lock; store reads take
#: the cluster lock per call). Sized small — the win is overlapping the
#: GIL-releasing numpy row/merge work, not oversubscribing the host.
_ADVANCE_POOL: Optional[ThreadPoolExecutor] = None
_ADVANCE_POOL_LOCK = threading.Lock()


def _advance_workers(n_parts: int) -> int:
    """0/1 = serial. KARPENTER_TPU_PARTITION_PATCH_WORKERS pins (0 = off);
    auto: one worker per partition, capped at min(8, cores)."""
    try:
        pinned = int(os.environ.get("KARPENTER_TPU_PARTITION_PATCH_WORKERS", "-1"))
    except ValueError:
        pinned = -1
    if pinned >= 0:
        return min(pinned, n_parts)
    return min(n_parts, 8, os.cpu_count() or 1)


def _advance_pool() -> ThreadPoolExecutor:
    global _ADVANCE_POOL
    with _ADVANCE_POOL_LOCK:
        if _ADVANCE_POOL is None:
            _ADVANCE_POOL = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="part-encode"
            )
        return _ADVANCE_POOL


def partition_encode_active(cluster) -> bool:
    """Should this cluster encode through the partitioned path?"""
    mode = os.environ.get("KARPENTER_TPU_PARTITION_ENCODE", "auto")
    if mode == "0":
        return False
    if getattr(cluster, "partition_keys", None) is None:
        return False
    keys = cluster.partition_keys()
    if mode == "1":
        return len(keys) >= 1
    min_nodes = int(os.environ.get("KARPENTER_TPU_PARTITION_MIN_NODES", "8192"))
    return len(keys) > 1 and len(cluster.nodes) >= min_nodes


class _PartitionedEncoder:
    """Per-partition encoder chains + merged-emission bookkeeping for one
    (cluster, catalog, gmax)."""

    def __init__(self, gmax: int):
        self.gmax = gmax
        self.lock = threading.RLock()
        self.epoch = None
        self.catalog_key = None
        self.states: dict[tuple, _EncoderState] = {}
        self.order: list[tuple] = []        # stable merge order of keys
        self.merged = None                  # last merged emission
        self.parts_used: dict[tuple, object] = {}   # key -> part ct merged
        self.part_tokens: dict[tuple, list] = {}    # key -> tokens (part order)
        self.offsets: dict[tuple, int] = {}
        self.tokens: list = []              # merged token order (last merge)
        self.reps: list = []                # merged group representatives
        self.overflow_streak: dict[tuple, int] = {}
        # cross-partition memos -------------------------------------------
        # (key, token) -> [n_part_nodes] bool compat column for a group
        # with no pods in that partition; invalidated when the partition's
        # emission changes (its rows/labels may have moved)
        self.cross_compat: dict[tuple, np.ndarray] = {}
        # (token_i, token_j) -> bool hostname-selector match (token content
        # is process-stable, so these never invalidate)
        self.hn_memo: dict[tuple, bool] = {}
        # token -> hostname selector list / zone term list (ditto)
        self.sel_memo: dict[int, list] = {}
        self.term_memo: dict[int, list] = {}
        # (token_g, ci, token_j) -> bool zone-constraint selector match
        self.zc_memo: dict[tuple, bool] = {}


def _hn_sels(pstate: _PartitionedEncoder, token: int, rep) -> list:
    sels = pstate.sel_memo.get(token)
    if sels is None:
        if rep.hostname_cap() >= _UNCAPPED:
            sels = []
        else:
            sels = [
                t.label_selector
                for t in list(rep.anti_affinity) + list(rep.topology_spread)
                if getattr(t, "topology_key", "") == lbl.HOSTNAME
            ]
        pstate.sel_memo[token] = sels
    return sels


def _zone_terms(pstate: _PartitionedEncoder, token: int, rep) -> list:
    """(kind, skew, selector) zone terms in the global encoder's
    construction order (anti/block, DoNotSchedule spread, affinity)."""
    terms = pstate.term_memo.get(token)
    if terms is None:
        terms = []
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
        pstate.term_memo[token] = terms
    return terms


def _cross_compat_col(pstate, key, ct, token, rep, nodes) -> np.ndarray:
    """[n] bool: may group ``token`` run on partition ``key``'s emitted
    nodes? Evaluated on live node labels/taints with a per-class dedup —
    the exact predicate the global encoder's class projection computes.
    Memoized per (partition, token); the caller invalidates a partition's
    entries whenever its emission changes."""
    hit = pstate.cross_compat.get((key, token))
    if hit is not None and len(hit) == len(ct.node_names):
        return hit
    reqs = rep.requirements()
    rkeys = tuple(reqs.keys())
    col = np.zeros(len(ct.node_names), dtype=bool)
    memo: dict[tuple, bool] = {}
    for i, name in enumerate(ct.node_names):
        node = nodes.get(name)
        if node is None:
            continue  # torn snapshot: conservative False
        k = (tuple(node.labels.get(x) for x in rkeys), tuple(node.taints))
        ok = memo.get(k)
        if ok is None:
            labels = {x: v for x, v in zip(rkeys, k[0]) if v is not None}
            ok = memo[k] = bool(
                reqs.satisfied_by_labels(labels) and rep.tolerates_all(k[1])
            )
        col[i] = ok
    pstate.cross_compat[(key, token)] = col
    return col


def _zc_match(pstate, token_g: int, ci: int, sel: dict, token_j: int,
              rep_j) -> bool:
    k = (token_g, ci, token_j)
    hit = pstate.zc_memo.get(k)
    if hit is None:
        hit = pstate.zc_memo[k] = _matches(sel, rep_j)
        if len(pstate.zc_memo) > 1 << 16:
            pstate.zc_memo.clear()
    return hit


def _hn_match(pstate, token_i: int, rep_i, token_j: int, rep_j) -> bool:
    k = (token_i, token_j)
    hit = pstate.hn_memo.get(k)
    if hit is None:
        sels = _hn_sels(pstate, token_i, rep_i)
        hit = pstate.hn_memo[k] = any(_matches(s, rep_j) for s in sels)
        if len(pstate.hn_memo) > 1 << 16:
            pstate.hn_memo.clear()
    return hit


# -- per-partition advance ----------------------------------------------------

def _process_node_part(state, cluster, catalog, key, name, plist) -> bool:
    """Membership-aware ``_process_node``: a node whose journal routing
    moved to another partition is dropped from this one (the hop entry was
    routed to both sides, so the new owner picks it up the same pass)."""
    owner = cluster.partition_of(name)
    if owner is not None and owner != key:
        row = state.row_of.get(name)
        if row is not None:
            _remove_row(state, row)
        state.parked.pop(name, None)
        return row is not None
    return _process_node(state, cluster, catalog, name, plist)


def _overflow_event(pstate, key, streak: int) -> None:
    from ..events import WARNING, default_recorder

    default_recorder().publish(
        "Cluster", f"{key[0]}/{key[1]}", "EncodeJournalOverflow",
        f"partition {key} rolled its change journal {streak} passes in a "
        "row (full re-encode each time) — the journal ladder is undersized "
        "for this partition's churn",
        type=WARNING,
    )


def _advance_partition(pstate, state, cluster, catalog, key,
                       pods_by_node, rev_now, part_filter):
    """Advance one partition's chain; returns (outcome, cause).

    The emission lands on ``state.emitted`` exactly as in the single-chain
    flow: same-object on no-change, ``_emit_fast`` copy-on-write patch when
    membership held, full ``_emit``/``_full_build`` otherwise."""
    gmax = pstate.gmax
    mode, cause = "patch", ""
    if state.epoch is not cluster.epoch:
        mode, cause = "full", "epoch"
    elif state.catalog_key != pstate.catalog_key:
        mode, cause = "full", "catalog"
    elif state.passes_since_full >= _refresh_every() > 0:
        mode, cause = "full", "refresh_interval"
    changes = None
    if mode != "full":
        changes = cluster.partition_changes_since(key, state.rev)
        if changes is None:
            mode, cause = "full", "journal_overflow"
    if mode == "full":
        if cause == "journal_overflow":
            streak = pstate.overflow_streak.get(key, 0) + 1
            pstate.overflow_streak[key] = streak
            if streak >= 2:
                _overflow_event(pstate, key, streak)
        else:
            pstate.overflow_streak[key] = 0
        _full_build(state, cluster, catalog, gmax,
                    pods_by_node=pods_by_node, rev_floor=rev_now,
                    node_filter=part_filter())
        return "full", cause

    dirty = _collect_dirty(
        state, cluster, changes,
        claim_owner=lambda node_name: cluster.partition_of(node_name) == key,
    )

    pstate.overflow_streak[key] = 0
    if not dirty:
        state.rev = max(state.rev, rev_now)
        state.passes_since_full += 1
        return "hit", ""

    live_n = int(state.live[: state.n_hi].sum())
    if len(dirty) > PATCH_FRAC * max(live_n, 1):
        _full_build(state, cluster, catalog, gmax,
                    pods_by_node=pods_by_node, rev_floor=rev_now,
                    node_filter=part_filter())
        return "full", "dirty_ratio"

    if pods_by_node is not None:
        pods_for = {n: pods_by_node.get(n, []) for n in dirty}
    else:
        pods_for = cluster.pods_on_nodes(dirty)
    for name in dirty:
        _process_node_part(state, cluster, catalog, key, name,
                           pods_for.get(name, ()))
    state.rev = rev_now
    state.passes_since_full += 1
    if state.emitted is not None and not state.membership_changed:
        dirty_rows = [state.row_of[n] for n in dirty if n in state.row_of]
        if not dirty_rows and not state.touched_gids:
            pass  # untouched buffers: keep the emission object identical
        else:
            _emit_fast(state, state.emitted, dirty_rows)
    else:
        _emit(state)
    return "patch", ""


# -- merge --------------------------------------------------------------------

def _chain_positions(ct, base) -> Optional[np.ndarray]:
    """Dirty node positions connecting ``ct`` back to ``base`` through the
    copy-on-write patch chain (None = not connected)."""
    chunks: list[np.ndarray] = []
    cur = ct
    for _ in range(16):
        if cur is base:
            if not chunks:
                return np.zeros(0, dtype=np.int32)
            return np.unique(np.concatenate(chunks)).astype(np.int32)
        nxt = cur.__dict__.get("_patch_base")
        pos = cur.__dict__.get("_patch_positions")
        if nxt is None or pos is None:
            return None
        chunks.append(pos)
        cur = nxt
    return None


def _stamp(pstate, out, parts) -> None:
    out.__dict__["_device_chain"] = pstate
    out.__dict__["_partitions"] = [
        (key, ct, pstate.offsets[key], len(ct.node_names))
        for key, ct in parts
    ]


def _merge_full(pstate: _PartitionedEncoder, cluster, parts):
    """Build the merged global ClusterTensors from scratch (exact vs a
    global ``_encode_cluster`` in canonical form)."""
    from .consolidate import ClusterTensors, ZoneConstraint

    gmax = pstate.gmax
    nodes = cluster.nodes
    # cross-compat memos are per (partition, token) COLUMNS of the part's
    # emitted rows: any partition whose emission object changed may have
    # moved/relabelled rows under the same length, so its entries must go
    # (the fast path does the same for its changed set)
    for key, ct in parts:
        if pstate.parts_used.get(key) is not ct:
            for mk in [t for t in pstate.cross_compat if t[0] == key]:
                pstate.cross_compat.pop(mk, None)
    pstate.offsets = {}
    N = 0
    for key, ct in parts:
        pstate.offsets[key] = N
        N += len(ct.node_names)
    if N == 0:
        pstate.merged = None
        pstate.parts_used = {}
        return None

    # group union (first-seen across parts, in stable part order);
    # representatives read via group_rep so a lazy emission never
    # materializes a whole group's flat list just to name its token
    tokens: list = []
    tok_idx: dict[int, int] = {}
    reps: list = []
    tok_sources: dict[int, list] = {}  # token -> [(part pods, k)] part order
    pstate.part_tokens = {}
    for key, ct in parts:
        toks = []
        for k_ in range(len(ct.group_pods)):
            t = group_rep(ct.group_pods, k_).group_token()
            toks.append(t)
            tok_sources.setdefault(t, []).append((ct.group_pods, k_))
        pstate.part_tokens[key] = toks
        for k_, t in enumerate(toks):
            if t not in tok_idx:
                tok_idx[t] = len(tokens)
                tokens.append(t)
                reps.append(group_rep(ct.group_pods, k_))
    G = len(tokens)
    pstate.tokens, pstate.reps = tokens, reps

    node_names: list = []
    pools: list = []
    node_zone: list = []
    captype: list = []
    zones: list = []
    zidx: dict[str, int] = {}
    zone_chunks = []
    for key, ct in parts:
        node_names.extend(ct.node_names)
        pools.extend(ct.nodepool_names)
        node_zone.extend(ct.node_zone)
        captype.extend(ct.node_captype)
        for z in ct.zones:
            if z not in zidx:
                zidx[z] = len(zones)
                zones.append(z)
        remap = np.array([zidx[z] for z in ct.zones], dtype=np.int32)
        zone_chunks.append(remap[ct.node_zone_idx])
    node_zone_idx = np.concatenate(zone_chunks).astype(np.int32)
    free = np.concatenate([ct.free for _, ct in parts])
    price = np.concatenate([ct.price for _, ct in parts])
    used = np.concatenate([ct.used_total for _, ct in parts])
    dcost = np.concatenate([ct.disruption_cost for _, ct in parts])
    blocked = np.concatenate([ct.blocked for _, ct in parts])
    gang = np.concatenate([
        ct.node_gang if ct.node_gang is not None
        else np.zeros(len(ct.node_names), dtype=np.int32)
        for _, ct in parts
    ]).astype(np.int32)

    # merged slot width = the widest part's live width (parts emit
    # ladder-trimmed tables — encode_delta._emit_slot_width)
    W_m = max((ct.group_ids.shape[1] for _k, ct in parts), default=4)
    group_ids = np.zeros((N, W_m), dtype=np.int32)
    group_counts = np.zeros((N, W_m), dtype=np.int32)
    if G:
        requests = np.zeros((G, NUM_RESOURCES), dtype=np.float32)
        mpn = np.full(G, _UNCAPPED, dtype=np.int32)
        gnc = np.zeros((G, N), dtype=np.int32)
        compat = np.zeros((G, N), dtype=bool)
        group_pods = LazyGroupPods(
            [_MergedPods(tok_sources[t]) for t in tokens]
        )
        for key, ct in parts:
            off = pstate.offsets[key]
            n = len(ct.node_names)
            toks = pstate.part_tokens[key]
            cols = np.arange(off, off + n)
            if toks:
                gm = np.array([tok_idx[t] for t in toks], dtype=np.int64)
                Gp = len(toks)
                gnc[np.ix_(gm, cols)] = ct.group_node_count[:Gp]
                compat[np.ix_(gm, cols)] = ct.compat[:Gp]
                requests[gm] = ct.requests[:Gp]
                mpn[gm] = ct.mpn[:Gp]
                W_p = ct.group_ids.shape[1]
                group_ids[off:off + n, :W_p] = np.where(
                    ct.group_counts > 0, gm[ct.group_ids], 0
                )
                group_counts[off:off + n, :W_p] = ct.group_counts
            own = {tok_idx[t] for t in toks}
            for g in range(G):
                if g in own:
                    continue
                compat[g, cols] = _cross_compat_col(
                    pstate, key, ct, tokens[g], reps[g], nodes
                )
        hn = np.zeros((G, G), dtype=bool)
        for gi in range(G):
            if mpn[gi] >= _UNCAPPED:
                continue
            for gj in range(G):
                hn[gi, gj] = _hn_match(
                    pstate, tokens[gi], reps[gi], tokens[gj], reps[gj]
                )
        cap = np.where(compat, np.float32(_UNCAPPED), np.float32(0.0))
        for gi in range(G):
            if mpn[gi] >= _UNCAPPED:
                continue
            occupied = hn[gi].astype(np.int32) @ gnc
            cap[gi] = np.where(
                compat[gi],
                np.maximum(mpn[gi] - occupied, 0).astype(np.float32), 0.0,
            )
        zone_constraints = []
        for gi in range(G):
            cons = []
            for ci, (kind, skew, sel) in enumerate(
                _zone_terms(pstate, tokens[gi], reps[gi])
            ):
                row = np.array([
                    _zc_match(pstate, tokens[gi], ci, sel, tokens[gj],
                              reps[gj])
                    for gj in range(G)
                ], dtype=bool)
                cons.append(ZoneConstraint(kind=kind, skew=skew, match=row,
                                           selector=sel))
            zone_constraints.append(cons)
    else:
        # podless cluster: the global encoder's G=1 dummy group
        requests = np.zeros((1, NUM_RESOURCES), dtype=np.float32)
        mpn = np.full(1, _UNCAPPED, dtype=np.int32)
        gnc = np.zeros((1, N), dtype=np.int32)
        compat = np.zeros((1, N), dtype=bool)
        hn = np.zeros((1, 1), dtype=bool)
        cap = np.where(compat, np.float32(_UNCAPPED), np.float32(0.0))
        zone_constraints = []
        group_pods = []

    out = ClusterTensors(
        node_names=node_names,
        nodepool_names=pools,
        free=free,
        price=price,
        requests=requests,
        group_ids=group_ids,
        group_counts=group_counts,
        compat=compat,
        disruption_cost=dcost,
        blocked=blocked,
        used_total=used,
        group_pods=group_pods,
        group_node_count=gnc,
        mpn=mpn,
        hn_match=hn,
        cap=cap,
        zone_constraints=zone_constraints,
        node_zone=node_zone,
        zones=zones,
        node_zone_idx=node_zone_idx,
        node_captype=captype,
        node_gang=gang,
    )
    _stamp(pstate, out, parts)
    pstate.merged = out
    pstate.parts_used = {key: ct for key, ct in parts}
    return out


def _merge_fast(pstate: _PartitionedEncoder, cluster, parts, changed):
    """Copy-on-write merged patch: the part set, every part's node count,
    and every part's group membership are unchanged (each changed part is
    chain-connected to its previous emission and shares its group-axis
    arrays), so group-axis arrays and unchanged part slices come straight
    from the previous merged emission."""
    from .consolidate import ClusterTensors

    prev = pstate.merged
    gmax = pstate.gmax
    nodes = cluster.nodes
    G = len(pstate.tokens)
    tok_idx = {t: g for g, t in enumerate(pstate.tokens)}
    free = prev.free.copy()
    price = prev.price.copy()
    used = prev.used_total.copy()
    dcost = prev.disruption_cost.copy()
    blocked = prev.blocked.copy()
    gang = (
        prev.node_gang.copy()
        if prev.node_gang is not None
        else np.zeros(len(prev.node_names), dtype=np.int32)
    )
    pools = list(prev.nodepool_names)
    captype = list(prev.node_captype)
    gnc = prev.group_node_count.copy()
    compat = prev.compat.copy()
    cap = prev.cap.copy() if prev.cap is not None else None
    group_ids = prev.group_ids.copy()
    group_counts = prev.group_counts.copy()
    group_pods = prev.group_pods
    touched_tokens: set[int] = set()
    positions: list[np.ndarray] = []
    capped = (
        np.flatnonzero(prev.mpn < _UNCAPPED)
        if G and prev.mpn is not None else np.zeros(0, dtype=np.int64)
    )
    hn_int = prev.hn_match.astype(np.int32) if len(capped) else None

    for key, ct in parts:
        if key not in changed:
            continue
        prev_ct = pstate.parts_used[key]
        off = pstate.offsets[key]
        n = len(ct.node_names)
        cols = slice(off, off + n)
        col_idx = np.arange(off, off + n)
        pos = changed[key]
        positions.append(pos.astype(np.int32) + off)
        # invalidate this partition's cross-compat memo: its rows moved
        for t in list(pstate.cross_compat):
            if t[0] == key:
                pstate.cross_compat.pop(t, None)
        free[cols] = ct.free
        price[cols] = ct.price
        used[cols] = ct.used_total
        dcost[cols] = ct.disruption_cost
        blocked[cols] = ct.blocked
        gang[cols] = (
            ct.node_gang if ct.node_gang is not None
            else np.zeros(n, dtype=np.int32)
        )
        pools[off:off + n] = ct.nodepool_names
        captype[off:off + n] = ct.node_captype
        toks = pstate.part_tokens[key]
        if toks:
            gm = np.array([tok_idx[t] for t in toks], dtype=np.int64)
            Gp = len(toks)
            gnc[np.ix_(gm, col_idx)] = ct.group_node_count[:Gp]
            compat[np.ix_(gm, col_idx)] = ct.compat[:Gp]
            # same-width guaranteed by the fast-path eligibility check;
            # beyond-W_p columns of this part's rows are zero on both sides
            W_p = ct.group_ids.shape[1]
            group_ids[cols, :W_p] = np.where(
                ct.group_counts > 0, gm[ct.group_ids], 0
            )
            group_counts[cols, :W_p] = ct.group_counts
            for k_, t in enumerate(toks):
                # slot identity, not content: lazy emissions carry an
                # untouched group's slot object across passes unchanged
                if _carry_group_pods(ct.group_pods, k_) is not (
                    _carry_group_pods(prev_ct.group_pods, k_)
                ):
                    touched_tokens.add(t)
        own = {tok_idx[t] for t in toks}
        for g in range(G):
            if g in own:
                continue
            compat[g, col_idx] = _cross_compat_col(
                pstate, key, ct, pstate.tokens[g], pstate.reps[g], nodes
            )
        if cap is not None and G:
            cap[:, col_idx] = np.where(
                compat[:, col_idx], np.float32(_UNCAPPED), np.float32(0.0)
            )
            if len(capped):
                occ = hn_int[capped] @ gnc[:, col_idx]
                mpn_c = prev.mpn[capped]
                cap[np.ix_(capped, col_idx)] = np.where(
                    compat[np.ix_(capped, col_idx)],
                    np.maximum(mpn_c[:, None] - occ, 0).astype(np.float32),
                    0.0,
                )
    if touched_tokens:
        items = [
            _carry_group_pods(prev.group_pods, g)
            for g in range(len(prev.group_pods))
        ]
        for t in touched_tokens:
            sources = [
                (ct2.group_pods, k_)
                for key2, ct2 in parts
                for k_, t2 in enumerate(pstate.part_tokens[key2])
                if t2 == t
            ]
            items[tok_idx[t]] = _MergedPods(sources)
        group_pods = LazyGroupPods(items)

    out = ClusterTensors(
        node_names=prev.node_names,
        nodepool_names=pools,
        free=free,
        price=price,
        requests=prev.requests,
        group_ids=group_ids,
        group_counts=group_counts,
        compat=compat,
        disruption_cost=dcost,
        blocked=blocked,
        used_total=used,
        group_pods=group_pods,
        group_node_count=gnc,
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
    out.__dict__["_patch_base"] = prev
    out.__dict__["_patch_positions"] = (
        np.unique(np.concatenate(positions)).astype(np.int32)
        if positions else np.zeros(0, dtype=np.int32)
    )
    _stamp(pstate, out, parts)
    pstate.merged = out
    pstate.parts_used = {key: ct for key, ct in parts}
    return out


# -- entry --------------------------------------------------------------------

def partitioned_encode_cluster(cluster, catalog, gmax, pods_by_node=None,
                               rev_floor=None):
    """Partition-parallel sibling of ``incremental_encode_cluster``."""
    from ..metrics import ENCODE_PARTITIONS

    pstates = cluster.__dict__.setdefault(_PSTATES_ATTR, {})
    skey = (catalog.uid, gmax)
    pstate = pstates.get(skey)
    if pstate is None:
        pstate = pstates[skey] = _PartitionedEncoder(gmax)

    with pstate.lock:
        rev_now = cluster.rev if rev_floor is None else rev_floor
        catalog_key = catalog.cache_key()
        if pstate.epoch is not cluster.epoch or pstate.catalog_key != catalog_key:
            # global invalidation: DROP every chain and the merge state
            # outright. A reset store (Environment.reset re-runs __init__)
            # may lack partition keys the old incarnation had; keeping
            # their states would merge ghost emissions from the previous
            # epoch into the new cluster's tensors.
            pstate.states.clear()
            pstate.order.clear()
            pstate.merged = None
            pstate.parts_used = {}
            pstate.offsets = {}
            pstate.part_tokens = {}
            pstate.cross_compat.clear()
            pstate.overflow_streak.clear()
            pstate.epoch = cluster.epoch
            pstate.catalog_key = catalog_key
        keys = cluster.partition_keys()
        ENCODE_PARTITIONS.set(float(len(keys)))
        # full-build node scoping, computed lazily ONCE per pass (only a
        # rebuilding partition pays the O(nodes) router walk); thread-safe:
        # concurrent advances may race the first build
        part_map: dict = {}
        part_map_lock = threading.Lock()

        def part_filter_for(key):
            def _filter():
                with part_map_lock:
                    if not part_map:
                        part_map.update(cluster.partition_nodes())
                    return part_map.get(key, set())
            return _filter

        outcomes: dict[tuple, tuple] = {}
        for key in keys:
            if key not in pstate.states:
                pstate.states[key] = _EncoderState(gmax)
                pstate.order.append(key)

        def advance(key):
            state = pstate.states[key]
            with state.lock:
                return _advance_partition(
                    pstate, state, cluster, catalog, key,
                    pods_by_node, rev_now, part_filter_for(key),
                )

        # partitions advance CONCURRENTLY: each chain is independent (own
        # state lock, own journal cursor), the heavy row/emission work is
        # numpy (GIL-releasing), and a churn burst rarely lands in exactly
        # one zone — serial chain walks made every pass pay the sum instead
        # of the max.
        workers = _advance_workers(len(keys))
        if workers > 1:
            # the shared pool is fixed at 8 threads; the computed cap (incl.
            # the KARPENTER_TPU_PARTITION_PATCH_WORKERS pin and the
            # core-count auto cap) is enforced by a semaphore so a
            # pinned-down host is never oversubscribed past the knob
            gate = threading.BoundedSemaphore(workers)

            def advance_bounded(key):
                with gate:
                    return advance(key)

            futs = {
                key: _advance_pool().submit(advance_bounded, key)
                for key in keys
            }
            for key, fut in futs.items():
                outcomes[key] = fut.result()
        else:
            for key in keys:
                outcomes[key] = advance(key)
        for key, (outcome, cause) in outcomes.items():
            _count_part(outcome, cause)

        parts = [
            (key, pstate.states[key].emitted)
            for key in pstate.order
            if key in pstate.states and pstate.states[key].emitted is not None
        ]

        # pass-level outcome + merge strategy
        any_full = [c for k, (o, c) in outcomes.items() if o == "full"]
        part_keys = [k for k, _ in parts]
        same_set = (
            pstate.merged is not None
            and part_keys == list(pstate.parts_used.keys())
        )
        unchanged = same_set and all(
            ct is pstate.parts_used[key] for key, ct in parts
        )
        per_part = {"/".join(map(str, k)): o for k, (o, _c) in outcomes.items()}
        if unchanged:
            _count("hit")
            LAST_ENCODE["partitions"] = per_part
            return pstate.merged

        changed: dict = {}
        fast = same_set and not any_full
        if fast:
            for key, ct in parts:
                prev_ct = pstate.parts_used[key]
                if ct is prev_ct:
                    continue
                if (
                    len(ct.node_names) != len(prev_ct.node_names)
                    or ct.requests is not prev_ct.requests
                    # slot-table width moved (a row grew groups): the
                    # sliced fast-merge write needs equal widths
                    or ct.group_ids.shape[1] != prev_ct.group_ids.shape[1]
                ):
                    fast = False
                    break
                pos = _chain_positions(ct, prev_ct)
                if pos is None:
                    fast = False
                    break
                changed[key] = pos
        if fast:
            out = _merge_fast(pstate, cluster, parts, changed)
            _count("patch")
        else:
            out = _merge_full(pstate, cluster, parts)
            if any_full:
                _count("full", any_full[0])
            else:
                _count("patch")
        LAST_ENCODE["partitions"] = per_part
        LAST_ENCODE["merge"] = "fast" if fast else "full"
        return out
