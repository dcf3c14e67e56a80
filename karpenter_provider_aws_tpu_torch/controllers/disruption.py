"""Disruption controller: consolidation, emptiness, expiration, drift.

Owns what the reference consumes from the core disruption controller
(designs/consolidation.md; SURVEY.md section 3.4):

 - emptiness: nodes with no pods (policy WhenEmpty or WhenUnderutilized)
 - consolidation-delete: the repack screen proves a node's pods fit
   on surviving capacity; candidates accepted greedily in disruption-cost
   order with host-side revalidation against the updated free matrix
   (multi-node consolidation)
 - consolidation-replace: all of a node's pods fit one cheaper type; the
   replacement is launched BEFORE the old claim is deleted
 - expiration: claim older than the pool's expireAfter
 - drift: CloudProvider.IsDrifted (static hash / image / subnet / SG)

Per-pool disruption budgets (NodePool.spec.disruption.budgets) cap how many
nodes may be disrupted in one pass, counting already-draining claims.

This is the JAX package's controller with its imports changed. The screen
runs on the controller's ``device`` (``None`` means CUDA, through the repack
kernel, and raises where there is none; ``"cpu"`` runs the plain version),
with the device-resident mirror of ``ops/device_state.py`` on that device.
Each pass stamps its wall split into ``timings`` (ms: the dirty scan, the
expiration / drift / emptiness phases, and consolidation's encode, screen
dispatch, candidate walk, screen wait, feasible-prefix search, commits and
replacements), the disruption layer's own metrics.
The why plane is not carried, so a budget rejection is audited without the
JAX package's ``why`` verdict and its rejected-consolidation counter.
"""

from __future__ import annotations

import heapq
import logging
import os
import time
from typing import Optional

import numpy as np

from ..cloudprovider.cloudprovider import CloudProvider, DriftReason
from ..models import labels as lbl
from ..ops.consolidate import (
    ClusterTensors,
    cheaper_replacement,
    dispatch_screen,
    encode_cluster,
    repack_set_feasible,
)
from ..state.cluster import Cluster
from ..utils.clock import Clock, RealClock

log = logging.getLogger("karpenter.tpu.disruption")


def _dirty_enabled() -> bool:
    return os.environ.get("KARPENTER_TPU_DISRUPTION_DIRTY", "1") != "0"


def _resweep_s() -> float:
    """Belt-and-braces full-rebuild interval for the dirty-set walk state:
    bounds the staleness window of in-place mutations the change journal
    cannot see (an annotation dict edited on a live object), exactly like
    the encoder's KARPENTER_TPU_ENCODE_REFRESH_EVERY."""
    return float(os.environ.get("KARPENTER_TPU_DISRUPTION_RESWEEP_S", "300"))


class _LazyBudget:
    """Deferred ``_BudgetTracker``: building one snapshots every claim
    (O(claims)), which a quiet pass — the pass that disrupts nothing —
    must never pay. The tracker materializes on the first consume/left
    call, i.e. only when some phase actually found a candidate."""

    __slots__ = ("cluster", "now", "_real")

    def __init__(self, cluster, now: float):
        self.cluster = cluster
        self.now = now
        self._real = None

    def _tracker(self) -> "_BudgetTracker":
        if self._real is None:
            self._real = _BudgetTracker(self.cluster, self.now)
        return self._real

    def left(self, pool_name: str, rclass: str) -> int:
        return self._tracker().left(pool_name, rclass)

    def consume(self, pool_name: str, rclass: str) -> bool:
        return self._tracker().consume(pool_name, rclass)


class _DirtyScan:
    """Change-journal-driven working state for the disruption controller.

    The pattern-setter pair (liveness/registration ``_watched_claims``)
    made per-claim condition walks O(dirty); this extends it to every
    disruption phase: claim/node membership (``cn``), the per-node pod view
    + do-not-disrupt flags, an expiration deadline heap, a drift-pending
    claim set, the empty-node set, and the consolidation quiet-pass memo.
    A quiet pass then costs a journal rev check plus a few heap peeks
    instead of an O(claims) + O(pods) walk.

    Rebuild triggers (never a correctness loss, exactly like the encoders):
    store epoch change, journal overflow, NODE defensive-scan misses are
    handled per-node, ownership (lease) set change, kill switch, and the
    periodic resweep that bounds in-place-mutation staleness."""

    def __init__(self):
        self.cursor = None            # (epoch object, rev)
        self.node_seq = -1            # NODE_WRITE_SEQ snapshot
        self.node_vers: dict[str, int] = {}
        self.by_node: dict[str, list] = {}
        self.dnd_node: dict[str, bool] = {}
        self.cn: dict[str, tuple] = {}       # claim name -> (claim, node)
        self.node_claim: dict[str, str] = {}  # node name -> claim name
        self.expiry: list = []               # heap [(deadline, claim name)]
        self.expiry_at: dict[str, float] = {}  # current deadline per claim
        self.drift_pending: set[str] = set()
        self.drift_all = True
        self.empty: set[str] = set()
        self.last_rebuild = float("-inf")
        self.owned = None              # frozenset of owned keys, or None
        # pool/nodeclass spec tracking: SPEC_WRITE_SEQ is the cheap trigger
        # (any direct field reassignment), the content fingerprint decides
        # whether anything drift/deadline-relevant actually moved — the
        # nodeclass-status controller reassigns its discovery lists every
        # pass with (usually) identical content
        self.spec_seq = -1
        self.spec_fp = None
        # consolidation quiet-pass memo: identical-ct passes with no time-
        # gated candidate, no commit, and no budget rejection are provably
        # identical — skip them outright
        self.consol_ct = None
        self.consol_idle = False
        self.consol_next = float("inf")


class DisruptionController:
    name = "disruption"
    interval_s = 10.0

    def __init__(
        self,
        cluster: Cluster,
        cloudprovider: CloudProvider,
        clock: Optional[Clock] = None,
        drift_enabled: bool = True,
        provisioning=None,
        recorder=None,
        spot_to_spot: bool = False,
        validation_period_s: float = 15.0,
        obs=None,
        device=None,
    ):
        from ..events import default_recorder

        self.obs = obs
        # where the consolidation screen runs: None means CUDA
        self.device = device
        # the last pass's wall split (ms) and its candidate counts
        self.timings: dict = {}
        self.cluster = cluster
        self.cloudprovider = cloudprovider
        self.clock = clock or RealClock()
        self.drift_enabled = drift_enabled
        # core SpotToSpotConsolidation feature gate (default off upstream)
        self.spot_to_spot = spot_to_spot
        # consolidation validation window (core: candidates are re-validated
        # after a wait before committing, so a transient dip — a pod between
        # restarts, a scale-down about to scale back — doesn't kill a node).
        # A candidate must stay consolidatable for this long before any
        # delete/replace commits. 0 = commit on first sight (tests).
        self.validation_period_s = validation_period_s
        self._consol_seen: dict[str, float] = {}
        self.provisioning = provisioning
        self.recorder = recorder or default_recorder()
        self.disrupted: list[tuple[str, str]] = []  # (claim name, reason) log
        # budget-reject audit dedupe: (claim, reason class) -> last record
        # time. An exhausted budget re-rejects the same candidates every
        # pass; without this the identical reject records would cycle the
        # bounded audit ring and evict the history it exists to retain.
        self._reject_logged: dict[tuple, float] = {}
        # Warm-pass scan cache: the O(pods) per-pass views (pods_by_node,
        # per-node do-not-disrupt flags, the (claim, node) working set) are
        # pure functions of store content, keyed on (epoch, rev, node/pod
        # write sequences) — a quiet reconcile reuses them outright. An
        # annotation stamped IN PLACE between passes is invisible to the
        # key, so ``_disrupt``'s commit-time recheck covers claim/node/pod
        # do-not-disrupt before anything commits (the single enforcement
        # point, same contract as the provisioner's live pod recheck).
        self._scan_cache: Optional[tuple] = None
        # journal-fed dirty-set walk state (KARPENTER_TPU_DISRUPTION_DIRTY=0
        # reverts to the full-walk path above; the property test pins the
        # two paths to identical decisions)
        self._ds: Optional[_DirtyScan] = None
        # per-row consolidation-eligibility cache riding the incremental
        # encoder's patch chain (the 50k sim-sweep cliff: the all-rows
        # python eligible() walk re-ran on every churned emission). Rows
        # refresh when their tensor row patches; staleness is bounded by
        # the same triggers as the encoders (journal-driven patches, the
        # defensive node-version scan, spec fingerprint, resweep) and the
        # per-candidate live eligible() recheck stays authoritative before
        # anything commits.
        self._elig: Optional[dict] = None

    # -- budget accounting -------------------------------------------------
    # reason-string prefix -> core DisruptionReason class (budget scoping)
    _REASON_CLASS = {
        "expired": "Expired",
        "drifted": "Drifted",
        "empty": "Empty",
        "consolidatable": "Underutilized",
    }

    def _budget_left(self) -> "_BudgetTracker":
        return _BudgetTracker(self.cluster, self.clock.now())

    def _audit(self):
        if self.obs is None:
            from ..obs import default_obs

            self.obs = default_obs()
        return self.obs.audit

    REJECT_AUDIT_TTL_S = 300.0  # one reject record per (claim, reason) per window

    def _disrupt(self, claim, reason: str, budget: "_BudgetTracker",
                 detail: dict = None) -> bool:
        # Commit-time live recheck: the candidate walks read claim/node/pod
        # do-not-disrupt from per-pass (now revision-cached) snapshots, but
        # an annotation stamped in place SINCE (a mutation the change
        # journal cannot see) must still protect the node at the single
        # point where a disruption actually commits — for every reason,
        # not just consolidation, and on every object level.
        if getattr(claim, "annotations", {}).get(
            lbl.ANNOTATION_DO_NOT_DISRUPT
        ) == "true":
            return False
        node_name = getattr(getattr(claim, "status", None), "node_name", "")
        node = self.cluster.nodes.get(node_name) if node_name else None
        if node is not None and (
            node.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT) == "true"
        ):
            return False
        if node_name and any(
            (p.do_not_disrupt() or p.gang_locked())
            for p in self.cluster.pods_on_nodes([node_name]).get(node_name, ())
        ):
            return False
        rclass = self._REASON_CLASS.get(reason.split(":")[0], "")
        audit = self._audit()
        if not budget.consume(claim.nodepool_name, rclass):
            # a candidate the budget turned down is itself a decision the
            # audit plane must retain — "why was this node NOT disrupted" —
            # but TTL-deduped: an exhausted budget re-rejects every pass
            now = self.clock.now()
            key = (claim.name, reason.split(":")[0])
            last = self._reject_logged.get(key)
            if last is None or now - last >= self.REJECT_AUDIT_TTL_S:
                self._reject_logged[key] = now
                if len(self._reject_logged) > 4096:  # bounded: drop expired
                    cutoff = now - self.REJECT_AUDIT_TTL_S
                    self._reject_logged = {
                        k: t for k, t in self._reject_logged.items()
                        if t >= cutoff
                    }
                reject_detail = dict(detail or {}, reason=reason,
                                     nodepool=claim.nodepool_name)
                audit.record(
                    "disruption", "NodeClaim", claim.name, "reject:budget",
                    reject_detail,
                    at=now, rev=getattr(self.cluster, "rev", None),
                )
            return False
        from ..metrics import DISRUPTION_ACTIONS

        DISRUPTION_ACTIONS.inc(reason=reason.split(":")[0])
        self.disrupted.append((claim.name, reason))
        log.info("disrupting %s: %s", claim.name, reason)
        self.recorder.publish("NodeClaim", claim.name, "Disrupted", reason)
        audit.record(
            "disruption", "NodeClaim", claim.name, f"accept:{reason}",
            dict(detail or {}, nodepool=claim.nodepool_name),
            at=self.clock.now(), rev=getattr(self.cluster, "rev", None),
        )
        # flight recorder: the claim's timeline shows WHY its pods'
        # chains grow evict hops a moment later (trace/correlate.py)
        ledger = getattr(self.obs, "ledger", None)
        if ledger is not None:
            try:
                ledger.record(
                    ledger.mint("NodeClaim", claim.name), "disrupt",
                    subject_kind="NodeClaim", subject=claim.name,
                    at=self.clock.now(), detail={"reason": reason},
                )
            except Exception:
                pass
        self.cluster.delete(claim)  # termination controller drains + reaps
        return True

    # -- reconcile ---------------------------------------------------------
    def reconcile(self) -> None:
        self.timings = {}
        t0 = time.perf_counter()
        if _dirty_enabled():
            self._reconcile_dirty()
        else:
            self._ds = None
            self._reconcile_full()
        self._lap("wall_ms", t0)

    def _lap(self, key: str, t0: float) -> float:
        """Add the ms since ``t0`` to ``timings[key]``; returns the clock."""
        t = time.perf_counter()
        self.timings[key] = self.timings.get(key, 0.0) + (t - t0) * 1e3
        return t

    # -- dirty-set reconcile (the steady-state path) -----------------------
    def _reconcile_dirty(self) -> None:
        from ..operator import sharding

        cluster = self.cluster
        now = self.clock.now()
        t0 = time.perf_counter()
        epoch = getattr(cluster, "epoch", None)
        if epoch is None or getattr(cluster, "rev", None) is None:
            self._reconcile_full()  # foreign store: no journal to ride
            return
        own = sharding.current()
        owned = frozenset(own.keys) if own is not None else None
        ds = self._ds
        changes = None
        # rev captured BEFORE the journal read (same discipline as every
        # other journal consumer): a concurrent write landing between the
        # two would otherwise advance the cursor past an unprocessed entry
        rev0 = cluster.rev
        if (
            ds is not None
            and ds.cursor is not None
            and ds.cursor[0] is epoch
            and ds.owned == owned
            and now - ds.last_rebuild < _resweep_s()
        ):
            changes = cluster.changes_since(ds.cursor[1])
        if changes is None:  # first pass / overflow / rebalance / resweep
            ds = self._ds = self._rebuild_scan(now, owned)
        elif changes:
            self._apply_changes(ds, changes, now)
            ds.cursor = (epoch, rev0)
        else:
            ds.cursor = (epoch, rev0)
            self._apply_changes(ds, {}, now)  # defensive node-version scan
        t0 = self._lap("scan_ms", t0)
        budget = _LazyBudget(cluster, now)
        self._expiration_dirty(ds, budget, now)
        if self.drift_enabled:
            self._drift_dirty(ds, budget)
        self._emptiness_dirty(ds, budget, now)
        self._lap("phases_ms", t0)
        self._consolidation_dirty(ds, budget, now)

    def _rebuild_scan(self, now: float, owned) -> _DirtyScan:
        from ..state.cluster import NODE_WRITE_SEQ

        cluster = self.cluster
        ds = _DirtyScan()
        ds.owned = owned
        ds.last_rebuild = now
        rev0 = cluster.rev
        seq0 = NODE_WRITE_SEQ.v  # BEFORE the version reads: over-invalidate
        ds.by_node = cluster.pods_by_node()
        ds.dnd_node = {
            name: any((p.do_not_disrupt() or p.gang_locked()) for p in pods)
            for name, pods in ds.by_node.items()
        }
        ds.node_vers = {
            n.name: n._version for n in cluster.snapshot_nodes()
        }
        ds.node_seq = seq0
        from ..models.nodeclass import SPEC_WRITE_SEQ

        ds.spec_seq = SPEC_WRITE_SEQ.v
        ds.spec_fp = self._spec_fingerprint()
        for claim in cluster.snapshot_claims():
            self._scan_claim(ds, claim.name, mark_drift=True)
        ds.drift_all = True
        ds.cursor = (cluster.epoch, rev0)
        return ds

    def _spec_fingerprint(self) -> tuple:
        """Content identity of everything the drift sweep and the
        expiration deadlines read off pools and nodeclasses: template
        hashes, disruption policy knobs, and the discovery sets (image /
        subnet / security-group ids) the status controller refreshes in
        place each pass. Computed only when SPEC_WRITE_SEQ moved."""
        cluster = self.cluster
        pools = tuple(sorted(
            (
                name, p.hash(),
                p.disruption.consolidation_policy,
                p.disruption.consolidate_after_s,
                p.disruption.expire_after_s,
                tuple(str(b) for b in p.disruption.budgets),
            )
            # list() snapshots the live dict (concurrent apply() threads)
            for name, p in list(cluster.nodepools.items())
        ))
        ncs = tuple(sorted(
            (
                name, nc.hash(),
                tuple(getattr(i, "id", str(i)) for i in nc.status.images),
                tuple(getattr(s, "id", str(s)) for s in nc.status.subnets),
                tuple(
                    getattr(s, "id", str(s))
                    for s in nc.status.security_groups
                ),
                nc.status.instance_profile,
            )
            for name, nc in list(cluster.nodeclasses.items())
        ))
        return (pools, ncs)

    def _scan_claim(self, ds: _DirtyScan, name: str,
                    mark_drift: bool = False) -> None:
        """Re-evaluate one claim's working-set membership (the exact
        predicate of ``_claims_with_nodes``, minus the per-pass lease
        ownership filter — leases move without store mutations, so
        ownership is checked at decision time) and refresh the derived
        structures: expiration deadline, drift-pending mark, empty-node
        tracking."""
        cluster = self.cluster
        claim = cluster.nodeclaims.get(name)
        node = None
        member = False
        if claim is not None and not claim.deleted and claim.is_registered():
            node = cluster.nodes.get(claim.status.node_name)
            if node is not None and not node.cordoned:
                if (
                    claim.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT)
                    != "true"
                    and node.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT)
                    != "true"
                    and not ds.dnd_node.get(node.name, False)
                ):
                    member = True
        prev = ds.cn.get(name)
        if prev is not None:
            pnode = prev[1]
            if pnode is not None and (not member or pnode is not node) and (
                ds.node_claim.get(pnode.name) == name
            ):
                ds.node_claim.pop(pnode.name, None)
                ds.empty.discard(pnode.name)
        if member:
            ds.cn[name] = (claim, node)
            ds.node_claim[node.name] = name
            if ds.by_node.get(node.name):
                ds.empty.discard(node.name)
            else:
                ds.empty.add(node.name)
            pool = cluster.nodepools.get(claim.nodepool_name)
            ea = pool.disruption.expire_after_s if pool is not None else None
            if ea is not None:
                dl = claim.created_at + ea
                if ds.expiry_at.get(name) != dl:
                    ds.expiry_at[name] = dl
                    heapq.heappush(ds.expiry, (dl, name))
            else:
                ds.expiry_at.pop(name, None)
            if mark_drift or prev is None:
                ds.drift_pending.add(name)
        else:
            ds.cn.pop(name, None)
            ds.expiry_at.pop(name, None)
            ds.drift_pending.discard(name)

    def _apply_changes(self, ds: _DirtyScan, changes: dict,
                       now: float) -> None:
        from ..state.cluster import NODE_WRITE_SEQ

        cluster = self.cluster
        dirty_nodes: dict[str, None] = {}
        for n in changes.get("node", ()):
            if n:
                dirty_nodes[n] = None
        for n in changes.get("pod", ()):
            if n:
                dirty_nodes[n] = None
        # defensive version scan: direct node attribute writes (cordon
        # flips, label rewrites) bump NODE_WRITE_SEQ but journal nothing —
        # compare per-node versions only on passes where SOME node field
        # was written anywhere (same contract as the encoders)
        seq = NODE_WRITE_SEQ.v
        if seq != ds.node_seq:
            nodes = cluster.nodes
            for name, ver in list(ds.node_vers.items()):
                nd = nodes.get(name)
                if nd is None or nd._version != ver:
                    dirty_nodes[name] = None
            # list() snapshots the live dict in one C-level pass — other
            # controller threads apply() concurrently and a python-level
            # walk over the live dict can see a resize mid-iteration
            for name in list(nodes):
                if name not in ds.node_vers:
                    dirty_nodes[name] = None
            ds.node_seq = seq
        dirty_claims: dict[str, None] = dict.fromkeys(
            n for n in changes.get("claim", ()) if n
        )
        if dirty_nodes:
            pods_for = cluster.pods_on_nodes(list(dirty_nodes))
            nodes = cluster.nodes
            for name in dirty_nodes:
                node = nodes.get(name)
                cname = ds.node_claim.get(name)
                if node is None:
                    ds.node_vers.pop(name, None)
                    ds.by_node.pop(name, None)
                    ds.dnd_node.pop(name, None)
                    ds.empty.discard(name)
                    if cname:
                        ds.node_claim.pop(name, None)
                        dirty_claims[cname] = None
                    continue
                ds.node_vers[name] = node._version
                pods = pods_for.get(name, [])
                if pods:
                    ds.by_node[name] = pods
                else:
                    ds.by_node.pop(name, None)
                ds.dnd_node[name] = any((p.do_not_disrupt() or p.gang_locked()) for p in pods)
                if node.nodeclaim_name:
                    dirty_claims[node.nodeclaim_name] = None
                if cname and cname != node.nodeclaim_name:
                    dirty_claims[cname] = None
        for cname in dirty_claims:
            self._scan_claim(ds, cname, mark_drift=cname in set(
                changes.get("claim", ())
            ))
        specs_changed = bool(changes.get("pool") or changes.get("nodeclass"))
        from ..models.nodeclass import SPEC_WRITE_SEQ

        if SPEC_WRITE_SEQ.v != ds.spec_seq:
            # direct in-place spec edits never reach the journal; the
            # fingerprint filters out the no-op churn (status controllers
            # reassign identical discovery lists every pass)
            ds.spec_seq = SPEC_WRITE_SEQ.v
            fp = self._spec_fingerprint()
            if fp != ds.spec_fp:
                ds.spec_fp = fp
                specs_changed = True
        if specs_changed:
            # pool/nodeclass spec changes move every claim's expiration
            # deadline and drift hash — rescan the membership set, and
            # invalidate the consolidation memo (budgets/policy changed)
            for cname in list(ds.cn):
                self._scan_claim(ds, cname, mark_drift=True)
            ds.drift_all = True
            ds.consol_ct = None

    def _claim_store_order(self, names):
        """Decision-order contract: every dirty phase visits its candidates
        in claim CREATION (store insertion) order — exactly the order the
        full O(claims) walk iterates — so a budget-capped pass picks the
        IDENTICAL victim set on both paths (the satellite property test's
        equality is set+order, not just set). The O(claims) position map is
        built only when candidates exist; a quiet pass never reaches here."""
        seq = list(names)
        if len(seq) <= 1:
            return seq
        # list() snapshots the live claims dict atomically (C-level);
        # other controller threads apply() new claims concurrently
        pos = {n: i for i, n in enumerate(list(self.cluster.nodeclaims))}
        seq.sort(key=lambda n: pos.get(n, len(pos)))
        return seq

    def _expiration_dirty(self, ds: _DirtyScan, budget, now: float) -> None:
        from ..operator import sharding

        cluster = self.cluster
        due: list[tuple[float, str]] = []
        while ds.expiry and ds.expiry[0][0] <= now:
            due.append(heapq.heappop(ds.expiry))
        if len(due) > 1:  # heap order is deadline order; commit in the
            # full walk's (store) order. Drop superseded entries BEFORE
            # collapsing per name: a claim with two due entries (deadline
            # moved earlier while an old entry was still queued) must keep
            # its LIVE deadline — the naive dict overwrite kept whichever
            # popped last and silently consumed the live entry.
            dl_at = {
                name: dl for dl, name in due
                if ds.expiry_at.get(name) == dl
            }
            due = [
                (dl_at[n], n)
                for n in self._claim_store_order(dl_at)
            ]
        repush: list[tuple[float, str]] = []
        for dl, name in due:
            if ds.expiry_at.get(name) != dl:
                continue  # superseded entry (lazy heap deletion)
            ent = ds.cn.get(name)
            if ent is None:
                ds.expiry_at.pop(name, None)
                continue
            claim, node = ent
            if claim.deleted:
                ds.expiry_at.pop(name, None)
                continue
            pool = cluster.nodepools.get(claim.nodepool_name)
            ea = pool.disruption.expire_after_s if pool is not None else None
            if ea is None:
                ds.expiry_at.pop(name, None)
                continue
            real_dl = claim.created_at + ea
            if real_dl > now:  # deadline moved out from under the entry
                ds.expiry_at[name] = real_dl
                repush.append((real_dl, name))
                continue
            if node is not None and not sharding.owns_node(cluster, node):
                # foreign partition — the lease may move here later
                ds.expiry_at[name] = now
                repush.append((now, name))
                continue
            if self._disrupt(claim, "expired", budget):
                ds.expiry_at.pop(name, None)
            else:  # budget-blocked (or freshly dnd-stamped): retry next pass
                ds.expiry_at[name] = now
                repush.append((now, name))
        for item in repush:
            heapq.heappush(ds.expiry, item)

    def _drift_dirty(self, ds: _DirtyScan, budget) -> None:
        from ..operator import sharding

        cluster = self.cluster
        if ds.drift_all:
            ds.drift_pending = set(ds.cn)
            ds.drift_all = False
        if not ds.drift_pending:
            return
        instances = None
        try:
            instances = {
                i.id: i for i in self.cloudprovider.list_instances()
            }
        except Exception:
            pass  # per-claim get() fallback keeps the sweep alive
        discovery_cache: dict = {}
        for name in self._claim_store_order(ds.drift_pending):
            ent = ds.cn.get(name)
            if ent is None:
                ds.drift_pending.discard(name)
                continue
            claim, node = ent
            if claim.deleted:
                ds.drift_pending.discard(name)
                continue
            if node is not None and not sharding.owns_node(cluster, node):
                continue  # stays pending until this replica owns it
            reason = self.cloudprovider.is_drifted(
                claim, instances=instances, discovery_cache=discovery_cache
            )
            if reason == DriftReason.NONE:
                ds.drift_pending.discard(name)
            elif self._disrupt(claim, f"drifted:{reason.value}", budget):
                ds.drift_pending.discard(name)
            # else: budget-blocked — retry next pass

    def _emptiness_dirty(self, ds: _DirtyScan, budget, now: float) -> None:
        from ..operator import sharding

        cluster = self.cluster
        # visit empty nodes by their CLAIM's store position (see
        # _claim_store_order) — the full walk checks emptiness per claim
        # in creation order, and budget caps make the order part of the
        # decision contract
        claim_of = {
            n: ds.node_claim.get(n) for n in ds.empty
        }
        ordered = self._claim_store_order(
            c for c in claim_of.values() if c
        )
        node_of = {c: n for n, c in claim_of.items()}
        for node_name in [node_of[c] for c in ordered] + [
            n for n, c in claim_of.items() if not c
        ]:
            cname = ds.node_claim.get(node_name)
            ent = ds.cn.get(cname) if cname else None
            if ent is None:
                ds.empty.discard(node_name)
                continue
            claim, node = ent
            if claim.deleted or node is None:
                continue
            if ds.by_node.get(node_name):
                ds.empty.discard(node_name)
                continue
            pool = cluster.nodepools.get(claim.nodepool_name)
            if pool is None:
                continue
            after = pool.disruption.consolidate_after_s
            if after is None:
                continue
            if not sharding.owns_node(cluster, node):
                continue
            # quiet window from the last pod removal, not node age
            if now - max(node.created_at, node.last_pod_event) < after:
                continue
            self._disrupt(claim, "empty", budget)

    def _consolidation_dirty(self, ds: _DirtyScan, budget,
                             now: float) -> None:
        pools = self.cluster.nodepools
        if not any(
            p.disruption.consolidation_policy == "WhenUnderutilized"
            and p.disruption.consolidate_after_s is not None
            for p in pools.values()
        ):
            self._consol_seen.clear()
            ds.consol_ct = None
            return
        t0 = time.perf_counter()
        ct = encode_cluster(self.cluster, self.cloudprovider.catalog,
                            pods_by_node=ds.by_node, rev_floor=ds.cursor[1])
        self._lap("encode_ms", t0)
        if ct is None:
            self._consol_seen.clear()
            ds.consol_ct = None
            return
        # Quiet-pass skip: the incremental encoder re-emits the IDENTICAL
        # object when nothing moved, and the previous evaluation on that
        # object committed nothing, hit no budget cap, attempted no launch,
        # and left no candidate waiting on a time window — re-running it
        # now is provably the same walk with the same answer. Bounded by
        # the resweep rebuild (time-varying cloud state: reservations, ICE
        # expiry) and invalidated by any pool/nodeclass change.
        if ct is ds.consol_ct and ds.consol_idle and now < ds.consol_next:
            return
        idle, next_dl = self._reconcile_consolidation(
            budget, pods_by_node=ds.by_node, rev0=ds.cursor[1],
            dnd_node=ds.dnd_node, ct=ct,
        )
        ds.consol_ct = ct
        ds.consol_idle = idle
        ds.consol_next = next_dl

    # -- full-walk reconcile (kill switch / foreign stores) ----------------
    def _reconcile_full(self) -> None:
        budget = self._budget_left()
        # one bulk pod view per pass (four methods consume it; the
        # consolidation encode patches from it too). The revision is
        # captured FIRST so the incremental encoder re-patches anything
        # that mutates between this snapshot and the encode.
        rev0 = getattr(self.cluster, "rev", None)
        # per-node do-not-disrupt flag + the (claim, node) working set, each
        # computed ONCE per pass — and, since the views are pure functions
        # of store content, reused ACROSS passes while the store is quiet:
        # the 3x O(pods) annotation walks were the host-side floor of the
        # warm 5k-node pass (the <50ms controller-pass budget). Direct
        # in-place annotation stamps are invisible to the key; _disrupt's
        # commit recheck enforces them (see _scan_cache).
        from ..models.pod import POD_WRITE_SEQ
        from ..operator import sharding
        from ..state.cluster import NODE_WRITE_SEQ

        own = sharding.current()
        ckey = (
            getattr(self.cluster, "epoch", None), rev0,
            NODE_WRITE_SEQ.v, POD_WRITE_SEQ.v,
            # sharded: the working set is ownership-filtered, and leases
            # can move between passes with no store mutation — the cache
            # key carries the owned-key set so a rebalance invalidates it
            frozenset(own.keys) if own is not None else None,
        )
        cached = self._scan_cache
        if cached is not None and cached[0] == ckey:
            _, by_node, dnd_node, cn = cached
        else:
            by_node = self.cluster.pods_by_node()
            dnd_node = {
                name: any((p.do_not_disrupt() or p.gang_locked()) for p in pods)
                for name, pods in by_node.items()
            }
            cn = list(self._claims_with_nodes(by_node, dnd_node))
            self._scan_cache = (ckey, by_node, dnd_node, cn)
        self._reconcile_expiration(budget, by_node, cn)
        if self.drift_enabled:
            self._reconcile_drift(budget, by_node, cn)
        self._reconcile_emptiness(budget, by_node, cn)
        self._reconcile_consolidation(budget, by_node, rev0, dnd_node)

    def _claims_with_nodes(self, pods_by_node=None, dnd_node=None):
        from ..operator import sharding

        if pods_by_node is None:
            pods_by_node = self.cluster.pods_by_node()
        for claim in self.cluster.snapshot_claims():
            if claim.deleted or not claim.is_registered():
                continue
            node = self.cluster.nodes.get(claim.status.node_name)
            if node is None or node.cordoned:
                continue
            if not sharding.owns_node(self.cluster, node):
                continue  # sharded: another replica disrupts this partition
            # karpenter.sh/do-not-disrupt blocks EVERY voluntary disruption
            # (expiration/drift/emptiness/consolidation): on the claim, the
            # node, or any pod still running there
            if (
                claim.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT) == "true"
                or node.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT) == "true"
                or (
                    dnd_node.get(node.name, False)
                    if dnd_node is not None
                    else any(
                        (p.do_not_disrupt() or p.gang_locked())
                        for p in pods_by_node.get(node.name, ())
                    )
                )
            ):
                continue
            yield claim, node

    def _reconcile_expiration(self, budget, pods_by_node=None,
                              claims_nodes=None) -> None:
        now = self.clock.now()
        if claims_nodes is None:
            claims_nodes = self._claims_with_nodes(pods_by_node)
        for claim, node in claims_nodes:
            if claim.deleted:  # a shared working set spans phases now: an
                continue       # earlier phase may have disrupted this claim
            pool = self.cluster.nodepools.get(claim.nodepool_name)
            if pool is None or pool.disruption.expire_after_s is None:
                continue
            if now - claim.created_at >= pool.disruption.expire_after_s:
                self._disrupt(claim, "expired", budget)

    def _reconcile_drift(self, budget, pods_by_node=None,
                         claims_nodes=None) -> None:
        if claims_nodes is None:
            claims_nodes = self._claims_with_nodes(pods_by_node)
        # one bulk instance listing instead of a locked per-claim cloud
        # get(): the drift sweep is O(claims) either way, but 5k lock
        # round trips were ~1/5 of the warm controller pass
        instances = None
        try:
            instances = {
                i.id: i for i in self.cloudprovider.list_instances()
            }
        except Exception:
            pass  # per-claim get() fallback keeps the sweep alive
        discovery_cache: dict = {}  # per-sweep nodeclass discovery memo
        for claim, node in claims_nodes:
            if claim.deleted:
                continue
            reason = self.cloudprovider.is_drifted(
                claim, instances=instances, discovery_cache=discovery_cache
            )
            if reason != DriftReason.NONE:
                self._disrupt(claim, f"drifted:{reason.value}", budget)

    def _reconcile_emptiness(self, budget, pods_by_node=None,
                             claims_nodes=None) -> None:
        now = self.clock.now()
        if pods_by_node is None:
            pods_by_node = self.cluster.pods_by_node()
        if claims_nodes is None:
            claims_nodes = self._claims_with_nodes(pods_by_node)
        for claim, node in claims_nodes:
            if claim.deleted:
                continue
            pool = self.cluster.nodepools.get(claim.nodepool_name)
            if pool is None:
                continue
            after = pool.disruption.consolidate_after_s
            if after is None:
                continue
            if pods_by_node.get(node.name):
                continue
            # quiet window from the last pod removal, not node age — a node
            # that just emptied gets the full consolidateAfter grace
            if now - max(node.created_at, node.last_pod_event) < after:
                continue
            self._disrupt(claim, "empty", budget)

    def _elig_refresh_rows(self, es: dict, ct, rows,
                           dnd_node, pods_by_node) -> None:
        """Recompute the static consolidation-eligibility flag and quiet-
        window deadline for the given tensor rows (everything ``eligible``
        checks except wall time, ownership, and ``ct.blocked``)."""
        cluster = self.cluster
        pools = cluster.nodepools
        nodes = cluster.nodes
        claims = cluster.nodeclaims
        names = ct.node_names
        ok = es["ok"]
        window_at = es["window_at"]
        inf = float("inf")
        for ni in rows:
            ni = int(ni)
            good = False
            wat = inf
            node = nodes.get(names[ni])
            if node is not None and (
                dnd_node.get(node.name, False)
                if dnd_node is not None
                else any(
                    (p.do_not_disrupt() or p.gang_locked()) for p in pods_by_node.get(node.name, ())
                )
            ):
                node = None
            if node is not None:
                pool = pools.get(node.nodepool_name)
                claim = claims.get(node.nodeclaim_name)
                after = pool.disruption.consolidate_after_s if pool else None
                if (
                    pool is not None
                    and pool.disruption.consolidation_policy
                    == "WhenUnderutilized"
                    and after is not None
                    and claim is not None
                    and not claim.deleted
                    and claim.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT)
                    != "true"
                    and node.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT)
                    != "true"
                ):
                    good = True
                    wat = max(node.created_at, node.last_pod_event) + after
            ok[ni] = good
            window_at[ni] = wat

    def _elig_candidates(self, ct, now: float, dnd_node, pods_by_node,
                         deadlines: list, owned_token) -> np.ndarray:
        """Candidate tensor rows for the consolidation walk, O(patched
        rows) per churned emission: per-row static eligibility + quiet-
        window deadlines are cached and refreshed along the incremental
        encoder's ``_patch_base``/``_patch_positions`` chain (the same
        walk the device mirror scatters by). Full rebuilds on axis/chain
        breaks, spec-fingerprint changes, ownership (lease) moves, and
        the periodic resweep — the identical staleness contract as the
        dirty scan; the caller's live ``eligible()`` recheck stays
        authoritative for every returned row."""
        from ..models.nodeclass import SPEC_WRITE_SEQ
        from ..ops.device_state import _collect_patch_positions

        N = len(ct.node_names)
        es = self._elig
        rows = None
        if (
            es is not None
            and len(es["ok"]) == N
            and es["owned"] == owned_token
            and now - es["built_at"] < _resweep_s()
        ):
            if es["spec_seq"] != SPEC_WRITE_SEQ.v:
                fp = self._spec_fingerprint()
                if fp != es["spec_fp"]:
                    es = None
                else:
                    es["spec_seq"] = SPEC_WRITE_SEQ.v
            if es is not None:
                rows = (
                    () if es["ct"] is ct
                    else _collect_patch_positions(ct, es["ct"])
                )
                if rows is None:
                    es = None
        else:
            es = None
        if es is None:
            es = self._elig = {
                "ct": ct,
                "ok": np.zeros(N, dtype=bool),
                "window_at": np.full(N, float("inf")),
                "owned": owned_token,
                "built_at": now,
                "spec_seq": SPEC_WRITE_SEQ.v,
                "spec_fp": self._spec_fingerprint(),
            }
            rows = range(N)
        if len(rows):
            self._elig_refresh_rows(es, ct, rows, dnd_node, pods_by_node)
        es["ct"] = ct
        cand = es["ok"] & ~ct.blocked
        timed = es["window_at"] <= now
        pend = es["window_at"][cand & ~timed]
        if pend.size:  # admitted by everything but time: the pass's
            deadlines.append(float(pend.min()))  # answer flips then
        return np.nonzero(cand & timed)[0]

    def _reconcile_consolidation(self, budget, pods_by_node=None,
                                 rev0=None, dnd_node=None,
                                 ct=None) -> tuple[bool, float]:
        """Returns ``(idle, next_deadline)`` for the dirty-path quiet-pass
        memo: ``idle`` when the pass committed nothing, hit no budget cap,
        and attempted no launch (i.e. with an identical ct the re-run is
        provably the same walk); ``next_deadline`` is the earliest time a
        consolidate-after or validation window admits a new candidate."""
        pools = self.cluster.nodepools
        deadlines: list[float] = []
        # Skip the whole encode + device screen when no pool can consolidate.
        if not any(
            p.disruption.consolidation_policy == "WhenUnderutilized"
            and p.disruption.consolidate_after_s is not None
            for p in pools.values()
        ):
            # no candidates exist: validation first-seen times must not
            # survive (a node returning as a candidate hours later would
            # otherwise bypass the window)
            self._consol_seen.clear()
            return True, float("inf")
        # one encode per pass, incrementally patched across passes; the
        # pass's shared pod view rides along so the encoder never re-lists
        if ct is None:
            t0 = time.perf_counter()
            ct = encode_cluster(self.cluster, self.cloudprovider.catalog,
                                pods_by_node=pods_by_node, rev_floor=rev0)
            self._lap("encode_ms", t0)
        if ct is None:
            self._consol_seen.clear()
            return True, float("inf")
        # any commit / budget refusal / launch attempt makes the pass
        # non-idle: its re-run could answer differently (budget windows
        # reopen, cloud capacity changes), so the quiet-pass memo must not
        # absorb it
        active = False
        nodes = self.cluster.nodes
        now = self.clock.now()
        if pods_by_node is None:
            pods_by_node = self.cluster.pods_by_node()
        _eligible_cache: dict[int, object] = {}

        def eligible(ni: int) -> Optional[object]:
            if ni in _eligible_cache:
                return _eligible_cache[ni]
            result = None
            node = nodes.get(ct.node_names[ni])
            if node is not None:
                from ..operator import sharding

                if not sharding.owns_node(self.cluster, node):
                    node = None  # another replica's partition
            # live pod-level do-not-disrupt recheck: ct.blocked carries it
            # from encode time, but an annotation stamped since (an
            # in-place mutation the change journal cannot see) must still
            # protect the node before anything commits this pass. The
            # per-node flag is precomputed once from this pass's pod view
            # (reconcile()); the generator fallback serves direct callers.
            if node is not None and (
                dnd_node.get(node.name, False)
                if dnd_node is not None
                else any(
                    (p.do_not_disrupt() or p.gang_locked()) for p in pods_by_node.get(node.name, ())
                )
            ):
                node = None
            if node is not None:
                pool = pools.get(node.nodepool_name)
                claim = self.cluster.nodeclaims.get(node.nodeclaim_name)
                after = pool.disruption.consolidate_after_s if pool else None
                if (
                    pool is not None
                    and pool.disruption.consolidation_policy == "WhenUnderutilized"
                    and after is not None
                    and claim is not None
                    and not claim.deleted
                    # claim/node-level do-not-disrupt (pod-level rides in
                    # ct.blocked already)
                    and claim.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT) != "true"
                    and node.annotations.get(lbl.ANNOTATION_DO_NOT_DISRUPT) != "true"
                ):
                    # quiet window measured from the last pod add/remove on
                    # the node, not node age (karpenter consolidateAfter)
                    window_at = max(node.created_at, node.last_pod_event) + after
                    if now >= window_at:
                        result = claim
                    else:
                        # everything but time admits this node: the pass's
                        # answer flips at window_at even with no mutation
                        deadlines.append(window_at)
            _eligible_cache[ni] = result
            return result

        # 1. delete: the device screen checks candidates in parallel, then the
        # multi-node set is chosen as the largest cost-ordered prefix whose
        # pods ALL repack onto the survivors (candidates never serve as
        # targets for each other — the set is removed at once, matching
        # designs/consolidation.md's simulated scheduling).
        # Chained dispatch: the screen's device programs go in flight FIRST
        # (served from the device-resident cluster tensors), then the
        # host-side eligibility/validation walk below runs UNDER the device
        # compute; wait() pays the link once for the tiny mask.
        t0 = time.perf_counter()
        pending_screen = dispatch_screen(ct, device=self.device)
        t0 = self._lap("screen_dispatch_ms", t0)
        from ..operator import sharding as _sharding

        _own = _sharding.current()
        owned_token = frozenset(_own.keys) if _own is not None else None
        # candidate rows from the chain-patched eligibility cache (the
        # 50k sim-sweep cliff fix: O(patched rows) per churned emission
        # instead of an all-rows python walk); the live eligible() call
        # below stays the authoritative per-candidate recheck
        cand_rows = self._elig_candidates(
            ct, now, dnd_node, pods_by_node, deadlines, owned_token,
        )
        if len(cand_rows):
            # cost order with stable ties on ascending row id — exactly
            # the tie order the former full-array stable argsort produced
            cand_rows = cand_rows[
                np.argsort(ct.disruption_cost[cand_rows], kind="stable")
            ]
        # one eligibility evaluation per node; every later phase reads the
        # captured claim map instead of re-calling through the cache
        elig_claim: dict[int, object] = {}
        eligible_all: list[int] = []
        for ni in cand_rows:
            ni = int(ni)
            c = eligible(ni)
            if c is not None:
                eligible_all.append(ni)
                elig_claim[ni] = c
        # Validation window: a candidate commits only after staying
        # consolidatable for validation_period_s (first-seen times pruned
        # when a claim stops being a candidate, so a flapping node restarts
        # its clock).
        current = {elig_claim[ni].name: ni for ni in eligible_all}
        self._consol_seen = {
            name: self._consol_seen.get(name, now) for name in current
        }
        if self.validation_period_s > 0:
            held = []
            for ni in eligible_all:
                seen_at = self._consol_seen[elig_claim[ni].name]
                if now - seen_at >= self.validation_period_s:
                    held.append(ni)
                else:  # validated later with no further mutation needed
                    deadlines.append(seen_at + self.validation_period_s)
            eligible_all = held
        # delete candidates additionally pass the device repack screen;
        # multi-node REPLACE considers every eligible node (a node whose
        # pods don't fit on survivors is exactly the replace case)
        t0 = self._lap("candidates_ms", t0)
        can = pending_screen.wait()
        t0 = self._lap("screen_wait_ms", t0)
        candidates = [ni for ni in eligible_all if can[ni]]
        self.timings.update(eligible=len(eligible_all), screened=len(candidates),
                            feasible_prefix=0)
        deleted_nodes: set[int] = set()
        if candidates:
            lo, hi = 0, len(candidates)
            while lo < hi:  # largest feasible prefix via binary search
                mid = (lo + hi + 1) // 2
                if mid == 0 or repack_set_feasible(ct, candidates[:mid]):
                    lo = mid
                else:
                    hi = mid - 1
            t0 = self._lap("search_ms", t0)
            self.timings["feasible_prefix"] = lo
            rclass = self._REASON_CLASS.get("consolidatable", "")
            now_c = self.clock.now()
            left_by_pool: dict[str, int] = {}
            for ni in candidates[:lo]:
                claim = elig_claim.get(ni)
                if claim is None:
                    continue
                # fast path for the exhausted-budget sweep: when the pool's
                # allowance is gone AND this claim's reject is already
                # audit-logged inside the TTL window, _disrupt would do
                # nothing — skipping the call keeps the warm large-cluster
                # pass from paying thousands of no-op consume/dedup rounds
                # (identical audit/metrics outcome either way)
                pool_left = left_by_pool.get(claim.nodepool_name)
                if pool_left is None:
                    pool_left = left_by_pool[claim.nodepool_name] = (
                        budget.left(claim.nodepool_name, rclass)
                    )
                if pool_left <= 0:
                    active = True  # budget-capped: the window may reopen
                    last = self._reject_logged.get((claim.name, "consolidatable"))
                    if last is not None and (
                        now_c - last < self.REJECT_AUDIT_TTL_S
                    ):
                        continue
                active = True
                if self._disrupt(
                    claim, "consolidatable:delete", budget,
                    detail={"savings_per_hour": round(float(ct.price[ni]), 4)},
                ):
                    deleted_nodes.add(ni)
                    left_by_pool[claim.nodepool_name] = pool_left - 1

        t0 = self._lap("commit_ms", t0)
        next_dl = min(deadlines, default=float("inf"))
        # 2. multi-node replace (N -> 1 cheaper): candidates whose pods
        # repack onto survivors EXCEPT an overflow absorbed by one new,
        # cheaper node (designs/consolidation.md:63-65;
        # deprovisioning_test.go:391-395). Runs only when delete found
        # nothing — a pure delete always beats paying for a replacement.
        if deleted_nodes:
            return False, next_dl
        flags = {"active": False}
        replaced = eligible_all and self._multi_node_replace(ct, eligible_all, budget,
                                                             pools, flags=flags)
        t0 = self._lap("multi_replace_ms", t0)
        if replaced:
            return False, next_dl
        active = active or flags["active"]

        # 3. single-node replace-with-cheaper for survivors.
        validated = set(eligible_all)
        reserved_allow = {
            name: self.cloudprovider.pool_reserved_allowed(pool)
            for name, pool in pools.items()
        }
        for ni, type_name, new_price, offering_options in cheaper_replacement(
            ct, self.cloudprovider.catalog, nodepools=dict(pools),
            reserved_allow=reserved_allow, spot_to_spot=self.spot_to_spot,
            nodeclass_by_pool=self.cluster.nodeclass_by_pool(pools),
            # only validated-eligible rows can be consumed below — the
            # all-rows sweep on a fleet with no eligible node was the
            # other O(N) leg of the 50k sim cliff
            candidates=sorted(validated),
        ):
            if ni in deleted_nodes:
                continue
            claim = elig_claim.get(int(ni))
            if claim is None:
                continue
            if int(ni) not in validated:
                continue  # not yet through the validation window
            if budget.left(claim.nodepool_name, "Underutilized") <= 0:
                active = True  # budget-capped: the window may reopen
                continue
            active = True  # a launch attempt reads live cloud capacity
            replacement = self._launch_replacement(claim, type_name, offering_options)
            if replacement is None:
                continue
            # nominate the evicted pods onto the replacement so the
            # provisioner doesn't double-provision while it registers
            # (parity: core nomination protecting in-flight capacity)
            if self.provisioning is not None:
                node_name = claim.status.node_name
                # bound-pod index, not the full-store scan: this runs per
                # committed replacement, and commit-heavy consolidation
                # passes paid O(pods) per commit
                bound = self.cluster.pods_on_nodes([node_name]).get(node_name, [])
                with self.provisioning._nominations_lock:
                    for pod in bound:
                        self.provisioning.nominations[pod.uid] = replacement.name
            self._disrupt(
                claim, f"consolidatable:replace->{type_name}", budget,
                detail={
                    "old_price": round(float(ct.price[int(ni)]), 4),
                    "new_price": round(float(new_price), 4),
                    "savings_per_hour": round(
                        float(ct.price[int(ni)]) - float(new_price), 4
                    ),
                    "replacement": replacement.name,
                },
            )
        self._lap("replace_ms", t0)
        return not active, next_dl

    MAX_REPLACE_SET = 16  # bound the N of N->1 (stale-snapshot risk grows with N)
    REPLACE_MARGIN = 0.15

    def _eval_replace_set(self, ct, subset, pool_name, pools, ncmap):
        """Score one candidate set for N->1 replace: ``(net_saving, subset,
        rep, overflow, set_price)`` when the set overflows onto a cheaper
        single node, else None. Pure evaluation — the authoritative
        feasibility pair (``repack_set_feasible`` + the margin check inside
        ``replacement_for_groups``) — so the optimizer subset chooser and
        the prefix walk share one enforcement point."""
        from ..ops.consolidate import replacement_for_groups

        free_over = repack_set_feasible(ct, subset, allow_overflow=True)
        _, overflow = free_over
        if not overflow:
            return None  # pure delete set; phase 1 owns those
        set_price = float(sum(ct.price[i] for i in subset))
        rep = replacement_for_groups(
            ct, overflow, self.cloudprovider.catalog, pool_name,
            nodepools=dict(pools), margin=self.REPLACE_MARGIN,
            price_cap=set_price,
            nodeclass_by_pool=ncmap,
            set_has_spot=any(
                ct.node_captype[i] == lbl.CAPACITY_TYPE_SPOT
                for i in subset
            ) if ct.node_captype else False,
            spot_to_spot=self.spot_to_spot,
        )
        if rep is None:
            return None
        return (set_price - float(rep[1]), subset, rep, overflow, set_price)

    def _multi_node_replace(self, ct, candidates, budget, pools,
                            flags: Optional[dict] = None) -> bool:
        """Try replacing a cost-ordered candidate SET with one cheaper node.

        Per pool (the replacement must belong to one pool), pods repack
        onto survivors with the overflow priced onto a single new node;
        accepted when that node costs < (1 - margin) x the set's combined
        price. Launch-before-delete, budget-aware, reserved offerings
        untouched (replacement_for_groups). Returns True when a
        replacement committed (snapshot is then stale — end the pass).

        Chooser: with the optimizer lane enabled (KARPENTER_TPU_OPTIMIZER,
        default on) every cost-ordered prefix PLUS the seeded price-biased
        subset proposals (``ops.consolidate.optimizer_replace_sets``) are
        scored and the largest net $/hr saving commits — the prefix walk
        alone cannot see a replaceable set that skips a blocking middle
        candidate. With the kill switch thrown, the legacy largest-prefix-
        first walk runs byte-identically."""
        from ..ops.consolidate import optimizer_replace_sets
        from ..scheduling.optimizer import count_outcome, optimizer_enabled

        by_pool: dict[str, list[int]] = {}
        for ni in candidates:
            by_pool.setdefault(ct.nodepool_names[ni], []).append(ni)
        ncmap = self.cluster.nodeclass_by_pool(pools)
        for pool_name, cand in by_pool.items():
            top = min(
                len(cand), self.MAX_REPLACE_SET,
                budget.left(pool_name, "Underutilized"),
            )
            if flags is not None and top < min(len(cand), self.MAX_REPLACE_SET):
                flags["active"] = True  # budget-capped: window may reopen
            prefixes = [cand[:m] for m in range(top, 1, -1)]
            if optimizer_enabled():
                # set equality, not tuple order: proposals come back
                # numerically sorted while prefixes keep cost order — a
                # set-equal proposal must dedup (else the expensive eval
                # runs twice and consolidation_adopted over-counts)
                prefix_keys = {frozenset(s) for s in prefixes}
                proposed = [
                    s for s in optimizer_replace_sets(ct, cand[:top])
                    if frozenset(s) not in prefix_keys
                ]
                opt_keys = {frozenset(s) for s in proposed}
                scored = []
                for subset in proposed + prefixes:
                    ev = self._eval_replace_set(ct, subset, pool_name, pools, ncmap)
                    if ev is not None:
                        scored.append(ev)
                # biggest saving first; ties prefer the larger set, then the
                # stable proposal order (deterministic per snapshot)
                scored.sort(key=lambda e: (-e[0], -len(e[1])))
                trials = scored
            else:
                opt_keys = set()
                trials = (
                    ev for subset in prefixes
                    if (ev := self._eval_replace_set(
                        ct, subset, pool_name, pools, ncmap)) is not None
                )
            for _net, subset, rep, overflow, set_price in trials:
                type_name, new_price, offering_options = rep
                claims = [
                    self.cluster.nodeclaims.get(
                        self.cluster.nodes[ct.node_names[i]].nodeclaim_name
                    )
                    for i in subset
                    if ct.node_names[i] in self.cluster.nodes
                ]
                claims = [c for c in claims if c is not None and not c.deleted]
                if len(claims) != len(subset):
                    continue  # snapshot went stale under us
                if flags is not None:
                    flags["active"] = True  # launch reads live cloud capacity
                replacement = self._launch_replacement(
                    claims[0], type_name, offering_options
                )
                if replacement is None:
                    continue
                log.info(
                    "multi-node replace: %d nodes -> 1x %s ($%.4f < $%.4f)",
                    len(subset), type_name, new_price, set_price,
                )
                # Nominate ONLY the overflow pods onto the replacement: the
                # repack proof placed the rest on survivors, and the node was
                # sized for the overflow alone. Survivor-bound pods stay
                # un-nominated so the host binder re-lands them on survivors
                # once the drain releases them. Pods within a group are
                # interchangeable (same scheduling key + labels), so any
                # overflow[g] of the group's pods on the subset will do.
                if self.provisioning is not None:
                    subset_pods = self.cluster.pods_on_nodes(
                        [ct.node_names[i] for i in subset]
                    )
                    on_subset = {
                        p.uid
                        for pods in subset_pods.values()
                        for p in pods
                    }
                    with self.provisioning._nominations_lock:
                        for g, cnt in overflow.items():
                            picked = 0
                            for pod in ct.group_pods[g]:
                                if picked >= cnt:
                                    break
                                if pod.uid in on_subset:
                                    self.provisioning.nominations[pod.uid] = (
                                        replacement.name
                                    )
                                    picked += 1
                multi_detail = {
                    "set_size": len(subset),
                    "set_price": round(set_price, 4),
                    "new_price": round(float(new_price), 4),
                    "savings_per_hour": round(set_price - float(new_price), 4),
                    "replacement": replacement.name,
                }
                for claim in claims:
                    self._disrupt(
                        claim, f"consolidatable:multi-replace->{type_name}",
                        budget, detail=multi_detail,
                    )
                if frozenset(subset) in opt_keys:
                    # the committed set came from the optimizer's subset
                    # search, not the prefix walk — provenance for the
                    # "fragmentation money lives in multi-replace" claim
                    count_outcome("consolidation_adopted")
                return True
        return False

    def _launch_replacement(self, old_claim, type_name: str, offering_options):
        """Launch the cheaper replacement BEFORE disrupting the old node
        (consolidation.md: replacements come up first), through the shared
        launch path so pool labels/taints/constraints are identical to a
        provisioner launch. Returns the new claim, or None on failure.

        Sharded: the replacement write is sanctioned by the OLD node's
        partition lease — that lease authorized disrupting the node, so
        its fencing token rides the launch wherever the new node lands."""
        from ..operator import sharding
        from ..scheduling.solver import NodeSpec
        from .provisioning import launch_claim

        pool = self.cluster.nodepools.get(old_claim.nodepool_name)
        if pool is None:
            return None
        spec = NodeSpec(
            nodepool_name=pool.name,
            instance_type_options=[type_name],
            zone_options=sorted({z for z, _ in offering_options}),
            capacity_type_options=sorted({ct for _, ct in offering_options}),
            offering_options=list(offering_options),
        )
        key = sharding._partition_of_claim(self.cluster, old_claim)
        with sharding.sanction(key):
            return launch_claim(self.cluster, self.cloudprovider, pool, spec,
                                recorder=self.recorder)


class _BudgetTracker:
    """Per-(pool, reason-class) disruption allowance for ONE pass.

    Caps come from the pool's budgets that APPLY to the reason class at pass
    time (reason scoping + cron-window schedules, models/nodepool.py Budget);
    already-draining claims count against every class, as do disruptions
    committed earlier in this pass (a drained node is a drained node,
    whatever the reason)."""

    def __init__(self, cluster, now: float):
        self.cluster = cluster
        self.now = now
        self._used: dict[str, int] = {}
        self._base: dict[tuple[str, str], int] = {}
        # Snapshot totals/draining at PASS START: caps are computed lazily
        # per reason class, and a claim this pass already disrupted (which
        # _used counts) must not also count as "draining" — that would
        # double-subtract and starve later reason classes.
        self._totals: dict[str, int] = {}
        self._draining: dict[str, int] = {}
        for c in cluster.snapshot_claims():
            self._totals[c.nodepool_name] = self._totals.get(c.nodepool_name, 0) + 1
            if c.deleted:
                self._draining[c.nodepool_name] = (
                    self._draining.get(c.nodepool_name, 0) + 1
                )

    def _cap(self, pool_name: str, rclass: str) -> int:
        key = (pool_name, rclass)
        if key not in self._base:
            pool = self.cluster.nodepools.get(pool_name)
            cap = (
                pool.disruption.max_disruptions(
                    self._totals.get(pool_name, 0), rclass, self.now
                )
                if pool is not None
                else 0
            )
            self._base[key] = max(cap - self._draining.get(pool_name, 0), 0)
        return self._base[key]

    def left(self, pool_name: str, rclass: str) -> int:
        return max(self._cap(pool_name, rclass) - self._used.get(pool_name, 0), 0)

    def consume(self, pool_name: str, rclass: str) -> bool:
        if self.left(pool_name, rclass) <= 0:
            return False
        self._used[pool_name] = self._used.get(pool_name, 0) + 1
        return True
