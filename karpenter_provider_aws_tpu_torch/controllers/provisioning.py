"""Provisioning controller: pending pods -> solver -> NodeClaims -> launch.

This owns what the reference consumes from the core provisioner
(SURVEY.md section 3.2): batch pending pods, run the Solve, create
NodeClaims, drive CloudProvider.Create, and handle ICE failures by deleting
the claim so the next pass re-plans against the updated unavailable-
offerings mask (the failure-plane feedback loop of SURVEY.md section 5).

Launches run on a small worker pool so concurrent CloudProvider.Create
calls land in one coalesced fleet batch (parity: createfleet.go windows —
a serial loop would defeat the batcher entirely).

Sharded provisioning (designs/sharded-provisioning.md): under an ambient
ownership scope (N-replica deployments, ``operator/sharding.py``) the
pending set is PARTITIONED instead of GLOBAL-owned. Pods whose required
constraints pin them to an owned (nodepool, zone) partition solve locally
on this replica's device mirror, sanctioned by that partition's lease;
truly global pods flow through the fenced work-stealing GLOBAL queue on
the lease host — the GLOBAL-lease holder claims them in batches, any
other lease holder steals only while the GLOBAL lease has no live holder
(replica loss), and every claim/steal/launch carries the owning lease's
fencing token so a deposed replica's in-flight work bounces off the
cloud instead of double-launching capacity. With no ambient scope
(single-replica, every existing test) nothing changes: one global solve.

This package runs the single-replica path: with no ambient scope the
reconcile is one global solve on the ``TorchSolver`` (on the card unless
the environment asked for the CPU). The reference's degraded-solve audit
(``_audit_degraded``) is gone: no solve here is served by a fallback.
Each solve pass stamps its wall split into ``timings`` (prepare, snapshot,
solve, bind, launch, oracle, in ms, and the rows offered as ``n_pre``), the
provisioning layer's own metrics.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from ..cloudprovider.cloudprovider import CloudProvider
from ..models import labels as lbl
from ..models.nodeclaim import NodeClaim
from ..scheduling.solver import NodeSpec, Solver
from ..state.cluster import Cluster

log = logging.getLogger("karpenter.tpu.provisioning")

MAX_LAUNCH_WORKERS = 10  # parity: reconcile worker-pool width (SURVEY 2.3)

# sharded provisioning: how long one GLOBAL-queue claim stays exclusive
# before an unrenewed claimant (a dead stealer) loses it to re-steal —
# the same shape as the partition-lease TTL
WORK_CLAIM_TTL_S = 15.0


def _provenance_label(prov) -> str:
    """``device/backend`` of a solve's provenance dict (the reference's
    ``ProvenanceRecord.label()`` without its git sha)."""
    if not prov:
        return ""
    return f"{prov.get('device', '')}/{prov.get('backend', '')}"


def _null_ctx():
    import contextlib

    return contextlib.nullcontext()


class ProvisioningController:
    name = "provisioning"
    interval_s = 10.0

    def __init__(self, cluster: Cluster, solver: Solver, cloudprovider: CloudProvider,
                 profiler=None, clock=None, recorder=None, obs=None):
        from ..events import default_recorder
        from ..utils.clock import RealClock
        from ..utils.observability import Profiler

        self.cluster = cluster
        self.solver = solver
        self.cloudprovider = cloudprovider
        self.profiler = profiler or Profiler()
        self.recorder = recorder or default_recorder()
        # obs bundle (audit ring + oracle sampler); None = process default,
        # resolved lazily so hermetic environments always inject their own
        self.obs = obs
        self.clock = clock or getattr(cloudprovider, "clock", None) or RealClock()
        # pod uid -> claim name nominations (kube-scheduler binds for real;
        # the registration controller honors these on node readiness)
        self.nominations: dict[str, str] = {}
        self._nominations_lock = threading.Lock()
        self.last_unschedulable: list = []
        # the last solve pass's wall split (ms) and its pre-opened rows
        self.timings: dict = {}
        # sharded provisioning: the elector behind this replica's ownership
        # snapshot (testenv/operator wire it) — consulted only for the
        # netsplit seam (a replica cut off from the lease host must not
        # keep claiming GLOBAL-queue work on its stale snapshot)
        self.elector = None

    def reconcile(self) -> None:
        from ..operator import sharding

        self._prune_stale_nominations()
        self.last_unschedulable = []
        own = sharding.current()
        if own is None:
            # no ambient ownership (single replica): one global solve
            self._provision()
            return
        # Sharded provisioning: route the pending set through the
        # ownership snapshot — partition-pinned pods solve locally under
        # their partition lease, truly global pods through the fenced
        # work-stealing GLOBAL queue (designs/sharded-provisioning.md).
        with self._nominations_lock:
            nominated = set(self.nominations)
        pending = [
            p for p in self.cluster.pending_pods() if p.uid not in nominated
        ]
        if not pending:
            return
        nodepools = list(self.cluster.nodepools.values())
        local, global_pods, foreign = sharding.split_pending(
            pending, nodepools, own
        )
        from ..metrics import PROVISIONING_SHARDED_PODS

        for scope_name, n in (
            ("local", sum(len(v) for v in local.values())),
            ("global", len(global_pods)),
            ("foreign", len(foreign)),
        ):
            if n:
                PROVISIONING_SHARDED_PODS.inc(n, scope=scope_name)
        # flight recorder: one route hop per pod (record_once — a pod
        # pending across many passes routes once), and the GLOBAL pods'
        # queue-wait clocks start here. Foreign pods are skipped: their
        # partition's owner records the same deterministic routing as
        # `local` — exactly one replica narrates each pod's route.
        obs = self._obs()
        now = self.clock.now()
        ledger = getattr(obs, "ledger", None)
        if ledger is not None:
            from ..trace.correlate import correlation_id

            for key, pods in local.items():
                for p in pods:
                    if ledger.has_recorded(correlation_id("Pod", p.uid),
                                           "route"):
                        continue
                    ledger.record_once(
                        ledger.mint("Pod", p.uid, name=p.name), "route",
                        subject_kind="Pod", subject=p.name, at=now,
                        detail={"scope": "local", "partition": list(key)},
                    )
            for p in global_pods:
                if ledger.has_recorded(correlation_id("Pod", p.uid),
                                       "route"):
                    continue
                ledger.record_once(
                    ledger.mint("Pod", p.uid, name=p.name), "route",
                    subject_kind="Pod", subject=p.name, at=now,
                    detail={"scope": "global"},
                )
        for p in global_pods:
            obs.sli.pod_routed_global(p.uid, now=now)
        # owned partitions first (lease-name order — deterministic): each
        # bucket solves on this replica's device mirror against ITS OWN
        # partition's capacity only (a pinned pod can't land elsewhere),
        # sanctioned by the partition's lease so every launch carries its
        # fencing token. One O(pods) usage walk and one occupancy snapshot
        # are shared by every bucket this pass solves — binds landed by an
        # earlier bucket of the SAME pass are invisible to later buckets'
        # planning, which is safe because _apply_binds re-verifies slack
        # against live usage at apply time. (The pending re-list and the
        # node/claim scans inside snapshot_existing_capacity remain
        # per-bucket — the freshness contract each solve snapshot keeps;
        # those scans parallelize across replicas, which is where the
        # config9_provisioning speedup comes from.)
        usage = occupancy = None
        if local or global_pods:
            from ..ops.encode import ZoneOccupancy

            usage = self.cluster.node_usage()
            occupancy = ZoneOccupancy.from_cluster(self.cluster)
        for key in sorted(local, key=sharding.lease_name):
            with sharding.sanction(key):
                self._provision(
                    scope=key, pod_uids={p.uid for p in local[key]},
                    partition=key, usage=usage, occupancy=occupancy,
                )
        # truly global pods: fenced, exactly-once claim from the queue
        claimed, fence_key = self._claim_global(global_pods, own)
        if claimed:
            stolen = fence_key != sharding.GLOBAL_KEY
            now = self.clock.now()
            names = {p.uid: p.name for p in global_pods}
            fence = own.fence(fence_key)
            for uid in claimed:
                obs.sli.pod_work_claimed(uid, now=now, stolen=stolen)
                if ledger is not None:
                    ledger.record_once(
                        ledger.mint("Pod", uid, name=names.get(uid)),
                        "steal" if stolen else "claim",
                        subject_kind="Pod", subject=names.get(uid, uid),
                        at=now, fence=fence,
                        detail={"queue": sharding.WORK_QUEUE},
                    )
            with sharding.sanction(fence_key):
                self._provision(
                    scope=("global", frozenset(claimed)),
                    pod_uids=set(claimed), usage=usage, occupancy=occupancy,
                )

    def _claim_global(self, pods, own) -> tuple[list, Optional[tuple]]:
        """Claim global pending pods from the work-stealing queue on the
        lease host. Returns ``(claimed pod uids, sanctioning key)``.

        The GLOBAL-lease holder claims its whole batch; any OTHER lease
        holder steals only while the GLOBAL lease has no live holder
        (replica loss — the work must not stall a full rendezvous cycle).
        Either way the claim CAS is fenced by the claimant's own lease
        token: a deposed replica's claim attempt raises and it stands
        down instead of double-solving (exactly-once handoff; re-steal of
        a dead claimant's pods happens through claim-TTL expiry)."""
        from ..metrics import PROVISIONING_STEALS
        from ..operator import sharding
        from ..utils.errors import StaleFencingTokenError

        if not pods:
            return [], None
        sf = sharding.steal_fence(own)
        if sf is None:
            return [], None  # lease-less replica: stand down
        key, fence = sf
        holds_global = key == sharding.GLOBAL_KEY
        host = getattr(self.cloudprovider, "cloud", None)
        if host is None or not hasattr(host, "try_claim_work"):
            # lease host without a work queue (plain backend): the
            # GLOBAL holder provisions everything, nobody steals
            if holds_global:
                return [p.uid for p in pods], key
            return [], None
        if getattr(self.elector, "partitioned", False):
            # netsplit from the lease host: existing claims ride to their
            # TTL, but no new work is claimed on the stale snapshot
            return [], None
        if not holds_global and self._global_lease_live(host):
            # the GLOBAL holder is alive — its batches own the queue; a
            # steal now would only contend the CAS
            return [], None
        want = sorted(p.uid for p in pods)
        try:
            granted = host.try_claim_work(
                sharding.WORK_QUEUE, want, own.replica,
                WORK_CLAIM_TTL_S, fence,
            )
        except StaleFencingTokenError:
            PROVISIONING_STEALS.inc(outcome="fenced")
            return [], None
        except Exception:
            return [], None  # lease host unreachable: claim nothing
        if granted:
            PROVISIONING_STEALS.inc(
                len(granted),
                outcome="claimed" if holds_global else "stolen",
            )
        if len(granted) < len(want):
            PROVISIONING_STEALS.inc(
                len(want) - len(granted), outcome="contended"
            )
        return granted, key

    def _global_lease_live(self, host) -> bool:
        from ..operator import sharding

        try:
            leases = host.list_leases(sharding.LEASE_PREFIX + "/")
        except Exception:
            return True  # indeterminate: assume the holder lives (no steal)
        return sharding.lease_name(sharding.GLOBAL_KEY) in leases

    def _provision(self, scope=None, pod_uids: Optional[set] = None,
                   partition: Optional[tuple] = None, usage=None,
                   occupancy=None) -> None:
        """One solve pass over the pending set (or the ``pod_uids``
        subset), applying binds and driving launches. ``scope`` is the
        routing identity mixed into the encoded-problem cache revision so
        two different subsets of one store revision can never alias;
        ``partition`` scopes the existing-capacity snapshot to the owned
        (nodepool, zone); ``usage`` shares one node-usage walk across a
        sharded pass's solves."""
        from ..models.pod import POD_WRITE_SEQ
        from ..operator import sharding

        # revision components are captured BEFORE the pending snapshot: a
        # mutation racing the list read then leaves the token OLDER than the
        # pods (at worst one extra cache miss next pass) — capturing after
        # would let a newer token alias a stale pod list into the
        # encoded-problem cache
        t_start = time.perf_counter()
        rev0 = getattr(self.cluster, "rev", None)
        epoch0 = getattr(self.cluster, "epoch", None)
        pod_seq0 = POD_WRITE_SEQ.v
        with self._nominations_lock:
            nominated_map = dict(self.nominations)
        nominated = set(nominated_map)
        pending = [
            p for p in self.cluster.pending_pods()
            if p.uid not in nominated
            and (pod_uids is None or p.uid in pod_uids)
        ]
        if not pending:
            return
        nodepools = list(self.cluster.nodepools.values())
        if not nodepools:
            return
        from ..ops.encode import ZoneOccupancy
        from ..scheduling.solver import snapshot_existing_capacity

        # O(1) revision token for the encoded-problem cache: the pending set
        # is fully determined by (store epoch, store revision, nominations,
        # routing scope), so the cache key skips the per-pod id/version
        # tuples. epoch is an identity object — a reset store can never
        # alias an old revision — and POD_WRITE_SEQ rides along so a direct
        # pod field reassignment (bumps Pod._version, not cluster.rev)
        # still misses the cache.
        revision = (
            (epoch0, rev0, pod_seq0, frozenset(nominated), scope)
            if epoch0 is not None and rev0 is not None
            else None
        )
        if occupancy is None:
            occupancy = ZoneOccupancy.from_cluster(self.cluster)
        type_allow = {
            pool.name: self.cloudprovider.launchable_type_names(pool)
            for pool in nodepools
        }
        reserved_allow = {
            pool.name: self.cloudprovider.pool_reserved_allowed(pool)
            for pool in nodepools
        }
        nodeclass_by_pool = self.cluster.nodeclass_by_pool(nodepools)
        # already-bound gang members credit their gang's all-or-nothing
        # floor, so a partially-bound gang's stragglers can complete
        # (scheduling/groups.enforce_gangs); one O(pods) pass, only when a
        # pending pod actually carries a gang annotation
        from ..models.pod import gangs_enabled as _gangs_enabled

        gang_bound = None
        if _gangs_enabled() and any(p.gang_name() for p in pending):
            gang_bound = self.cluster.gang_bound_counts()
        # Live nodes AND in-flight claims ride into the solve as pre-opened
        # capacity, so pending pods land on slack already owned (or already
        # being launched) instead of opening more.
        t_snap = time.perf_counter()
        existing = snapshot_existing_capacity(
            self.cluster, nominated_map, partition=partition, usage=usage,
        )
        t_solve = time.perf_counter()
        with self.profiler.capture("solve"):
            result = self.solver.solve(
                pending,
                nodepools,
                self.cloudprovider.catalog,
                in_use=self.cluster.in_use_by_nodepool(),
                occupancy=occupancy,
                revision=revision,
                type_allow=type_allow,
                reserved_allow=reserved_allow,
                existing=existing,
                # per-pool nodeclass: ephemeral-storage capacity follows its
                # root volume + instanceStorePolicy (types.go:218-244)
                nodeclass_by_pool=nodeclass_by_pool,
                gang_bound=gang_bound,
            )
        t_solved = time.perf_counter()
        from ..metrics import SOLVE_DURATION, SOLVE_PODS

        SOLVE_DURATION.observe(result.solve_seconds)
        SOLVE_PODS.inc(len(pending))
        # accumulate across this pass's solves (one per routing scope when
        # sharded; exactly one in the single-replica path)
        self.last_unschedulable = (
            list(self.last_unschedulable) + list(result.unschedulable)
        )
        obs = self._obs()
        self._audit_solve(result, obs.audit, rev0)
        ledger = getattr(obs, "ledger", None)
        if ledger is not None:
            # one solve hop per pod this pass planned (record_once: an
            # unschedulable pod re-solving every pass narrates once)
            prov = _provenance_label(result.provenance)
            now = self.clock.now()
            if partition is not None:
                solve_scope = {"scope": "local", "partition": list(partition)}
            elif scope is not None:
                solve_scope = {"scope": "global"}
            else:
                solve_scope = {"scope": "single"}
            from ..trace.correlate import correlation_id

            for pod in pending:
                if ledger.has_recorded(correlation_id("Pod", pod.uid),
                                       "solve"):
                    continue
                ledger.record_once(
                    ledger.mint("Pod", pod.uid, name=pod.name), "solve",
                    subject_kind="Pod", subject=pod.name, at=now,
                    detail=dict(solve_scope, provenance=prov),
                )
        # one SLI event per solve pass: good iff every pod was placed
        obs.slo.record(
            "solve-success", good=not result.unschedulable,
            at=self.clock.now(),
        )
        from ..events import WARNING

        for pod, reason in result.unschedulable:
            log.info("pod %s unschedulable: %s", pod.name, reason)
            self.recorder.publish(
                "Pod", pod.name, "FailedScheduling", reason, type=WARNING
            )
        t_bind = time.perf_counter()
        self._apply_binds(result.binds)
        t_launch = time.perf_counter()
        specs = result.node_specs
        if specs:
            import os

            # worker threads don't inherit the reconcile thread's ambient
            # ownership or sanction (thread-locals) — capture both here
            # and re-enter them inside each launch so CloudProvider.create
            # stamps the right fencing token whichever thread runs it
            own = sharding.current()
            sanction_key = sharding.current_sanction()
            launch = lambda spec: self._launch(spec, own, sanction_key)  # noqa: E731
            if len(specs) == 1 or os.environ.get(
                "KARPENTER_TPU_SERIAL_LAUNCH"
            ) == "1":
                # KARPENTER_TPU_SERIAL_LAUNCH=1: deterministic harnesses
                # (the fleet simulator's byte-identical-report contract)
                # serialize launches — thread scheduling otherwise decides
                # claim names, event order, and capacity-pool draw order
                for spec in specs:
                    launch(spec)
            else:
                with ThreadPoolExecutor(max_workers=min(MAX_LAUNCH_WORKERS, len(specs))) as pool:
                    list(pool.map(launch, specs))
        # Sampled oracle price gap LAST, after binds and launches are
        # applied: quality telemetry must never add latency to pod
        # time-to-bind — the SLI this subsystem measures. Keyed on
        # (epoch, rev) at call time, so an unchanged follow-up pass never
        # re-runs the oracle.
        t_oracle = time.perf_counter()
        obs.oracle.maybe_sample(
            self.cluster, result, pending, nodepools,
            self.cloudprovider.catalog, occupancy=occupancy,
            type_allow=type_allow, reserved_allow=reserved_allow,
            nodeclass_by_pool=nodeclass_by_pool, revision=revision,
        )
        t_end = time.perf_counter()
        self.timings = {
            "prepare_ms": (t_snap - t_start) * 1e3,
            "snapshot_ms": (t_solve - t_snap) * 1e3,
            "solve_ms": (t_solved - t_solve) * 1e3,
            "audit_ms": (t_bind - t_solved) * 1e3,
            "bind_ms": (t_launch - t_bind) * 1e3,
            "launch_ms": (t_oracle - t_launch) * 1e3,
            "oracle_ms": (t_end - t_oracle) * 1e3,
            "wall_ms": (t_end - t_start) * 1e3,
            "n_pre": len(existing), "pods": len(pending), "binds": len(result.binds),
            "specs": len(specs), "cost": result.total_cost,
        }

    def _obs(self):
        if self.obs is None:
            from ..obs import default_obs

            self.obs = default_obs()
        return self.obs

    def _audit_solve(self, result, audit, rev) -> None:
        """One audit record per placement decision this solve made: the
        winning target (instance type + price for launches, node for
        binds) plus the top rejected alternatives, joined to the solve's
        provenance label so ``obs explain`` can name the machinery."""
        now = self.clock.now()
        prov = _provenance_label(result.provenance)
        catalog = self.cloudprovider.catalog
        for pod, node_name in result.binds:
            audit.record(
                "placement", "Pod", pod.name, f"bind:{node_name}",
                {"node": node_name, "provenance": prov},
                at=now, rev=rev,
            )
        for spec in result.node_specs:
            winner = spec.instance_type_options[0] if spec.instance_type_options else "?"
            alts = []
            for alt in spec.instance_type_options[1:4]:
                it = catalog.get(alt)
                price = (
                    catalog.pricing.on_demand_price(it)
                    if it is not None else None
                )
                alts.append({
                    "instance_type": alt,
                    "price": round(float(price), 4) if price is not None else None,
                })
            detail = {
                "instance_type": winner,
                "nodepool": spec.nodepool_name,
                "price": round(float(spec.estimated_price), 4),
                "zones": list(spec.zone_options),
                "capacity_types": list(spec.capacity_type_options),
                "rejected_alternatives": alts,
                "provenance": prov,
            }
            for pod in spec.pods:
                audit.record(
                    "placement", "Pod", pod.name, f"launch:{winner}",
                    detail, at=now, rev=rev,
                )
        why_map = getattr(result, "why", None) or {}
        for pod, reason in result.unschedulable:
            detail = {"reason": reason, "provenance": prov}
            rec = why_map.get(pod.uid)
            if rec:
                # the why-engine verdict rides the audit record AND the
                # live board + reason metric family (obs/why.py); absent
                # whenever KARPENTER_TPU_WHY=0 so the legacy audit shape
                # is byte-identical under the kill switch
                detail["why"] = dict(rec)
                self._count_why(pod.name, rec, now)
            audit.record(
                "placement", "Pod", pod.name, "unschedulable",
                detail, at=now, rev=rev,
            )

    @staticmethod
    def _count_why(pod_name: str, rec: dict, now: float) -> None:
        try:
            from ..metrics import UNSCHEDULABLE_REASONS
            from ..obs.why import board

            UNSCHEDULABLE_REASONS.inc(reason=str(rec.get("top", "")))
            board().stamp(pod_name, rec, at=now)
        except Exception:  # pragma: no cover - telemetry is best-effort
            pass

    def _note_nominated(self, uid: str, claim: Optional[str] = None) -> None:
        observer = getattr(self.cluster, "observer", None)
        if observer is not None:
            observer.pod_nominated(uid, now=self.clock.now(), claim=claim)

    def _apply_binds(self, binds) -> None:
        """Bind planned pods onto existing nodes, re-verifying slack at apply
        time: the 1 s host binder may have consumed the snapshotted free
        capacity during a multi-second solve, and binding past it would
        overcommit the node. Skipped pods stay pending and re-enter the next
        solve. Plan rows targeting IN-FLIGHT claims become nominations —
        registration binds them (with its own fit check) once the node
        joins."""
        from ..scheduling.solver import IN_FLIGHT_PREFIX

        if not binds:
            return
        usage = self.cluster.node_usage()
        nodes = {n.name: n for n in self.cluster.snapshot_nodes()}
        claims = {c.name: c for c in self.cluster.snapshot_claims()}
        free: dict[str, object] = {}
        for pod, node_name in binds:
            live = self.cluster.pods.get(pod.uid)
            if live is None or not live.is_pending():
                continue
            if node_name.startswith(IN_FLIGHT_PREFIX):
                cname = node_name[len(IN_FLIGHT_PREFIX):]
                claim = claims.get(cname)
                if claim is None or claim.deleted:
                    continue  # launch died under us; re-solve next pass
                with self._nominations_lock:
                    self.nominations[pod.uid] = cname
                self._note_nominated(pod.uid, cname)
                continue
            node = nodes.get(node_name)
            if node is None or not node.ready or node.cordoned:
                continue
            f = free.get(node_name)
            if f is None:
                used = usage.get(node_name)
                f = node.allocatable.v - (used if used is not None else 0)
            if (pod.requests.v > f + 1e-6).any():
                continue  # slack raced away; re-solve next pass
            self.cluster.bind_pod(pod.uid, node_name, now=self.clock.now())
            free[node_name] = f - pod.requests.v

    def _prune_stale_nominations(self) -> None:
        """Drop nominations whose claim died before binding, so their pods
        re-enter the next solve instead of pending forever."""
        claims = {c.name: c for c in self.cluster.snapshot_claims()}
        with self._nominations_lock:
            self.nominations = {
                uid: cn
                for uid, cn in self.nominations.items()
                if cn in claims and not claims[cn].deleted
            }

    def _launch(self, spec: NodeSpec, own=None, sanction_key=None) -> None:
        from ..operator import sharding

        pool = self.cluster.nodepools.get(spec.nodepool_name)
        if pool is None:
            return
        with sharding.scope(own) if own is not None else _null_ctx():
            with (sharding.sanction(sanction_key) if sanction_key is not None
                  else _null_ctx()):
                claim = launch_claim(self.cluster, self.cloudprovider, pool,
                                     spec, recorder=self.recorder)
                if claim is None:
                    return
                # hop + nomination bookkeeping stays INSIDE the re-entered
                # scope: the hop's replica stamp and fence must name the
                # launcher whichever worker thread runs this
                fence = sharding.write_fence(cluster=self.cluster, claim=claim)
                ledger = getattr(self._obs(), "ledger", None)
                if ledger is not None:
                    now = self.clock.now()
                    claim_cid = ledger.mint("NodeClaim", claim.name)
                    for pod in spec.pods:
                        ledger.record_once(
                            ledger.mint("Pod", pod.uid, name=pod.name),
                            "launch", key=claim.name, subject_kind="Pod",
                            subject=pod.name, at=now, fence=fence,
                            detail={"claim": claim.name},
                        )
                    # the claim side carries the reverse link, so a claim's
                    # timeline names the pods it was launched for
                    ledger.record_once(
                        claim_cid, "launch-for", key=claim.name,
                        subject_kind="NodeClaim", subject=claim.name, at=now,
                        fence=fence,
                        detail={"pods": sorted(p.name for p in spec.pods)},
                    )
                with self._nominations_lock:
                    for pod in spec.pods:
                        self.nominations[pod.uid] = claim.name
                for pod in spec.pods:
                    self._note_nominated(pod.uid, claim.name)

    def forget_nominations_for(self, claim_name: str) -> None:
        with self._nominations_lock:
            self.nominations = {
                uid: c for uid, c in self.nominations.items() if c != claim_name
            }


def launch_claim(cluster: Cluster, cloudprovider: CloudProvider, pool, spec: NodeSpec,
                 recorder=None):
    """Build a NodeClaim from a NodeSpec and drive CloudProvider.Create.

    The single launch path for both the provisioner and the disruption
    controller's replacements. Pool template labels/annotations are stamped
    onto the claim (and thus the node), so pod selectors on them hold.
    Returns the claim, or None on failure (the claim is cleaned up and the
    ICE cache already updated by the provider).
    """
    claim = NodeClaim.fresh(
        nodepool_name=pool.name,
        nodeclass_name=pool.nodeclass_name,
        # copies: NodeSpec option lists are SHARED across same-window specs
        # (decode optimization); the long-lived claim must own its own
        instance_type_options=list(spec.instance_type_options),
        zone_options=list(spec.zone_options),
        capacity_type_options=list(spec.capacity_type_options),
        offering_options=list(spec.offering_options),
        labels=dict(pool.labels),
        annotations=dict(pool.annotations),
        taints=list(pool.taints),
        startup_taints=list(pool.startup_taints),
    )
    # template-hash stamp: a later pool edit drifts this claim (core
    # NodePool static-drift analogue)
    claim.annotations[lbl.ANNOTATION_NODEPOOL_HASH] = pool.hash()
    # grace snapshot: the termination deadline must survive pool edits
    claim.termination_grace_period_s = pool.termination_grace_period_s
    cluster.apply(claim)
    from ..events import WARNING, default_recorder

    recorder = recorder or default_recorder()
    try:
        cloudprovider.create(claim)
        cluster.apply(claim)  # re-apply: provider_id set -> claims_seq bump
        from ..metrics import NODES_CREATED

        NODES_CREATED.inc(nodepool=pool.name)
        recorder.publish(
            "NodeClaim", claim.name, "Launched",
            f"launched {claim.labels.get(lbl.INSTANCE_TYPE_LABEL, '?')} "
            f"in {claim.labels.get(lbl.TOPOLOGY_ZONE, '?')} "
            f"({claim.labels.get(lbl.CAPACITY_TYPE, '?')}) for pool {pool.name}",
        )
        return claim
    except Exception as e:
        # ICE or launch failure: drop the claim; the unavailable cache now
        # masks the offering, so the next solve re-plans around it
        # (parity: instance.go:362-368 + provisioner retry).
        log.warning("launch failed for %s: %s", claim.name, e)
        recorder.publish(
            "NodeClaim", claim.name, "LaunchFailed", str(e)[:200], type=WARNING
        )
        cluster.finalize(claim)
        cluster.delete(claim)
        return None
