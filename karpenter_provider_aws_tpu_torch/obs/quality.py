"""Solver-quality telemetry: was the fast answer also a good one?

Two layers:

 - **In-band (every solve, cheap):** ``solve_quality`` computes packing
   efficiency (requested/allocatable per resource across committed
   launches) and the unschedulable rate from the finished ``SolveResult``
   alone — O(specs + pods), stamped into the solve's
   provenance dict under ``quality`` and exported as gauges.

 - **Sampled (off the hot path):** ``OracleSampler`` replays the pending
   set through the pure-numpy FFD oracle (``scheduling/oracle.py``) — one
   weight-ordered pool sweep with fall-through, mirroring the solver's
   multi-nodepool walk — and publishes
   ``karpenter_solver_cost_vs_oracle``: committed cost over the oracle's
   cost. Sampling is keyed on the cluster ``(epoch, rev)`` token: an
   unchanged pass NEVER re-runs the oracle (the <1ms warm-pass contract),
   and pure-launch passes only (binds to existing capacity make the
   all-new-nodes oracle incomparable). With the optimizer lane adopted,
   the sampled gap drops BELOW 1.0 — the witness that the global plan
   beat the greedy. ``KARPENTER_TPU_ORACLE_SAMPLE=0`` disables outright.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger("karpenter.tpu.obs")


def packing_efficiency(requested: np.ndarray, allocatable: np.ndarray) -> dict:
    """Per-resource requested/allocatable for the resources that exist on
    both sides (cpu/memory always; accelerators when present)."""
    from ..models.resources import RESOURCE_AXES

    out: dict[str, float] = {}
    for i, name in enumerate(RESOURCE_AXES):
        if allocatable[i] > 0 and requested[i] > 0:
            out[name] = round(float(requested[i] / allocatable[i]), 4)
    return out


# Resources each packing gauge has ever reported: a resource that leaves
# the efficiency map (cluster emptied, workload shape changed) is zeroed
# rather than left frozen at its last value — a dashboard reading a
# packing gauge must never see a dead number.
_reported: dict[int, set] = {}


def _set_packing_gauges(gauge, eff: dict) -> None:
    seen = _reported.setdefault(id(gauge), set())
    for resource in seen - set(eff):
        gauge.set(0.0, resource=resource)
    for resource, v in eff.items():
        gauge.set(v, resource=resource)
    seen |= set(eff)


def solve_quality(result, catalog) -> dict:
    """Compute + export the in-band quality block for one SolveResult.
    Cheap and exception-safe: quality must never take down the solve."""
    from ..metrics import SOLVE_PACKING_EFFICIENCY, UNSCHEDULABLE_PODS
    from ..models.resources import NUM_RESOURCES

    quality: dict = {}
    try:
        requested = np.zeros(NUM_RESOURCES, dtype=np.float64)
        allocatable = np.zeros(NUM_RESOURCES, dtype=np.float64)
        for spec in result.node_specs:
            it = catalog.get(spec.instance_type_options[0]) if spec.instance_type_options else None
            if it is not None:
                allocatable += np.asarray(it.capacity().v, dtype=np.float64)
            for pod in spec.pods:
                requested += np.asarray(pod.requests.v, dtype=np.float64)
        if result.node_specs and allocatable.any():
            eff = packing_efficiency(requested, allocatable)
            _set_packing_gauges(SOLVE_PACKING_EFFICIENCY, eff)
            if eff:
                quality["packing_efficiency"] = eff
        n_unsched = len(result.unschedulable)
        if n_unsched:
            UNSCHEDULABLE_PODS.inc(n_unsched)
        if result.num_pods:
            quality["unschedulable_rate"] = round(n_unsched / result.num_pods, 4)
        if result.provenance is not None and quality:
            result.provenance.setdefault("quality", {}).update(quality)
    except Exception:  # pragma: no cover - defensive
        log.exception("solve quality telemetry failed")
    return quality


class OracleSampler:
    """Price-optimality gap vs the FFD oracle, sampled off the hot path.

    Multi-pool aware: the oracle replays the SAME weight-ordered pool
    sweep the solver runs (pods a pool's oracle cannot place fall through
    to the next pool), so ``cost_vs_oracle`` measures exactly the
    pure-launch passes the optimizer lane targets — single-pool floods
    AND the multi-pool mixed fleets where fragmentation money lives."""

    def __init__(self):
        self._last_key: Optional[tuple] = None

    def maybe_sample(
        self, cluster, result, pods, nodepools, catalog,
        occupancy=None, type_allow=None, reserved_allow=None,
        nodeclass_by_pool=None, revision=None,
    ) -> Optional[float]:
        """Returns the gap (committed/oracle) when sampled, else None.

        Skips when: disabled, the cluster ``(epoch, rev)`` is unchanged
        since the last sample (identical passes pay nothing), the plan
        binds to existing capacity (oracle incomparable), or nothing
        launched. Pool order and fall-through mirror
        ``scheduling.solver._solve_multi_nodepool``; the per-pool encode
        hits the revision-keyed problem cache for the first pool, so a
        single-pool sample stays as cheap as it was."""
        if os.environ.get("KARPENTER_TPU_ORACLE_SAMPLE", "1") != "1":
            return None
        key = (
            getattr(cluster, "epoch", None),
            getattr(cluster, "rev", None),
        )
        if key == self._last_key:
            return None
        self._last_key = key
        if result.binds or not result.node_specs or not nodepools:
            return None
        try:
            from ..ops.encode import encode_problem
            from ..scheduling.oracle import ffd_oracle, oracle_cost

            base = 0.0
            remaining = list(pods)
            first = True
            for pool in sorted(nodepools, key=lambda p: -p.weight):
                if not remaining:
                    break
                # First pool: same arguments as the solve's own encode, so
                # the revision-keyed problem cache serves it free. LATER
                # pools get revision=None — the fall-through pod list is
                # NOT a pure function of the revision (the cache contract,
                # ops/encode.py: the revision path collapses the pods key
                # to (rev, len, id(first))), and the solver's own chained
                # pool problems could collide with it.
                problem = encode_problem(
                    remaining, catalog, nodepool=pool, occupancy=occupancy,
                    allowed_types=(type_allow or {}).get(pool.name),
                    allow_reserved=(
                        reserved_allow.get(pool.name, False)
                        if reserved_allow is not None else True
                    ),
                    nodeclass=(nodeclass_by_pool or {}).get(pool.name),
                    revision=revision if first else None,
                )
                first = False
                nodes, unplaced = ffd_oracle(problem)
                base += oracle_cost(nodes)
                # fall-through: unencodable pods + each group's unplaced
                # tail ride to the next pool, like the solver's pool sweep
                leftover = [p for p, _why in problem.unencodable]
                for g, cnt in unplaced.items():
                    plist = problem.group_pods[g]
                    if problem.atomic is not None and problem.atomic[g]:
                        leftover.extend(plist)
                    else:
                        leftover.extend(plist[len(plist) - cnt:])
                remaining = leftover
            if base <= 0:
                return None
            gap = float(result.total_cost) / base
            from ..metrics import SOLVE_COST_VS_ORACLE

            SOLVE_COST_VS_ORACLE.set(gap)
            if result.provenance is not None:
                result.provenance.setdefault("quality", {})["cost_vs_oracle"] = round(gap, 4)
            return gap
        except Exception:  # pragma: no cover - defensive
            log.exception("oracle quality sample failed")
            return None


_last_pack: tuple = (None, None)  # (weakref to the last ct, its efficiency)


def cluster_packing(ct) -> dict:
    """Per-resource bound/allocatable across a consolidation snapshot's
    live nodes (``ClusterTensors``) — the cluster-wide packing SLI the
    screen sweep refreshes each pass. O(N x R) numpy sums, memoized on
    tensor identity: a no-change warm pass serves the SAME ClusterTensors
    object (ops/encode_delta.py contract), so it pays a pointer compare
    here, keeping the <1ms warm-pass budget intact."""
    global _last_pack
    import weakref

    from ..metrics import CLUSTER_PACKING_EFFICIENCY

    ref, cached = _last_pack
    if ref is not None and ref() is ct:
        return cached
    used = np.asarray(ct.used_total, dtype=np.float64).sum(axis=0)
    cap = used + np.asarray(ct.free, dtype=np.float64).sum(axis=0)
    eff = packing_efficiency(used, cap)
    _set_packing_gauges(CLUSTER_PACKING_EFFICIENCY, eff)
    try:
        _last_pack = (weakref.ref(ct), eff)
    except TypeError:  # pragma: no cover - non-weakrefable snapshot
        _last_pack = (None, None)
    return eff


def fleet_hourly_cost(cluster, catalog) -> float:
    """Total $/hr of the live fleet: every node priced by its instance
    type and capacity type from the catalog's pricing model. The number
    behind the multi-replica packing-envelope-parity check (a sharded
    provisioning split must not buy a measurably more expensive fleet
    than the single-replica solve would have) — deterministic given the
    store and the static catalog."""
    total = 0.0
    for node in cluster.snapshot_nodes():
        it = catalog.get(node.instance_type())
        if it is None:
            continue
        try:
            if node.capacity_type() == "spot":
                total += float(catalog.pricing.spot_price(it, node.zone()))
            else:
                total += float(catalog.pricing.on_demand_price(it))
        except Exception:  # pragma: no cover - defensive
            continue
    return round(total, 4)
