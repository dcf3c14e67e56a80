"""Solving onto existing capacity, on the port and on the JAX package.

- The reference's ``TestExistingCapacity`` cases (live nodes offered as
  pre-opened rows: slack first, overflow, other pools, full nodes, zones,
  hostname caps, out-of-band taints and labels, pool taints) on both
  packages' solvers, ``TorchSolver(device="cpu")`` against ``TPUSolver``
  and ``HostSolver`` against ``HostSolver``: the same plan.
- ``snapshot_existing_capacity`` on a reference store carried to the port
  by ``interop.cluster_from_reference`` (ready, cordoned, not-ready and
  draining nodes, used slack, taints), and on the in-flight claims and
  nominations of ``TestInFlightCapacity``: the same rows.
- Control-plane runs on both packages' environments, lane off and on, held
  equal as ``tests/test_torch_controlplane.py`` holds them: the in-flight
  bursts, ``TestExistingCapacityControlPlane``'s bind onto live slack, and
  a 200-node config7-shaped cluster (``benchmarks/solve_configs.py``
  ``config7_steady_state``: spot c/m nodes of 4-16 vCPUs, 1-6 bound pods of
  250m/512Mi each) built in the reference store and carried to the port by
  ``cluster_from_reference``, whose 50-pod burst binds identically.
"""

import numpy as np
import pytest

from test_torch_controlplane import PACKAGES, cmr_pool, observe, package, step
from test_torch_solver import _plan

from karpenter_provider_aws_tpu_torch.interop import cluster_from_reference
from karpenter_provider_aws_tpu_torch.ops import cluster_cases


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_SERIAL_LAUNCH", "1")
    for var in ("KARPENTER_TPU_OPTIMIZER_SEED", "KARPENTER_TPU_OPTIMIZER_LANES",
                "KARPENTER_TPU_MARKET", "KARPENTER_TPU_WHY", "KARPENTER_TPU_OPTIMIZER"):
        monkeypatch.delenv(var, raising=False)


def solver_package(root):
    import importlib

    P = package(root)
    solver = importlib.import_module(f"{root}.scheduling.solver")
    P.ExistingNode = solver.ExistingNode
    P.snapshot = solver.snapshot_existing_capacity
    P.HostSolver = solver.HostSolver
    P.DeviceSolver = ((lambda: solver.TorchSolver(device="cpu")) if root.endswith("_torch")
                      else solver.TPUSolver)
    P.CatalogProvider = importlib.import_module(f"{root}.catalog").CatalogProvider
    P.ResourceVector = importlib.import_module(f"{root}.models.resources").ResourceVector
    P.Taint = importlib.import_module(f"{root}.models").Taint
    P.PodAffinityTerm = importlib.import_module(f"{root}.models.pod").PodAffinityTerm
    P.NodeClaim = importlib.import_module(f"{root}.models.nodeclaim").NodeClaim
    P.Node = importlib.import_module(f"{root}.state.cluster").Node
    P.Cluster = importlib.import_module(f"{root}.state.cluster").Cluster
    return P


def existing_node(P, catalog, name="live-0", pool="default", min_vcpus=16, used=None):
    it = next(t for t in catalog.list() if t.category in ("c", "m") and t.vcpus >= min_vcpus)
    alloc = catalog.allocatable(it)
    return P.ExistingNode(
        name=name, nodepool_name=pool, instance_type=it.name, zone=catalog.zones[0],
        capacity_type="on-demand",
        used=(used if used is not None else P.ResourceVector()).v.astype(np.float32),
        allocatable=alloc.v.astype(np.float32),
    ), it


# -- 1. the reference's TestExistingCapacity cases -----------------------------

def slack_before_new_nodes(P, catalog, solver):
    node, _ = existing_node(P, catalog)
    res = solver.solve(P.make_pods(4, "w", {"cpu": "1", "memory": "1Gi"}), [cmr_pool(P)],
                       catalog, existing=[node])
    assert res.node_specs == [] and len(res.binds) == 4 and res.total_cost == 0.0
    return res


def overflow_after_slack(P, catalog, solver):
    node, it = existing_node(P, catalog, min_vcpus=4)
    node.used = P.ResourceVector.from_map(
        {"cpu": max(it.vcpus - 2.5, 0.5), "memory": "1Gi"}).v.astype(np.float32)
    res = solver.solve(P.make_pods(30, "w", {"cpu": "1", "memory": "1Gi"}), [cmr_pool(P)],
                       catalog, existing=[node])
    assert res.pods_placed() == 30 and res.binds and res.node_specs
    return res


def other_pools_nodes_unused(P, catalog, solver):
    node, _ = existing_node(P, catalog, pool="other")
    res = solver.solve(P.make_pods(2, "w", {"cpu": "1", "memory": "1Gi"}), [cmr_pool(P)],
                       catalog, existing=[node])
    assert res.binds == [] and res.node_specs
    return res


def full_node_gets_nothing(P, catalog, solver):
    node, _ = existing_node(P, catalog)
    node.used = node.allocatable.copy()
    res = solver.solve(P.make_pods(3, "w", {"cpu": "1", "memory": "1Gi"}), [cmr_pool(P)],
                       catalog, existing=[node])
    assert res.binds == [] and res.pods_placed() == 3
    return res


def zone_pinned_pods_respect_node_zone(P, catalog, solver):
    node, _ = existing_node(P, catalog)
    pods = P.make_pods(2, "w", {"cpu": "1", "memory": "1Gi"},
                       node_selector={P.lbl.TOPOLOGY_ZONE: catalog.zones[1]})
    res = solver.solve(pods, [cmr_pool(P)], catalog, existing=[node])
    assert res.binds == [] and res.pods_placed() == 2
    return res


def hostname_capped_pods_stay_off(P, catalog, solver):
    node, _ = existing_node(P, catalog)
    pods = P.make_pods(3, "w", {"cpu": "1", "memory": "1Gi"}, labels={"app": "w"},
                       anti_affinity=[P.PodAffinityTerm(topology_key=P.lbl.HOSTNAME,
                                                        label_selector={"app": "w"})])
    res = solver.solve(pods, [cmr_pool(P)], catalog, existing=[node])
    assert res.binds == [] and len(res.node_specs) == 3
    return res


def node_taint_blocks_binds(P, catalog, solver):
    node, _ = existing_node(P, catalog)
    node.taints = (P.Taint(key="maintenance", value="true", effect="NoSchedule"),)
    res = solver.solve(P.make_pods(2, "w", {"cpu": "1", "memory": "1Gi"}), [cmr_pool(P)],
                       catalog, existing=[node])
    assert res.binds == [] and res.pods_placed() == 2
    return res


def diverged_labels_block_binds(P, catalog, solver, team="a"):
    pool = cmr_pool(P)
    pool.labels = {"team": "b"}
    node, it = existing_node(P, catalog)
    node.labels = {**it.labels(), "team": team, P.lbl.TOPOLOGY_ZONE: node.zone,
                   P.lbl.CAPACITY_TYPE: node.capacity_type, P.lbl.NODEPOOL: "default"}
    pods = P.make_pods(2, "w", {"cpu": "1", "memory": "1Gi"}, node_selector={"team": "b"})
    res = solver.solve(pods, [pool], catalog, existing=[node])
    assert len(res.binds) == (2 if team == "b" else 0)
    return res


def matching_labels_still_bind(P, catalog, solver):
    return diverged_labels_block_binds(P, catalog, solver, team="b")


def pool_taints_respected(P, catalog, solver):
    pool = cmr_pool(P)
    pool.name = "tainted"
    pool.taints = [P.Taint(key="team", value="ml")]
    node, _ = existing_node(P, catalog, pool="tainted")
    res = solver.solve(P.make_pods(2, "w", {"cpu": "1", "memory": "1Gi"}), [pool], catalog,
                       existing=[node])
    assert res.binds == [] and res.node_specs == [] and len(res.unschedulable) == 2
    return res


SOLVE_CASES = [slack_before_new_nodes, overflow_after_slack, other_pools_nodes_unused,
               full_node_gets_nothing, zone_pinned_pods_respect_node_zone,
               hostname_capped_pods_stay_off, node_taint_blocks_binds,
               diverged_labels_block_binds, matching_labels_still_bind, pool_taints_respected]


@pytest.mark.parametrize("kind", ["device", "host"])
@pytest.mark.parametrize("case", SOLVE_CASES, ids=lambda f: f.__name__)
def test_existing_capacity_solve_equals_reference(case, kind):
    plans = []
    for root in PACKAGES:
        P = solver_package(root)
        solver = P.DeviceSolver() if kind == "device" else P.HostSolver()
        plans.append(_plan(case(P, P.CatalogProvider(), solver)))
    assert plans[1] == plans[0]


# -- 2. snapshot_existing_capacity ----------------------------------------------

def reference_snapshot(cluster) -> dict:
    """A reference store as the plain data ``cluster_from_reference`` takes."""
    return {
        "nodepools": [{"name": p.name, "nodeclass_name": p.nodeclass_name,
                       "requirements": [(r.key, r.operator.value, r.values)
                                        for r in p.requirements],
                       "labels": p.labels, "annotations": p.annotations,
                       "taints": [(t.key, t.value, t.effect) for t in p.taints],
                       "weight": p.weight,
                       "disruption": {
                           "consolidation_policy": p.disruption.consolidation_policy,
                           "consolidate_after_s": p.disruption.consolidate_after_s,
                           "expire_after_s": p.disruption.expire_after_s,
                           "budgets": [b if isinstance(b, str) else
                                       (b.nodes, b.reasons, b.schedule, b.duration_s)
                                       for b in p.disruption.budgets]}}
                      for p in cluster.nodepools.values()],
        "nodeclasses": [{"name": nc.name, "role": nc.role}
                        for nc in cluster.nodeclasses.values()],
        "claims": [{"name": c.name, "nodepool_name": c.nodepool_name,
                    "nodeclass_name": c.nodeclass_name, "labels": c.labels,
                    "annotations": c.annotations,
                    "instance_type_options": c.instance_type_options,
                    "zone_options": c.zone_options,
                    "capacity_type_options": c.capacity_type_options,
                    "provider_id": c.status.provider_id, "node_name": c.status.node_name,
                    "capacity": c.status.capacity.v, "allocatable": c.status.allocatable.v,
                    "conditions": [k for k, v in c.status.conditions.items() if v.status]}
                   for c in cluster.nodeclaims.values()],
        "nodes": [{"name": n.name, "provider_id": n.provider_id,
                   "nodepool_name": n.nodepool_name, "nodeclaim_name": n.nodeclaim_name,
                   "labels": n.labels, "capacity": n.capacity.v,
                   "allocatable": n.allocatable.v, "ready": n.ready, "cordoned": n.cordoned}
                  for n in cluster.nodes.values()],
        "pods": [{"name": p.name, "requests": p.requests.v, "labels": p.labels,
                  "node_selector": p.node_selector, "node_name": p.node_name}
                 for p in cluster.pods.values()],
    }


def config7_cluster(P, env, n_nodes, pods_per_node=6, seed=1):
    """``config7_steady_state``'s live cluster (``_synth_cluster`` with 6
    pods a node at most) in ``env``'s store."""
    cluster_cases.synth_cluster(P, env.cluster, env.catalog, n_nodes, pods_per_node, seed)


def _rows(rows) -> list:
    return [(r.name, r.nodepool_name, r.instance_type, r.zone, r.capacity_type,
             r.used.tolist(), r.allocatable.tolist(), [(t.key, t.value, t.effect) for t in r.taints],
             sorted(r.labels.items())) for r in rows]


def test_snapshot_of_carried_store_equals_reference():
    """Ready nodes with bound pods, a cordoned node, a node not ready, a
    node whose claim is draining and a node with an out-of-band taint, in
    the reference store; the port's store carried from it gives the same
    rows."""
    P = solver_package(PACKAGES[0])
    env = P.new_environment()
    env.apply_defaults(cmr_pool(P))
    config7_cluster(P, env, 12, seed=4)
    nodes = list(env.cluster.nodes.values())
    nodes[1].cordoned = True
    nodes[2].ready = False
    nodes[3].taints = [P.Taint(key="maintenance", value="true", effect="NoSchedule")]
    draining = env.cluster.nodeclaims[nodes[4].nodeclaim_name]
    draining.finalizers.add("karpenter.sh/termination")
    env.cluster.delete(draining)
    want = _rows(P.snapshot(env.cluster))
    snap = reference_snapshot(env.cluster)
    env.close()
    T = solver_package(PACKAGES[1])
    carried = cluster_from_reference(snap)
    claim = carried.nodeclaims[draining.name]
    claim.finalizers.add("karpenter.sh/termination")
    carried.delete(claim)
    for n in carried.nodes.values():
        if n.name == nodes[3].name:
            n.taints = [T.Taint(key="maintenance", value="true", effect="NoSchedule")]
    got = _rows(T.snapshot(carried))
    assert len(want) == 12 - 3 and got == want


def in_flight_burst(P, env, big=False):
    """``TestInFlightCapacity``: a launch that has not registered, then a
    burst that fits its slack (nominated onto it) or does not (new nodes)."""
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(1 if big else 2, "first", {"cpu": "2", "memory": "4Gi"}):
        env.cluster.apply(p)
    env.provisioning.reconcile()
    claims_before = set(env.cluster.nodeclaims)
    assert claims_before and not any(c.is_registered() for c in env.cluster.nodeclaims.values())
    burst = (P.make_pods(6, "burst", {"cpu": "60", "memory": "120Gi"}) if big
             else P.make_pods(2, "burst", {"cpu": "500m", "memory": "512Mi"}))
    for p in burst:
        env.cluster.apply(p)
    env.provisioning.reconcile()
    with env.provisioning._nominations_lock:
        noms = dict(env.provisioning.nominations)
    rows = _rows(P.snapshot(env.cluster, noms))
    if big:
        assert len(env.cluster.nodeclaims) > len(claims_before)
    else:
        assert set(env.cluster.nodeclaims) == claims_before
        assert all(p.uid in noms for p in burst)
    step(env, 3)
    assert not env.cluster.pending_pods()
    return rows


def _names(env):
    return {c: f"claim{i}" for i, c in enumerate(env.cluster.nodeclaims)}


@pytest.mark.parametrize("big", [False, True], ids=["fits", "oversized"])
def test_in_flight_snapshot_equals_reference(big):
    """The snapshot with in-flight claims and their nominations, taken
    between the burst's solve and registration: the same rows, claim names
    in order of creation."""
    seen = []
    for root in PACKAGES:
        P = solver_package(root)
        env = P.new_environment()
        rows = in_flight_burst(P, env, big)
        names = _names(env)
        seen.append([(names.get(r[0].split(":", 1)[-1], r[0]),) + tuple(r[1:6])
                     + (sorted(k for k, _ in r[8]),) for r in rows])
        env.close()
    assert seen[1] == seen[0] and seen[0]


# -- 3. control-plane runs --------------------------------------------------------

def in_flight_fits(P, env):
    in_flight_burst(P, env)


def in_flight_oversized(P, env):
    in_flight_burst(P, env, big=True)


def binds_to_live_slack_instead_of_launching(P, env):
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(20, "seed", {"cpu": "500m", "memory": "1Gi"}):
        env.cluster.apply(p)
    step(env, 3)
    assert not env.cluster.pending_pods()
    n_claims = len(env.cluster.nodeclaims)
    wave2 = P.make_pods(2, "tiny", {"cpu": "100m", "memory": "128Mi"})
    for p in wave2:
        env.cluster.apply(p)
    env.provisioning.reconcile()
    assert env.manager.errors == []
    assert len(env.cluster.nodeclaims) == n_claims
    for p in wave2:
        assert env.cluster.pods[p.uid].node_name != ""


@pytest.mark.parametrize("lane", ["off", "on"])
@pytest.mark.parametrize("scenario", [in_flight_fits, in_flight_oversized,
                                      binds_to_live_slack_instead_of_launching],
                         ids=lambda f: f.__name__)
def test_control_plane_equals_reference(scenario, lane, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane == "on" else "0")
    seen = {}
    for root in PACKAGES:
        P = solver_package(root)
        env = P.new_environment()
        try:
            scenario(P, env)
            seen[root] = observe(env)
        finally:
            env.close()
    for key in seen[PACKAGES[0]]:
        assert seen[PACKAGES[1]][key] == seen[PACKAGES[0]][key], key


@pytest.mark.parametrize("lane", ["off", "on"])
def test_config7_carried_cluster_burst_binds_identically(lane, monkeypatch):
    """200 live nodes built in the reference store, carried to the port's
    environment by ``cluster_from_reference``; a burst of 50 pods of
    500m/1Gi binds onto the same live nodes, pod for pod, with the lane
    skipped (``skipped_existing``) on both sides. The provisioner reconciles
    first, as the reference's ``TestExistingCapacityControlPlane`` drives it,
    so that the host binder cannot take the burst before the solve sees it;
    then the manager steps until no pod is pending."""
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane == "on" else "0")
    P = solver_package(PACKAGES[0])
    ref = P.new_environment()
    ref.apply_defaults(cmr_pool(P))
    config7_cluster(P, ref, 200)
    snap = reference_snapshot(ref.cluster)
    T = solver_package(PACKAGES[1])
    port = T.new_environment()
    cluster_from_reference({k: v for k, v in snap.items()}, cluster=port.cluster)
    port.nodeclass_status.reconcile()
    port.nodeclass_hash.reconcile()
    assert _rows(T.snapshot(port.cluster)) == _rows(P.snapshot(ref.cluster))
    seen = []
    for Q, env in ((P, ref), (T, port)):
        for p in Q.make_pods(50, "burst", {"cpu": "500m", "memory": "1Gi"}):
            env.cluster.apply(p)
        # the provisioner first: in a manager pass the host binder, which
        # runs before it, would take a burst of 512 pods or fewer itself
        env.provisioning.reconcile()
        assert env.solver.timings.get("opt_lane") in (
            ("skipped_existing",) if lane == "on" else (None, "disabled"))
        step(env, 2)
        assert not env.cluster.pending_pods()
        seen.append(observe(env))
        env.close()
    want, got = seen
    assert sum(1 for d in want["decisions"] if d[2].startswith("bind:")) > 0
    for key in want:
        assert got[key] == want[key], key
