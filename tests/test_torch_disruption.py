"""The port's disruption half of the control plane against the JAX package's.

Each case runs one scenario of ``tests/test_disruption.py`` (termination,
the host binder, emptiness, expiration, drift, the validation window,
budgets, consolidation, interruption, the RAID0 replacement screen) or of
``tests/test_spot_to_spot.py`` twice: on the reference's
``new_environment()`` and on the port's ``new_environment(device="cpu")``,
with the same pods, lane off and lane on. It asserts the reference test's
own checks on the port and holds the two runs equal on the launches, pods
sharing a node, pending pods, the audit trail, ``disruption.disrupted`` and
``interruption.handled``, claim and instance names in order of creation
(``cluster_cases.observe_lifecycle``).

Then: ``TestDirtySweepContract``'s seeded churn on both packages (the
dirty-set walk equal to the full walk, and the port's decisions equal to
the reference's); the multi-replace chooser on the reference's
``config6_multi_replace_optimizer`` seeds 0-11; a provisioning-then-
disruption run on a 200-node config4 cluster built in the reference store
and carried to the port; and the screen's backend on a CPU environment.
Every step asserts ``env.manager.errors == []``.
"""

import os

import numpy as np
import pytest

from test_torch_controlplane import (
    PACKAGES, assert_same, package, run_on_both, step,
)
from test_torch_existing_capacity import reference_snapshot

from karpenter_provider_aws_tpu_torch.interop import cluster_from_reference
from karpenter_provider_aws_tpu_torch.ops import cluster_cases


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_SERIAL_LAUNCH", "1")
    for var in ("KARPENTER_TPU_OPTIMIZER_SEED", "KARPENTER_TPU_OPTIMIZER_LANES",
                "KARPENTER_TPU_MARKET", "KARPENTER_TPU_WHY", "KARPENTER_TPU_OPTIMIZER",
                "KARPENTER_TPU_DISRUPTION_DIRTY"):
        monkeypatch.delenv(var, raising=False)


def pool_with(P, max_cpu=None, **disruption_kwargs):
    disruption_kwargs.setdefault("budgets", ["100%"])
    disruption_kwargs.setdefault("consolidate_after_s", None)
    reqs = [P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN, ("c", "m", "r"))]
    if max_cpu is not None:
        reqs.append(P.Requirement(P.lbl.INSTANCE_CPU, P.Operator.LT, (str(max_cpu),)))
    return P.NodePool(name="default", requirements=reqs,
                      disruption=P.Disruption(**disruption_kwargs))


def provision(env, pods):
    for p in pods:
        env.cluster.apply(p)
    step(env, 3)
    assert not env.cluster.pending_pods()


def reasons(env) -> list:
    return [r for _, r in env.disruption.disrupted]


# -- TestTermination, TestScheduler -------------------------------------------

def claim_delete_drains_and_terminates(P, env):
    env.apply_defaults(pool_with(P))
    provision(env, P.make_pods(5, "w", {"cpu": "1", "memory": "2Gi"}))
    claim = next(c for c in env.cluster.nodeclaims.values()
                 if env.cluster.pods_on_node(c.status.node_name))
    provider_id = claim.status.provider_id
    drained = env.cluster.pods_on_node(claim.status.node_name)
    env.cluster.delete(claim)
    env.termination.reconcile()
    assert claim.name not in env.cluster.nodeclaims
    with pytest.raises(Exception):
        env.cloudprovider.get(provider_id)
    assert drained and all(p.is_pending() for p in drained)


def drained_pods_reprovisioned(P, env):
    env.apply_defaults(pool_with(P))
    provision(env, P.make_pods(5, "w", {"cpu": "1", "memory": "2Gi"}))
    env.cluster.delete(next(iter(env.cluster.nodeclaims.values())))
    step(env, 4)
    assert not env.cluster.pending_pods() and len(env.cluster.nodes) >= 1


def pending_pod_lands_on_existing_free_node(P, env):
    env.apply_defaults(pool_with(P))
    provision(env, P.make_pods(1, "big", {"cpu": "6", "memory": "6Gi"}))
    n_nodes = len(env.cluster.nodes)
    extra = P.make_pods(2, "extra", {"cpu": "500m", "memory": "1Gi"})
    for p in extra:
        env.cluster.apply(p)
    env.scheduling.reconcile()
    assert all(not p.is_pending() for p in extra) and len(env.cluster.nodes) == n_nodes


def scheduler_respects_taints_and_labels(P, env):
    env.apply_defaults(pool_with(P))
    provision(env, P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"}))
    for node in env.cluster.nodes.values():
        node.taints = [P.Taint(key="quarantine", effect="NoSchedule")]
    p = P.make_pods(1, "x", {"cpu": "100m"})[0]
    env.cluster.apply(p)
    env.scheduling.reconcile()
    assert p.is_pending()


# -- TestEmptiness, TestExpiration, TestDriftDisruption -----------------------

def empty_node_deleted_after_consolidate_after(P, env):
    env.apply_defaults(pool_with(P, consolidation_policy="WhenEmpty", consolidate_after_s=30))
    pods = P.make_pods(3, "w", {"cpu": "1", "memory": "2Gi"})
    provision(env, pods)
    for p in pods:
        env.cluster.delete(p)
    env.disruption.reconcile()
    assert not any(c.deleted for c in env.cluster.nodeclaims.values())  # too soon
    env.clock.advance(31)
    env.disruption.reconcile()
    assert all(c.deleted for c in env.cluster.nodeclaims.values())


def expired_claims_disrupted(P, env):
    env.apply_defaults(pool_with(P, expire_after_s=3600))
    provision(env, P.make_pods(3, "w", {"cpu": "1", "memory": "2Gi"}))
    env.disruption.reconcile()
    assert not any(c.deleted for c in env.cluster.nodeclaims.values())
    env.clock.advance(3601)
    env.disruption.reconcile()
    assert all(c.deleted for c in env.cluster.nodeclaims.values())


def static_drift_triggers_disruption(P, env):
    env.apply_defaults(pool_with(P))
    provision(env, P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"}))
    env.cluster.nodeclasses["default"].user_data = "changed"
    env.disruption.reconcile()
    assert any("drifted" in r for r in reasons(env))


def nodepool_template_drift_triggers_disruption(P, env):
    pool, _ = env.apply_defaults(pool_with(P))
    provision(env, P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"}))
    pool.weight = 7  # not drift
    env.disruption.reconcile()
    assert not any("NodePool" in r for r in reasons(env))
    pool.labels = {"team": "b"}  # template field: drift
    env.disruption.reconcile()
    assert any("NodePoolHashDrifted" in r for r in reasons(env))


# -- TestValidationWindow ------------------------------------------------------

def _thin_out(env, pods):
    """Keep one pod in 8, so every node keeps a pod and emptiness (which has
    no validation window) cannot fire."""
    for i, p in enumerate(pods):
        if i % 8 != 0:
            env.cluster.delete(p)


def candidate_must_persist_before_commit(P, env):
    env.disruption.validation_period_s = 15.0
    env.apply_defaults(pool_with(P, max_cpu=17, consolidate_after_s=10))
    pods = P.make_pods(30, "w", {"cpu": "1", "memory": "2Gi"})
    provision(env, pods)
    _thin_out(env, pods)
    env.clock.advance(61)
    env.disruption.reconcile()  # first sight: starts the window
    assert not any(r.startswith("consolidatable") for r in reasons(env))
    env.clock.advance(16)
    env.disruption.reconcile()  # window passed: commits
    assert any(r.startswith("consolidatable") for r in reasons(env))


def flapping_candidate_restarts_window(P, env):
    env.disruption.validation_period_s = 15.0
    env.apply_defaults(pool_with(P, max_cpu=17, consolidate_after_s=10))
    pods = P.make_pods(30, "w", {"cpu": "1", "memory": "2Gi"})
    provision(env, pods)
    _thin_out(env, pods)
    env.clock.advance(61)
    env.disruption.reconcile()
    provision(env, P.make_pods(26, "w2", {"cpu": "1", "memory": "2Gi"}))
    env.clock.advance(16)
    env.disruption.reconcile()
    assert not any(r.startswith("consolidatable") for r in reasons(env))


# -- TestBudgets, TestConsolidation --------------------------------------------

def budget_caps_disruptions_per_pass(P, env):
    pool = pool_with(P, max_cpu=100, expire_after_s=60)
    pool.disruption.budgets = ["1"]
    env.apply_defaults(pool)
    provision(env, P.make_pods(4, "w", {"cpu": "60", "memory": "120Gi"}))
    assert len(env.cluster.nodeclaims) >= 3
    env.clock.advance(61)
    env.disruption.reconcile()
    assert sum(1 for c in env.cluster.nodeclaims.values() if c.deleted) == 1


def underutilized_nodes_consolidated(P, env):
    env.apply_defaults(pool_with(P, max_cpu=17, consolidate_after_s=60))
    pods = P.make_pods(30, "w", {"cpu": "1", "memory": "2Gi"})
    provision(env, pods)
    for p in pods[4:]:
        env.cluster.delete(p)
    n_before = len(env.cluster.nodes)
    assert n_before >= 2
    env.clock.advance(61)
    env.disruption.reconcile()
    step(env, 4)
    assert not env.cluster.pending_pods() and len(env.cluster.nodes) < n_before
    assert sum(len(env.cluster.pods_on_node(n)) for n in env.cluster.nodes) == 4


def replace_with_cheaper_single_node(P, env):
    env.apply_defaults(pool_with(P, consolidate_after_s=60))
    pods = P.make_pods(20, "w", {"cpu": "3", "memory": "6Gi"})
    provision(env, pods)
    keep = {k.uid for k in env.cluster.pods_on_node(
        next(iter(env.cluster.nodes.values())).name)[:2]}
    for p in pods:
        if p.uid not in keep:
            env.cluster.delete(p)

    def price():
        return sum(env.catalog.pricing.on_demand_price(env.catalog.get(n.instance_type()))
                   for n in env.cluster.nodes.values())

    before = price()
    env.clock.advance(61)
    env.disruption.reconcile()
    step(env, 4)
    assert not env.cluster.pending_pods() and price() < before
    assert any("replace" in r or "delete" in r for r in reasons(env))


def do_not_disrupt_respected(P, env):
    env.apply_defaults(pool_with(P, max_cpu=17, consolidate_after_s=60))
    provision(env, P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"},
                               annotations={P.lbl.ANNOTATION_DO_NOT_DISRUPT: "true"}))
    env.clock.advance(61)
    env.disruption.reconcile()
    assert not any(c.deleted for c in env.cluster.nodeclaims.values())


# -- TestInterruption ----------------------------------------------------------

def _spot_claim(P, env):
    env.apply_defaults(pool_with(P))
    provision(env, P.make_pods(3, "w", {"cpu": "1", "memory": "2Gi"}))
    for claim in env.cluster.nodeclaims.values():
        if claim.labels.get(P.lbl.CAPACITY_TYPE) == "spot":
            return claim
    return next(iter(env.cluster.nodeclaims.values()))


def _send(env, claim, source, detail_type, **detail):
    iid = claim.status.provider_id.rsplit("/", 1)[-1]
    if detail_type == "AWS Health Event":
        detail = {"affectedEntities": [{"entityValue": iid}]}
    else:
        detail = dict(detail, **{"instance-id": iid})
    env.queue.send({"source": source, "detail-type": detail_type, "detail": detail})


def spot_interruption_drains_and_masks(P, env):
    claim = _spot_claim(P, env)
    _send(env, claim, "aws.ec2", "EC2 Spot Instance Interruption Warning")
    env.interruption.reconcile()
    assert claim.deleted and len(env.queue) == 0
    assert env.catalog.unavailable.is_unavailable(
        claim.labels[P.lbl.INSTANCE_TYPE_LABEL], claim.labels[P.lbl.TOPOLOGY_ZONE], "spot")


def rebalance_is_no_action(P, env):
    claim = _spot_claim(P, env)
    _send(env, claim, "aws.ec2", "EC2 Instance Rebalance Recommendation")
    env.interruption.reconcile()
    assert not claim.deleted and len(env.queue) == 0


def state_change_terminated_drains(P, env):
    claim = _spot_claim(P, env)
    _send(env, claim, "aws.ec2", "EC2 Instance State-change Notification",
          state="shutting-down")
    env.interruption.reconcile()
    assert claim.deleted


def health_event_drains(P, env):
    claim = _spot_claim(P, env)
    _send(env, claim, "aws.health", "AWS Health Event")
    env.interruption.reconcile()
    assert claim.deleted


def unparseable_message_deleted(P, env):
    env.apply_defaults(pool_with(P))
    env.queue.send({"source": "junk", "detail-type": "garbage"})
    env.queue.send("not even json {{{")
    env.interruption.reconcile()
    assert len(env.queue) == 0


def end_to_end_interruption_replacement(P, env):
    claim = _spot_claim(P, env)
    pods_on = env.cluster.pods_on_node(claim.status.node_name)
    _send(env, claim, "aws.ec2", "EC2 Spot Instance Interruption Warning")
    step(env, 5)
    assert not env.cluster.pending_pods()
    for p in pods_on:
        assert p.node_name and p.node_name != f"node-{claim.name}"


# -- TestRAID0Consolidation, the SpotToSpot gate --------------------------------

def cheaper_replacement_sees_raid0_ephemeral(P, env):
    nodeclass = P.NodeClass(name="default", role="node-role", instance_store_policy="RAID0")
    env.cluster.apply(nodeclass)
    pool = pool_with(P)
    pool.requirements = [P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN,
                                       ("c", "m", "r", "i", "d"))]
    env.cluster.apply(pool)
    env.nodeclass_status.reconcile()
    env.nodeclass_hash.reconcile()
    provision(env, P.make_pods(2, "scratch", {"cpu": "1", "memory": "2Gi",
                                               "ephemeral-storage": "150Gi"}))
    ct = P.consolidate.encode_cluster(env.cluster, env.catalog)
    pools = {pool.name: pool}
    blind = P.consolidate.cheaper_replacement(ct, env.catalog, nodepools=pools, margin=-10.0)
    aware = P.consolidate.cheaper_replacement(ct, env.catalog, nodepools=pools, margin=-10.0,
                                              nodeclass_by_pool={pool.name: nodeclass})
    assert not blind and aware
    env.scenario_result = [(int(i), t, round(float(p), 6), sorted(o)) for i, t, p, o in aware]


def _spot_gate(P, env, narrow: bool, spot_to_spot: bool):
    cands = [t for t in env.catalog.list() if t.category in ("c", "m", "r") and t.vcpus == 16]
    it = max(cands, key=lambda t: env.catalog.pricing.spot_price(t, "zone-a"))
    key = (P.lbl.INSTANCE_TYPE_LABEL, (it.name,)) if narrow else (
        P.lbl.INSTANCE_CATEGORY, ("c", "m", "r"))
    env.apply_defaults(P.NodePool(name="default",
                                  requirements=[P.Requirement(key[0], P.Operator.IN, key[1])],
                                  disruption=P.Disruption(consolidate_after_s=60)))
    cluster_cases.add_node(P, env.cluster, env.catalog, 0, it, "zone-a",
                           P.make_pods(2, "n-spot-p", {"cpu": "1", "memory": "2Gi"}),
                           name="n-spot")
    ct = P.consolidate.encode_cluster(env.cluster, env.catalog)
    out = P.consolidate.cheaper_replacement(ct, env.catalog,
                                            nodepools=dict(env.cluster.nodepools),
                                            spot_to_spot=spot_to_spot)
    spot = any(c == "spot" for _, _, _, offerings in out for _, c in offerings)
    env.scenario_result = [(int(i), t, round(float(p), 6), sorted(o)) for i, t, p, o in out]
    return out, spot


def gate_off_never_offers_spot(P, env):
    assert not _spot_gate(P, env, narrow=False, spot_to_spot=False)[1]


def gate_on_with_wide_flexibility_offers_spot(P, env):
    out, spot = _spot_gate(P, env, narrow=False, spot_to_spot=True)
    assert out and spot
    assert P.consolidate.MIN_TYPES_FOR_SPOT_TO_SPOT == 15


def gate_on_with_narrow_flexibility_stays_non_spot(P, env):
    assert not _spot_gate(P, env, narrow=True, spot_to_spot=True)[1]


SCENARIOS = [
    claim_delete_drains_and_terminates, drained_pods_reprovisioned,
    pending_pod_lands_on_existing_free_node, scheduler_respects_taints_and_labels,
    empty_node_deleted_after_consolidate_after, expired_claims_disrupted,
    static_drift_triggers_disruption, nodepool_template_drift_triggers_disruption,
    candidate_must_persist_before_commit, flapping_candidate_restarts_window,
    budget_caps_disruptions_per_pass, underutilized_nodes_consolidated,
    replace_with_cheaper_single_node, do_not_disrupt_respected,
    spot_interruption_drains_and_masks, rebalance_is_no_action,
    state_change_terminated_drains, health_event_drains, unparseable_message_deleted,
    end_to_end_interruption_replacement, cheaper_replacement_sees_raid0_ephemeral,
    gate_off_never_offers_spot, gate_on_with_wide_flexibility_offers_spot,
    gate_on_with_narrow_flexibility_stays_non_spot,
]


def observe_with_result(env) -> dict:
    """``observe_lifecycle`` plus what a scenario computed outside the
    environment's state (the replacement screens' rows)."""
    return dict(cluster_cases.observe_lifecycle(env), result=getattr(env, "scenario_result", None))


@pytest.mark.parametrize("lane", ["off", "on"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equals_reference(scenario, lane, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane == "on" else "0")
    assert_same(run_on_both(scenario, observe_with_result))


# -- TestDirtySweepContract's seeded churn ------------------------------------

def _churn(P, cl, names, rng, step_i):
    for _ in range(6):
        r = rng.rand()
        if r < 0.40:  # bind a new pod somewhere
            p = P.make_pods(1, f"dsc{step_i}", {"cpu": "250m", "memory": "512Mi"})[0]
            cl.apply(p)
            cl.bind_pod(p.uid, names[rng.randint(len(names))])
        elif r < 0.70:  # evict one bound pod
            bound = sorted((pp for pp in cl.pods.values() if pp.node_name),
                           key=lambda pp: pp.name)
            if bound:
                cl.unbind_pod(bound[rng.randint(len(bound))].uid)
        elif r < 0.85:  # drain a whole node (arms emptiness)
            nd = cl.nodes.get(names[rng.randint(len(names))])
            if nd is not None:
                for pp in list(cl.pods_on_node(nd.name)):
                    cl.unbind_pod(pp.uid)
        else:  # flip a do-not-disrupt annotation in place
            nd = cl.nodes.get(names[rng.randint(len(names))])
            if nd is not None:
                anns = dict(nd.annotations)
                cur = anns.get(P.lbl.ANNOTATION_DO_NOT_DISRUPT)
                anns[P.lbl.ANNOTATION_DO_NOT_DISRUPT] = "false" if cur == "true" else "true"
                nd.annotations = anns


def churn_run(root: str, mode: str, seed: int, steps: int = 6, n_nodes: int = 48):
    """The reference's ``_run_mode``: 48 config4 nodes of 1-3 pods, the
    default pool consolidating after 60 s, expiring after 500 s under a
    10% budget; 6 steps of seeded churn, each followed by 100 s and one
    disruption pass. Returns the per-pass decisions and the deleted claims,
    claims named by order of creation."""
    prev = os.environ.get("KARPENTER_TPU_DISRUPTION_DIRTY")
    os.environ["KARPENTER_TPU_DISRUPTION_DIRTY"] = mode
    P = package(root)
    env = P.new_environment()
    try:
        env.apply_defaults(P.NodePool(
            name="default",
            requirements=[P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN,
                                        ("c", "m", "r"))],
            disruption=P.Disruption(consolidate_after_s=None)))
        cluster_cases.synth_cluster(P, env.cluster, env.catalog, n_nodes=n_nodes, pods_per_node=3)
        cl = env.cluster
        pool = cl.nodepools["default"]
        pool.disruption.consolidation_policy = "WhenUnderutilized"
        pool.disruption.consolidate_after_s = 60.0
        pool.disruption.expire_after_s = 500.0
        pool.disruption.budgets = ["10%"]
        d = env.disruption
        ordinal = {name: f"c{i}" for i, name in enumerate(cl.nodeclaims)}

        def norm(name):
            if name not in ordinal:
                ordinal[name] = f"r{len(ordinal)}"
            return ordinal[name]

        rng = np.random.RandomState(seed)
        names = [n.name for n in cl.snapshot_nodes()]
        log = []
        for step_i in range(steps):
            _churn(P, cl, names, rng, step_i)
            env.clock.advance(100.0)
            before = len(d.disrupted)
            d.reconcile()
            for cname in cl.nodeclaims:
                norm(cname)
            log.append(tuple((norm(cn), reason) for cn, reason in d.disrupted[before:]))
        deleted = tuple(sorted(norm(c.name) for c in cl.nodeclaims.values() if c.deleted))
        return tuple(log), deleted
    finally:
        env.close()
        if prev is None:
            os.environ.pop("KARPENTER_TPU_DISRUPTION_DIRTY", None)
        else:
            os.environ["KARPENTER_TPU_DISRUPTION_DIRTY"] = prev


@pytest.mark.parametrize("seed", [3, 11, 42])
def test_dirty_sweep_churn_equals_reference(seed):
    """On each package the dirty-set walk decides as the full walk does, and
    the port's decisions are the reference's; seed 3 disrupts something."""
    runs = {(root, mode): churn_run(root, mode, seed)
            for root in PACKAGES for mode in ("1", "0")}
    for root in PACKAGES:
        assert runs[(root, "1")] == runs[(root, "0")], root
    assert runs[(PACKAGES[1], "1")] == runs[(PACKAGES[0], "1")]
    if seed == 3:
        log, deleted = runs[(PACKAGES[1], "1")]
        assert any(log) or deleted


def test_dirty_sweep_overflow_rebuilds():
    """The reference's ``test_overflow_rebuild_path`` on the port: rolling
    the change journal between passes forces a new ``_DirtyScan``, and a
    node drained empty inside the rolled window is still seen."""
    P = package(PACKAGES[1])
    env = P.new_environment()
    try:
        env.apply_defaults(P.NodePool(
            name="default",
            requirements=[P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN,
                                        ("c", "m", "r"))],
            disruption=P.Disruption(consolidate_after_s=None)))
        cluster_cases.synth_cluster(P, env.cluster, env.catalog, n_nodes=24, pods_per_node=2)
        cl = env.cluster
        pool = cl.nodepools["default"]
        pool.disruption.consolidation_policy = "WhenEmpty"
        pool.disruption.consolidate_after_s = 0.0
        d = env.disruption
        d.reconcile()
        ds0, rev0 = d._ds, cl.rev
        assert ds0 is not None
        victim = next(n.name for n in cl.snapshot_nodes() if cl.pods_on_node(n.name))
        empty_claim = next(c.name for c in cl.nodeclaims.values()
                           if c.status.node_name == victim)
        for pp in list(cl.pods_on_node(victim)):
            cl.unbind_pod(pp.uid)
        spin = P.make_pods(1, "ovf", {"cpu": "100m", "memory": "128Mi"})[0]
        cl.apply(spin)
        other = next(n.name for n in cl.snapshot_nodes() if n.name != victim)
        for _ in range(3000):
            cl.bind_pod(spin.uid, other)
            cl.unbind_pod(spin.uid)
        assert cl.changes_since(rev0) is None
        env.clock.advance(30.0)
        d.reconcile()
        assert d._ds is not ds0
        assert (empty_claim, "empty") in d.disrupted
    finally:
        env.close()


# -- the multi-replace chooser, config6_multi_replace_optimizer ---------------

def test_multi_replace_chooser_equals_reference():
    """``benchmarks/optimizer_bench.py``'s blocked-prefix family, seeds
    0-11: the optimizer's subset chooser against the prefix walk gives the
    reference's ratios on both packages (p95 0.3321), 12 of 12 committed by
    the optimizer and none by the prefix walk."""
    rows = []
    for root in PACKAGES:
        P = package(root)
        rows.append(cluster_cases.multi_replace_row(P, P.new_environment))
    want, got = rows
    assert got == want
    assert got["cost_vs_oracle_p95"] == 0.3321
    assert (got["committed_optimizer"], got["committed_prefix"]) == (12, 0)


# -- a config4 cluster carried across: provision, then disrupt -----------------

def _config4_pool(P):
    return P.NodePool(name="default",
                      requirements=[P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN,
                                                  ("c", "m", "r"))],
                      disruption=P.Disruption(consolidate_after_s=None))


@pytest.mark.parametrize("lane", ["off", "on"])
def test_config4_carried_provision_then_disrupt(lane, monkeypatch):
    """200 config4 nodes (``_synth_cluster``, RandomState(1)) built in the
    reference store and carried to the port by ``cluster_from_reference``,
    each claim then backed by a seeded instance and the termination
    finalizer (``seed_launched``). On each side: a burst of 100 pods of
    500m/1Gi, the provisioner's reconcile first, manager passes until
    nothing is pending; then the pool consolidates after 60 s under a 10%
    budget, the clock moves 120 s, one disruption pass, and manager passes
    until no pod is pending and no claim is deleting (termination drains,
    the binder and the provisioner re-place, disruption consolidates on).
    The same audit trail, disruptions, launches and placements."""
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane == "on" else "0")
    P = package(PACKAGES[0])
    ref = P.new_environment()
    ref.apply_defaults(_config4_pool(P))
    cluster_cases.synth_cluster(P, ref.cluster, ref.catalog, n_nodes=200, pods_per_node=8)
    T = package(PACKAGES[1])
    port = T.new_environment()
    port.apply_defaults(_config4_pool(T))
    cluster_from_reference({k: v for k, v in reference_snapshot(ref.cluster).items()
                            if k not in ("nodepools", "nodeclasses")}, cluster=port.cluster)
    cluster_cases.seed_launched(P, ref)
    cluster_cases.seed_launched(T, port)
    seen, disrupted = [], []
    for Q, env in ((P, ref), (T, port)):
        try:
            for p in Q.make_pods(100, "burst", {"cpu": "500m", "memory": "1Gi"}):
                env.cluster.apply(p)
            env.provisioning.reconcile()
            assert env.manager.errors == []
            cluster_cases.settle(env)
            pool = env.cluster.nodepools["default"]
            pool.disruption.consolidate_after_s = 60
            pool.disruption.budgets = ["10%"]
            env.clock.advance(120)
            env.disruption.reconcile()
            disrupted.append(len(env.disruption.disrupted))
            cluster_cases.settle(env)
            seen.append(cluster_cases.observe_lifecycle(env))
        finally:
            env.close()
    assert disrupted[0] == disrupted[1] > 0
    assert any(k == "placement" and d.startswith("bind:") for k, _, _, d in seen[0]["decisions"])
    assert any(d.startswith("accept:consolidatable") for k, _, _, d in seen[0]["decisions"])
    assert_same(dict(zip(PACKAGES, seen)))


# -- the screen's device --------------------------------------------------------

def test_cpu_environment_screens_with_the_plain_version():
    """A CPU environment's disruption pass screens on the CPU (the plain
    version, ``torch-plain``); the controller of a CUDA environment would
    screen through the repack kernel, and where there is no card, asking
    for one raises instead of screening on the CPU."""
    import torch

    from karpenter_provider_aws_tpu_torch.ops import consolidate

    T = package(PACKAGES[1])
    env = T.new_environment()
    try:
        env.apply_defaults(_config4_pool(T))
        cluster_cases.synth_cluster(T, env.cluster, env.catalog, n_nodes=40, pods_per_node=3)
        pool = env.cluster.nodepools["default"]
        pool.disruption.consolidate_after_s = 60
        env.clock.advance(120)
        consolidate.LAST_SCREEN.clear()
        env.disruption.reconcile()
        assert consolidate.LAST_SCREEN["backend"] == "torch-plain"
        assert env.disruption.disrupted
        if not torch.cuda.is_available():
            env.disruption.device = None
            for p in T.make_pods(3, "late", {"cpu": "250m", "memory": "512Mi"}):
                env.cluster.apply(p)
                env.cluster.bind_pod(p.uid, next(iter(env.cluster.nodes)))
            env.clock.advance(120)
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                env.disruption.reconcile()
    finally:
        env.close()


def test_interruption_handles_a_fake_queue_serially():
    """The fake queue is in memory (``blocking_io`` False): the controller
    keeps no worker pool for it and handles messages in order."""
    T = package(PACKAGES[1])
    env = T.new_environment()
    try:
        assert env.interruption._pool is None
    finally:
        env.close()
