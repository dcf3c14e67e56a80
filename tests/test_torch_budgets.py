"""Disruption budgets and do-not-disrupt on the port, against the JAX package.

The scenarios of ``tests/test_budgets.py``'s ``TestReasonScopedBudgets``
(a zero budget scoped to one reason, a budget that blocks inside a cron
window) and ``TestDoNotDisrupt`` (a pod annotation blocking expiration, a
claim annotation blocking consolidation) run on the reference's
``new_environment()`` and the port's ``new_environment(device="cpu")``,
lane off and lane on: the reference test's checks on the port, and the two
runs equal as ``tests/test_torch_disruption.py`` holds them. Then the
per-pass allowance (``_BudgetTracker``) on one cluster with draining
claims, for several budget lists, reasons and times: the same caps on both
packages.
"""

import pytest

from test_torch_controlplane import PACKAGES, assert_same, package, run_on_both, step

from karpenter_provider_aws_tpu_torch.ops import cluster_cases


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_SERIAL_LAUNCH", "1")
    for var in ("KARPENTER_TPU_OPTIMIZER_SEED", "KARPENTER_TPU_OPTIMIZER_LANES",
                "KARPENTER_TPU_MARKET", "KARPENTER_TPU_WHY", "KARPENTER_TPU_OPTIMIZER",
                "KARPENTER_TPU_DISRUPTION_DIRTY"):
        monkeypatch.delenv(var, raising=False)


def pool_with(P, **kw):
    return P.NodePool(name="default",
                      requirements=[P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN,
                                                  ("c", "m"))],
                      disruption=P.Disruption(**kw))


def provision(env, pods):
    for p in pods:
        env.cluster.apply(p)
    step(env, 3)
    assert not env.cluster.pending_pods()


def zero_budget_blocks_only_its_reason(P, env):
    env.apply_defaults(pool_with(P, expire_after_s=60, consolidate_after_s=10,
                                 budgets=[P.Budget(nodes="0", reasons=("Expired",)), "100%"]))
    provision(env, P.make_pods(4, "w", {"cpu": "1", "memory": "2Gi"}))
    for p in list(env.cluster.pods.values()):
        env.cluster.delete(p)
    env.clock.advance(61)
    env.disruption.reconcile()
    reasons = {r for _, r in env.disruption.disrupted}
    assert reasons and all(r == "empty" for r in reasons), reasons


def schedule_gated_blocking_budget(P, env):
    env.apply_defaults(pool_with(P, expire_after_s=60, consolidate_after_s=None,
                                 budgets=[P.Budget(nodes="0", schedule="0 2 * * *",
                                                   duration_s=3600), "100%"]))
    provision(env, P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"}))
    env.clock.advance(2 * 3600 + 20 * 60)  # 02:20, inside the window
    env.disruption.reconcile()
    assert not env.disruption.disrupted
    env.clock.advance(3600)  # 03:20: the window closed
    env.disruption.reconcile()
    assert env.disruption.disrupted


def pod_annotation_blocks_expiration(P, env):
    env.apply_defaults(pool_with(P, expire_after_s=60, consolidate_after_s=None,
                                 budgets=["100%"]))
    provision(env, P.make_pods(2, "pin", {"cpu": "1", "memory": "2Gi"},
                               annotations={P.lbl.ANNOTATION_DO_NOT_DISRUPT: "true"}))
    env.clock.advance(61)
    env.disruption.reconcile()
    assert not env.disruption.disrupted
    for p in list(env.cluster.pods.values()):
        env.cluster.delete(p)
    env.disruption.reconcile()
    assert env.disruption.disrupted


def claim_annotation_blocks_consolidation(P, env):
    env.apply_defaults(pool_with(P, consolidate_after_s=10, budgets=["100%"]))
    provision(env, P.make_pods(6, "w", {"cpu": "1", "memory": "2Gi"}))
    for claim in env.cluster.nodeclaims.values():
        claim.annotations[P.lbl.ANNOTATION_DO_NOT_DISRUPT] = "true"
    for p in list(env.cluster.pods.values())[2:]:
        env.cluster.delete(p)
    env.clock.advance(61)
    env.disruption.reconcile()
    assert not env.disruption.disrupted


SCENARIOS = [zero_budget_blocks_only_its_reason, schedule_gated_blocking_budget,
             pod_annotation_blocks_expiration, claim_annotation_blocks_consolidation]


@pytest.mark.parametrize("lane", ["off", "on"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_budget_scenario_equals_reference(scenario, lane, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane == "on" else "0")
    assert_same(run_on_both(scenario))


BUDGETS = {
    "percent": ["10%"],
    "count": ["3"],
    "reason_scoped": [("0", ("Expired",)), "50%"],
    "scheduled": [("1", None, "0 2 * * *", 3600), "100%"],
}


def _budgets(P, spec):
    out = []
    for b in spec:
        if isinstance(b, str):
            out.append(b)
        elif len(b) == 2:
            out.append(P.Budget(nodes=b[0], reasons=b[1]))
        else:
            out.append(P.Budget(nodes=b[0], schedule=b[2], duration_s=b[3]))
    return out


@pytest.mark.parametrize("budgets", list(BUDGETS), ids=str)
def test_budget_tracker_equals_reference(budgets):
    """40 config4 nodes, 2 of their claims draining: the allowance left for
    every reason class at 00:30 and at 02:30, and after 3 consumes, equal on
    both packages."""
    import importlib

    seen = []
    for root in PACKAGES:
        P = package(root)
        tracker = importlib.import_module(f"{root}.controllers.disruption")._BudgetTracker
        env = P.new_environment()
        try:
            env.apply_defaults(P.NodePool(
                name="default",
                requirements=[P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN, ("c", "m"))],
                disruption=P.Disruption(consolidate_after_s=None,
                                        budgets=_budgets(P, BUDGETS[budgets]))))
            cluster_cases.synth_cluster(P, env.cluster, env.catalog, n_nodes=40, pods_per_node=3)
            for claim in list(env.cluster.nodeclaims.values())[:2]:
                claim.finalizers.add("karpenter.sh/termination")
                env.cluster.delete(claim)
            out = []
            for t in (1800.0, 9000.0):
                tr = tracker(env.cluster, t)
                for rclass in ("Expired", "Drifted", "Empty", "Underutilized", ""):
                    out.append((t, rclass, tr.left("default", rclass)))
                out.append([tr.consume("default", "Empty") for _ in range(3)])
                out.append(tr.left("default", "Underutilized"))
            seen.append(out)
        finally:
            env.close()
    assert seen[1] == seen[0]
