"""The port's provisioning control plane against the JAX package's.

Each case runs one scenario of ``tests/test_controlplane.py`` (pending pods
to running nodes, nominated binds, no pool, a nodeclass that is not ready,
pool limits, ICE retry and the launch-time capacity-type filters, nodeclass
status and the drift hash) twice: on the reference's ``new_environment()``
(``TPUSolver`` through XLA on the CPU) and on the port's
``new_environment(device="cpu")`` (``TorchSolver`` on the plain PyTorch
FFD), with the same pods, lane off and lane on. It asserts the reference
test's own checks on the port and holds the two runs equal on:

- the multiset of launched (instance type, zone, capacity type);
- which pods share a node;
- ``cluster.pending_pods()``;
- the audit decisions, as (kind, subject kind, decision), with claim and
  node names replaced by their order of creation.

Launches run serially (``KARPENTER_TPU_SERIAL_LAUNCH=1``, the reference's
switch for deterministic harnesses): with the launch pool, thread
scheduling decides the order in which claims are named. Every step asserts
``env.manager.errors == []``.
"""

import re

import pytest

from karpenter_provider_aws_tpu_torch.ops import cluster_cases

PACKAGES = ("karpenter_provider_aws_tpu", "karpenter_provider_aws_tpu_torch")


def package(root: str):
    """The modules a scenario uses, from one package."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    testenv = mod("testenv")
    models = mod("models")
    cp = mod("cloudprovider.cloudprovider")
    port = root.endswith("_torch")
    P = cluster_cases.names(mod)
    P.__dict__.update(
        root=root,
        new_environment=(lambda: testenv.new_environment(device="cpu")) if port
        else testenv.new_environment,
        Limits=models.Limits, NodeClass=mod("models.nodeclass").NodeClass,
        SelectorTerm=mod("models.nodeclass").SelectorTerm,
        launch_claim=mod("controllers.provisioning").launch_claim,
        NodeSpec=mod("scheduling.solver").NodeSpec,
        DriftReason=cp.DriftReason, Budget=models.Budget, Taint=models.Taint,
        LaunchRequest=mod("fake").LaunchRequest,
    )
    return P


@pytest.fixture(autouse=True)
def _deterministic(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_SERIAL_LAUNCH", "1")
    for var in ("KARPENTER_TPU_OPTIMIZER_SEED", "KARPENTER_TPU_OPTIMIZER_LANES",
                "KARPENTER_TPU_MARKET", "KARPENTER_TPU_WHY"):
        monkeypatch.delenv(var, raising=False)


def step(env, n=1):
    for _ in range(n):
        env.step()
        assert env.manager.errors == [], env.manager.errors


def cmr_pool(P):
    return P.NodePool(
        name="default",
        requirements=[P.Requirement(P.lbl.INSTANCE_CATEGORY, P.Operator.IN, ("c", "m", "r"))],
        disruption=P.Disruption(consolidate_after_s=None),
    )


def observe(env) -> dict:
    """What the two packages' runs are held equal on."""
    names = {c: f"claim{i}" for i, c in enumerate(env.cluster.nodeclaims)}  # store order
    pattern = re.compile("|".join(re.escape(c) for c in sorted(names, key=len, reverse=True))) \
        if names else None

    def norm(s: str) -> str:
        return pattern.sub(lambda m: names[m.group(0)], s) if pattern else s

    by_node: dict = {}
    for pod in env.cluster.pods.values():
        if pod.node_name:
            by_node.setdefault(pod.node_name, []).append(pod.name)
    return {
        "launched": sorted((i.instance_type, i.zone, i.capacity_type)
                           for i in env.cloud.instances.values()),
        "pods_by_node": sorted(sorted(v) for v in by_node.values()),
        "pending": sorted(p.name for p in env.cluster.pending_pods()),
        "decisions": [(r.kind, r.subject_kind, norm(r.decision))
                      for r in env.obs.audit.tail(100_000)],
    }


def run_on_both(scenario, observe_fn=None) -> dict:
    """``scenario(P, env)`` on a fresh environment of each package; the
    observations by package."""
    seen = {}
    for root in PACKAGES:
        P = package(root)
        env = P.new_environment()
        try:
            scenario(P, env)
            seen[root] = (observe_fn or cluster_cases.observe_lifecycle)(env)
        finally:
            env.close()
    return seen


def assert_same(seen: dict) -> None:
    want, got = seen[PACKAGES[0]], seen[PACKAGES[1]]
    for key in want:
        assert got[key] == want[key], key


# -- the scenarios: each takes (P, env), asserts the reference test's checks ---

def pending_pods_become_running_nodes(P, env):
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(40, "web", {"cpu": "500m", "memory": "1Gi"}):
        env.cluster.apply(p)
    step(env, 2)
    assert not env.cluster.pending_pods()
    assert len(env.cluster.nodes) >= 1
    for node in env.cluster.nodes.values():
        assert node.ready
        assert node.labels[P.lbl.NODEPOOL] == "default"
        assert node.labels[P.lbl.INSTANCE_TYPE_LABEL]
    for claim in env.cluster.nodeclaims.values():
        inst = env.cloudprovider.get(claim.status.provider_id)
        assert inst.state == "running"
        assert inst.tags[P.MANAGED_TAG] == "true"


def pods_bound_to_their_nominated_nodes(P, env):
    env.apply_defaults(cmr_pool(P))
    pods = P.make_pods(10, "w", {"cpu": "1", "memory": "2Gi"})
    for p in pods:
        env.cluster.apply(p)
    step(env, 2)
    for p in pods:
        assert env.cluster.pods[p.uid].node_name != ""


def no_nodepool_no_nodes(P, env):
    for p in P.make_pods(3, "w", {"cpu": "1"}):
        env.cluster.apply(p)
    step(env, 2)
    assert len(env.cluster.nodes) == 0


def not_ready_nodeclass_blocks_launch(P, env):
    nodeclass = P.NodeClass(name="default", role="r",
                            subnet_selector=[P.SelectorTerm.of(id="subnet-does-not-exist")])
    env.cluster.apply(nodeclass)
    env.cluster.apply(cmr_pool(P))
    env.nodeclass_status.reconcile()
    assert not env.cluster.nodeclasses["default"].status.is_ready()
    for p in P.make_pods(2, "w", {"cpu": "1"}):
        env.cluster.apply(p)
    step(env, 2)
    assert len(env.cluster.nodes) == 0
    assert env.cluster.pending_pods()


def pool_limits_respected_with_existing_capacity(P, env):
    pool = cmr_pool(P)
    pool.limits = P.Limits.of(cpu=200)
    env.apply_defaults(pool)
    for p in P.make_pods(50, "w", {"cpu": "2", "memory": "2Gi"}):
        env.cluster.apply(p)
    step(env, 3)
    total = sum(env.catalog.get(n.instance_type()).vcpus for n in env.cluster.nodes.values())
    assert total <= 200


def ice_launch_retries_alternative(P, env):
    env.apply_defaults(cmr_pool(P))
    pods = P.make_pods(5, "w", {"cpu": "2", "memory": "4Gi"})
    for p in pods:
        env.cluster.apply(p)
    result = env.solver.solve(pods, [env.cluster.nodepools["default"]], env.catalog)
    first_choice = result.node_specs[0].instance_type_options[0]
    for z in env.catalog.zones:
        for ct in P.lbl.CAPACITY_TYPES:
            env.cloud.ice_pools.add((ct, first_choice, z))
    step(env, 3)
    assert not env.cluster.pending_pods()
    assert first_choice not in {n.instance_type() for n in env.cluster.nodes.values()}


def mixed_captype_launch_filters_unwanted_spot(P, env):
    pool, _ = env.apply_defaults(cmr_pool(P))
    small, big = "c5.large", "m5.24xlarge"
    env.catalog.pricing.update_spot(
        {(big, z): env.catalog.pricing.on_demand_price(env.catalog.get(small)) * 3
         for z in env.catalog.zones})
    spec = P.NodeSpec(nodepool_name=pool.name, instance_type_options=[small, big],
                      zone_options=["zone-a"], capacity_type_options=["spot", "on-demand"],
                      offering_options=[("zone-a", "spot"), ("zone-a", "on-demand")])
    claim = P.launch_claim(env.cluster, env.cloudprovider, pool, spec)
    assert claim is not None and claim.is_launched()
    sent = {t for r in env.cloud.calls["create_fleet"][-1] for t in r.instance_type_options}
    assert big not in sent and small in sent
    spec2 = P.NodeSpec(nodepool_name=pool.name, instance_type_options=[big],
                       zone_options=["zone-a"], capacity_type_options=["spot"],
                       offering_options=[("zone-a", "spot")])
    claim2 = P.launch_claim(env.cluster, env.cloudprovider, pool, spec2)
    assert claim2 is not None and claim2.is_launched()
    assert {t for r in env.cloud.calls["create_fleet"][-1]
            for t in r.instance_type_options} == {big}


def spot_filter_ignores_unattainable_od_floor(P, env):
    pool, _ = env.apply_defaults(cmr_pool(P))
    cheap, other = "c5.large", "m5.large"
    for z in env.catalog.zones:
        env.catalog.unavailable.mark_unavailable(cheap, z, "on-demand")
    od_cheap = env.catalog.pricing.on_demand_price(env.catalog.get(cheap))
    env.catalog.pricing.update_spot(
        {(cheap, z): od_cheap * 5 for z in env.catalog.zones}
        | {(other, z): od_cheap * 1.5 for z in env.catalog.zones})
    spec = P.NodeSpec(nodepool_name=pool.name, instance_type_options=[cheap, other],
                      zone_options=["zone-a"], capacity_type_options=["spot", "on-demand"],
                      offering_options=[("zone-a", "spot"), ("zone-a", "on-demand")])
    claim = P.launch_claim(env.cluster, env.cloudprovider, pool, spec)
    assert claim is not None and claim.is_launched()
    assert other in {t for r in env.cloud.calls["create_fleet"][-1]
                     for t in r.instance_type_options}


def spot_filter_recomputes_offerings_and_gates_fallback(P, env):
    pool, _ = env.apply_defaults(cmr_pool(P))
    cheap, pricey = "c5.large", "m5.24xlarge"
    env.catalog.pricing.update_spot(
        {(pricey, z): env.catalog.pricing.on_demand_price(env.catalog.get(cheap)) * 3
         for z in env.catalog.zones})
    for z in env.catalog.zones:
        env.catalog.unavailable.mark_unavailable(cheap, z, "spot")
    spec = P.NodeSpec(nodepool_name=pool.name, instance_type_options=[cheap, pricey],
                      zone_options=["zone-a"], capacity_type_options=["spot", "on-demand"],
                      offering_options=[("zone-a", "spot"), ("zone-a", "on-demand")])
    assert P.launch_claim(env.cluster, env.cloudprovider, pool, spec) is None
    assert not env.cloud.calls.get("create_fleet")


def od_fallback_requires_type_flexibility(P, env):
    pool, _ = env.apply_defaults(cmr_pool(P))
    narrow = ["c5.large", "c5.xlarge"]
    wide = ["c5.large", "c5.xlarge", "c5.2xlarge", "m5.large", "m5.xlarge", "r5.large"]
    for t in sorted(set(narrow + wide)):
        for z in env.catalog.zones:
            env.catalog.unavailable.mark_unavailable(t, z, "spot")

    def spec_for(names):
        return P.NodeSpec(nodepool_name=pool.name, instance_type_options=list(names),
                          zone_options=["zone-a"], capacity_type_options=["spot", "on-demand"],
                          offering_options=[("zone-a", "spot"), ("zone-a", "on-demand")])

    assert P.launch_claim(env.cluster, env.cloudprovider, pool, spec_for(narrow)) is None
    claim = P.launch_claim(env.cluster, env.cloudprovider, pool, spec_for(wide))
    assert claim is not None and claim.is_launched()
    assert claim.labels[P.lbl.CAPACITY_TYPE] == "on-demand"


def fleet_ice_populates_unavailable_cache(P, env):
    env.apply_defaults(cmr_pool(P))
    pods = P.make_pods(3, "w", {"cpu": "1", "memory": "2Gi"})
    for p in pods:
        env.cluster.apply(p)
    result = env.solver.solve(pods, [env.cluster.nodepools["default"]], env.catalog)
    spec = result.node_specs[0]
    for t in spec.instance_type_options:
        for z in env.catalog.zones:
            for ct in P.lbl.CAPACITY_TYPES:
                env.cloud.ice_pools.add((ct, t, z))
    env.provisioning.reconcile()
    assert env.catalog.unavailable.entries(), "ICE not recorded"
    assert all(not c.deleted for c in env.cluster.nodeclaims.values())


def nodeclass_status_resolution(P, env):
    env.apply_defaults()
    nc = env.cluster.nodeclasses["default"]
    assert nc.status.is_ready()
    assert nc.status.subnets and nc.status.security_groups and nc.status.images
    assert nc.status.instance_profile == "cluster-1-default"
    assert env.cloud.instance_profiles.get("cluster-1-default")


def nodeclass_image_selector_terms(P, env):
    env.cluster.apply(P.NodeClass(name="custom", role="r",
                                  image_selector=[P.SelectorTerm.of(name="gpu-v1")]))
    env.nodeclass_status.reconcile()
    assert [i.id for i in env.cluster.nodeclasses["custom"].status.images] == ["img-gpu-1"]


def _provision_one(P, env):
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"}):
        env.cluster.apply(p)
    step(env, 2)
    return next(iter(env.cluster.nodeclaims.values()))


def drift_hash(P, env):
    """The nodeclass hash controller stamps the hash a launch carries; no
    drift at first, then static drift once the nodeclass spec changes, and
    image and security-group drift from the instance."""
    claim = _provision_one(P, env)
    nc = env.cluster.nodeclasses["default"]
    assert nc.status.conditions["hash"].reason == nc.hash()
    assert claim.annotations[P.lbl.ANNOTATION_NODECLASS_HASH] == nc.hash()
    assert env.cloudprovider.is_drifted(claim) == P.DriftReason.NONE
    inst = env.cloudprovider.get(claim.status.provider_id)
    image, groups = inst.image_id, inst.security_group_ids
    inst.image_id = "img-removed"
    assert env.cloudprovider.is_drifted(claim) == P.DriftReason.IMAGE
    inst.image_id, inst.security_group_ids = image, ("sg-gone",)
    assert env.cloudprovider.is_drifted(claim) == P.DriftReason.SECURITY_GROUP
    inst.security_group_ids = groups
    nc.user_data = "#!/bin/bash echo changed"
    assert env.cloudprovider.is_drifted(claim) == P.DriftReason.STATIC


def fragmented_burst(P, env):
    """Frag seed 0 (the reference's ``config6_frag_optimizer`` family) as a
    burst of pending pods: the first pass launches its plan, and with the
    lane on, the lane's plan is adopted, as in a direct solve."""
    import os

    from karpenter_provider_aws_tpu_torch.ops.solve_cases import frag_workload

    env.apply_defaults(cmr_pool(P))
    for p in frag_workload(P, 0):
        env.cluster.apply(p)
    step(env)
    lane = env.solver.timings.get("opt_lane")
    if os.environ["KARPENTER_TPU_OPTIMIZER"] == "1":
        assert lane == "adopted"
    else:
        assert lane in (None, "disabled")
    step(env, 2)
    assert not env.cluster.pending_pods()


SCENARIOS = [pending_pods_become_running_nodes, pods_bound_to_their_nominated_nodes,
             no_nodepool_no_nodes, not_ready_nodeclass_blocks_launch,
             pool_limits_respected_with_existing_capacity, ice_launch_retries_alternative,
             mixed_captype_launch_filters_unwanted_spot,
             spot_filter_ignores_unattainable_od_floor,
             spot_filter_recomputes_offerings_and_gates_fallback,
             od_fallback_requires_type_flexibility, fleet_ice_populates_unavailable_cache,
             nodeclass_status_resolution, nodeclass_image_selector_terms, drift_hash,
             fragmented_burst]


# -- garbage collection, liveness, tagging, nodeclass termination ------------

def orphan_reaped_after_grace(P, env):
    env.apply_defaults(cmr_pool(P))
    inst = env.cloud.create_fleet([P.LaunchRequest(
        instance_type_options=["c5.large"], offering_options=[("zone-a", "on-demand")],
        image_id="img-std-2", tags={P.MANAGED_TAG: "true"})])[0]
    env.garbagecollection.reconcile()
    assert env.cloud.instances[inst.id].state == "running"  # inside grace
    env.clock.advance(31)
    env.garbagecollection.reconcile()
    assert env.cloud.instances[inst.id].state == "terminated"
    assert env.garbagecollection.reaped == [inst.id]


def claimed_instance_not_reaped(P, env):
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(5, "w", {"cpu": "1", "memory": "2Gi"}):
        env.cluster.apply(p)
    step(env, 2)
    env.clock.advance(3600)
    env.garbagecollection.reconcile()
    for claim in env.cluster.nodeclaims.values():
        assert env.cloudprovider.get(claim.status.provider_id).state == "running"


def unregistered_claim_reaped_after_ttl(P, env):
    pool, _ = env.apply_defaults(cmr_pool(P))
    spec = P.NodeSpec(nodepool_name=pool.name, instance_type_options=["c5.large"],
                      zone_options=["zone-a"], capacity_type_options=["on-demand"],
                      offering_options=[("zone-a", "on-demand")])
    claim = P.launch_claim(env.cluster, env.cloudprovider, pool, spec)
    assert claim is not None and claim.is_launched()
    env.liveness.reconcile()  # the registration controller is not run
    assert not claim.deleted
    env.clock.advance(15 * 60 + 1)
    env.liveness.reconcile()
    assert claim.deleted and claim.name in env.liveness.reaped
    evs = env.events.events(kind="NodeClaim", reason="FailedRegistration")
    assert evs and claim.name == evs[0].name
    step(env, 2)
    inst = env.cloud.instances[claim.status.provider_id.rsplit("/", 1)[-1]]
    assert inst.state == "terminated"


def registered_claim_untouched(P, env):
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"}):
        env.cluster.apply(p)
    step(env, 2)
    env.clock.advance(16 * 60)
    env.liveness.reconcile()
    assert env.liveness.reaped == []
    assert all(not c.deleted for c in env.cluster.nodeclaims.values())


def instances_tagged_once_registered(P, env):
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(3, "w", {"cpu": "1", "memory": "2Gi"}):
        env.cluster.apply(p)
    step(env, 2)
    for claim in env.cluster.nodeclaims.values():
        inst = env.cloudprovider.get(claim.status.provider_id)
        assert inst.tags.get("Name") == claim.status.node_name
        assert claim.annotations[P.lbl.ANNOTATION_INSTANCE_TAGGED] == "true"
    calls = len(env.cloud.calls.get("tag_instance", []))
    env.tagging.reconcile()  # a second pass is a no-op
    assert len(env.cloud.calls.get("tag_instance", [])) == calls


def termination_blocked_by_claims_then_completes(P, env):
    env.apply_defaults(cmr_pool(P))
    for p in P.make_pods(2, "w", {"cpu": "1", "memory": "2Gi"}):
        env.cluster.apply(p)
    step(env, 2)
    env.cluster.delete(env.cluster.nodeclasses["default"])
    env.nodeclass_termination.reconcile()
    assert "default" in env.cluster.nodeclasses  # blocked by claims
    for claim in list(env.cluster.nodeclaims.values()):
        env.cluster.finalize(claim)
    env.nodeclass_termination.reconcile()
    assert "default" not in env.cluster.nodeclasses
    assert "cluster-1-default" not in env.cloud.instance_profiles


LIFECYCLE = [orphan_reaped_after_grace, claimed_instance_not_reaped,
             unregistered_claim_reaped_after_ttl, registered_claim_untouched,
             instances_tagged_once_registered, termination_blocked_by_claims_then_completes]


@pytest.mark.parametrize("lane", ["off", "on"])
@pytest.mark.parametrize("scenario", LIFECYCLE, ids=lambda f: f.__name__)
def test_lifecycle_scenario_equals_reference(scenario, lane, monkeypatch):
    """The reference's ``TestGC``, ``TestLiveness``, ``TestTagging`` and
    nodeclass termination, run through the environment's controllers on
    both packages: the reference test's checks on each, and the runs equal
    with claim and instance names in order of creation."""
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane == "on" else "0")
    assert_same(run_on_both(scenario))


@pytest.mark.parametrize("lane", ["off", "on"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_equals_reference(scenario, lane, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane == "on" else "0")
    seen = {}
    for root in PACKAGES:
        P = package(root)
        env = P.new_environment()
        try:
            scenario(P, env)
            seen[root] = observe(env)
        finally:
            env.close()
    want, got = seen[PACKAGES[0]], seen[PACKAGES[1]]
    for key in want:
        assert got[key] == want[key], key


def test_new_environment_defaults_to_the_card():
    """``new_environment()`` builds ``TorchSolver()``, which is CUDA: it
    raises where no card is present instead of solving on the CPU."""
    import torch

    from karpenter_provider_aws_tpu_torch.testenv import new_environment

    if torch.cuda.is_available():
        env = new_environment()
        assert env.solver.device.type == "cuda"
        env.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            new_environment()


def test_uncarried_controllers_raise():
    """Every controller of the reference's environment is carried, in the
    reference's order; the replica set is not, and asking for it raises."""
    from karpenter_provider_aws_tpu_torch import testenv

    env = testenv.new_environment(device="cpu")
    try:
        for name in ("provisioning", "scheduling", "registration", "termination",
                     "disruption", "interruption", "garbagecollection", "liveness",
                     "tagging", "nodeclass_hash", "nodeclass_status",
                     "nodeclass_termination"):
            assert getattr(env, name).reconcile
        health = env.manager.health()
        assert list(health["controllers"]) == [
            "nodeclass-status", "nodeclass-hash", "interruption", "termination",
            "registration", "scheduling", "provisioning", "tagging", "disruption",
            "garbagecollection", "liveness", "nodeclass-termination"]
        assert "breakers" not in health
        assert env.disruption.device == env.solver.device
    finally:
        env.close()
    with pytest.raises(NotImplementedError, match="replica set"):
        testenv.new_replicaset(2)


def test_gang_bound_and_partition_are_refused():
    from karpenter_provider_aws_tpu_torch.scheduling import HostSolver, TorchSolver
    from karpenter_provider_aws_tpu_torch.scheduling.solver import snapshot_existing_capacity
    from karpenter_provider_aws_tpu_torch.state.cluster import Cluster
    from karpenter_provider_aws_tpu_torch.utils.observability import Profiler

    for solver in (TorchSolver(device="cpu"), HostSolver()):
        with pytest.raises(NotImplementedError, match="gang"):
            solver.solve([], [], None, gang_bound={"g": 1})
    with pytest.raises(NotImplementedError, match="partition"):
        snapshot_existing_capacity(Cluster(), partition=("default", "zone-a"))
    assert Cluster().partition_keys() == []  # the router is carried
    from karpenter_provider_aws_tpu_torch import parallel

    with pytest.raises(NotImplementedError, match="partition"):
        parallel.solve_sharded()
    with pytest.raises(NotImplementedError, match="profile"):
        Profiler(profile_dir="/nonexistent")


def test_plain_counters_ride_the_metric_series():
    """The lane outcomes, the incremental encode's outcomes and the device
    mirror's acquires count on the reference's metric series as well as in
    the plain module counters the tests read."""
    from karpenter_provider_aws_tpu_torch.metrics import (
        DEVICE_STATE, DEVICE_STATE_BYTES, ENCODE_CACHE, OPTIMIZER_LANE,
    )
    from karpenter_provider_aws_tpu_torch.ops import device_state, encode_delta
    from karpenter_provider_aws_tpu_torch.scheduling import optimizer

    before = (OPTIMIZER_LANE.value(outcome="adopted"),
              ENCODE_CACHE.value(path="cluster", outcome="patch"),
              DEVICE_STATE.value(path="screen", outcome="upload"),
              DEVICE_STATE_BYTES.value(kind="upload"))
    lanes, encodes, acquires = (dict(optimizer.OUTCOMES), dict(encode_delta.ENCODE_COUNTS),
                                dict(device_state.COUNTS))
    optimizer.count_outcome("adopted")
    encode_delta._count("patch", dirty=3)
    device_state._count("upload")
    device_state._count("upload_bytes", 64)
    after = (OPTIMIZER_LANE.value(outcome="adopted"),
             ENCODE_CACHE.value(path="cluster", outcome="patch"),
             DEVICE_STATE.value(path="screen", outcome="upload"),
             DEVICE_STATE_BYTES.value(kind="upload"))
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 64]
    assert optimizer.OUTCOMES["adopted"] == lanes.get("adopted", 0) + 1
    assert encode_delta.ENCODE_COUNTS["patch_rows"] == encodes["patch_rows"] + 3
    assert device_state.COUNTS["upload_bytes"] == acquires["upload_bytes"] + 64
