"""The event recorder (``events.py``) copied into the port, held to the
reference's own cases (``tests/test_events.py``: publish and query, the
dedupe window, the capacity bound, the idle sweep, and the launch and
unschedulable events the provisioning controller publishes), each case
once per package. The controller cases run the port's environment on the
CPU (``new_environment(device="cpu")``)."""

import importlib

import pytest

PACKAGES = ("karpenter_provider_aws_tpu", "karpenter_provider_aws_tpu_torch")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    root = request.param

    class P:
        events = importlib.import_module(f"{root}.events")
        clock = importlib.import_module(f"{root}.utils.clock")
        models = importlib.import_module(f"{root}.models")
        pod = importlib.import_module(f"{root}.models.pod")
        testenv = importlib.import_module(f"{root}.testenv")

        @staticmethod
        def recorder(**kw):
            return P.events.EventRecorder(clock=kw.pop("clock", None) or P.clock.FakeClock(), **kw)

        @staticmethod
        def env():
            if root.endswith("_torch"):
                return P.testenv.new_environment(device="cpu")
            return P.testenv.new_environment()

    return P


def test_publish_and_query(pkg):
    r = pkg.recorder()
    assert r.publish("NodeClaim", "c1", "Launched", "m5.large in zone-a")
    assert r.publish("Pod", "p1", "FailedScheduling", "no fit", type=pkg.events.WARNING)
    assert len(r.events()) == 2
    assert r.events(kind="Pod")[0].type == pkg.events.WARNING
    assert r.events(reason="Launched")[0].name == "c1"


def test_dedupe_window_counts(pkg):
    clock = pkg.clock.FakeClock()
    r = pkg.recorder(clock=clock, dedupe_ttl_s=60)
    assert r.publish("Pod", "p1", "FailedScheduling", "no fit")
    assert not r.publish("Pod", "p1", "FailedScheduling", "no fit")
    assert not r.publish("Pod", "p1", "FailedScheduling", "no fit")
    evs = r.events(kind="Pod")
    assert len(evs) == 1 and evs[0].count == 3
    clock.advance(61)
    assert r.publish("Pod", "p1", "FailedScheduling", "no fit")


def test_capacity_bound(pkg):
    r = pkg.recorder(capacity=10)
    for i in range(50):
        r.publish("Pod", f"p{i}", "X", "y")
    assert len(r.events()) == 10


def test_query_filters_match_events(pkg):
    r = pkg.recorder()
    r.publish("NodeClaim", "c1", "Launched", "m5.large")
    r.publish("NodeClaim", "c1", "Disrupted", "empty")
    r.publish("Pod", "p1", "FailedScheduling", "no fit", type=pkg.events.WARNING)
    assert len(r.query(kind="NodeClaim", name="c1")) == 2
    assert r.query(kind="NodeClaim", name="c1", reason="Launched")[0].message == "m5.large"
    assert r.query(kind="Pod") == r.events(kind="Pod")
    assert r.query(name="nope") == []


def test_sweep_drops_expired_entries_without_new_events(pkg):
    clock = pkg.clock.FakeClock()
    r = pkg.recorder(clock=clock, dedupe_ttl_s=60)
    for i in range(50):
        r.publish("NodeClaim", f"c{i}", "Launched", "x")
    assert len(r._last) == 50
    clock.advance(61)
    assert r.sweep() == 50
    assert len(r._last) == 0 and len(r.events()) == 50


def test_sweep_preserves_dedupe_counts_on_ring_events(pkg):
    clock = pkg.clock.FakeClock()
    r = pkg.recorder(clock=clock, dedupe_ttl_s=60)
    for _ in range(5):
        r.publish("Pod", "p1", "FailedScheduling", "no fit")
    clock.advance(61)
    r.sweep()
    assert r.events(name="p1")[0].count == 5


def test_sweep_keeps_fresh_entries(pkg):
    clock = pkg.clock.FakeClock()
    r = pkg.recorder(clock=clock, dedupe_ttl_s=60)
    r.publish("Pod", "old", "R", "m")
    clock.advance(40)
    r.publish("Pod", "new", "R", "m")
    clock.advance(30)
    assert r.sweep() == 1
    assert ("Pod", "new", "R", "m") in r._last
    assert not r.publish("Pod", "new", "R", "m")


def _cm_pool(pkg):
    m = pkg.models
    return m.NodePool(name="default", requirements=[
        m.Requirement(m.labels.INSTANCE_CATEGORY, m.Operator.IN, ("c", "m"))])


def test_launch_publishes(pkg):
    env = pkg.env()
    env.apply_defaults(_cm_pool(pkg))
    for p in pkg.pod.make_pods(4, "w", {"cpu": "1", "memory": "1Gi"}):
        env.cluster.apply(p)
    for _ in range(2):
        env.step()
        assert env.manager.errors == []
    assert env.events.events(kind="NodeClaim", reason="Launched")
    env.close()


def test_unschedulable_publishes_warning(pkg):
    env = pkg.env()
    env.apply_defaults(_cm_pool(pkg))
    for p in pkg.pod.make_pods(1, "huge", {"cpu": "10000", "memory": "1Gi"}):
        env.cluster.apply(p)
    env.step(1)
    assert env.manager.errors == []
    evs = env.events.events(kind="Pod", reason="FailedScheduling")
    assert evs and evs[0].type == pkg.events.WARNING
    env.close()
