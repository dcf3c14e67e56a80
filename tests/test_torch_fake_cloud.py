"""The fake cloud (``fake/cloud.py``: the fenced lease host, launches and
terminations) and the single-replica ownership scope
(``operator/sharding.py``) copied into the port, held to the reference's
own single-replica cases (``tests/test_sharding.py``'s ``TestFencedLeases``
and ``TestRendezvous``) and backend-contract cases
(``tests/test_backend_contract.py``), each case once per package. The
N-replica elector is not carried: constructing one raises."""

import importlib
import pathlib
import types

import pytest

PACKAGES = ("karpenter_provider_aws_tpu", "karpenter_provider_aws_tpu_torch")


@pytest.fixture(params=PACKAGES)
def pkg(request):
    root = request.param

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root, FakeCloud=mod("fake").FakeCloud, FakeClock=mod("utils.clock").FakeClock,
        LaunchRequest=mod("cloudprovider.backend").LaunchRequest, sharding=mod("operator.sharding"),
        StaleFencingTokenError=mod("utils.errors").StaleFencingTokenError,
        backend=mod("cloudprovider.backend"), cloudprovider=mod("cloudprovider.cloudprovider"),
    )


def _request(pkg, fence=None):
    return pkg.LaunchRequest(instance_type_options=["m5.large"],
                             offering_options=[("zone-a", "on-demand")], image_id="img-std-2",
                             subnet_by_zone={"zone-a": "subnet-0"}, fence=fence)


def test_token_bumps_per_tenancy_not_per_renew(pkg):
    clock = pkg.FakeClock()
    cloud = pkg.FakeCloud(clock=clock)
    assert cloud.try_acquire_lease_fenced("l", "a", 15.0, nonce="n1")[:2] == ("a", 1)
    clock.advance(5)
    assert cloud.try_acquire_lease_fenced("l", "a", 15.0, nonce="n1")[:2] == ("a", 1)
    clock.advance(16)
    assert cloud.try_acquire_lease_fenced("l", "b", 15.0, nonce="n2")[:2] == ("b", 2)


def test_release_then_reacquire_bumps(pkg):
    cloud = pkg.FakeCloud(clock=pkg.FakeClock())
    _, t1, _ = cloud.try_acquire_lease_fenced("l", "a", 15.0)
    cloud.release_lease("l", "a")
    _, t2, _ = cloud.try_acquire_lease_fenced("l", "a", 15.0)
    assert t2 == t1 + 1


def test_same_identity_different_nonce_is_a_contender(pkg):
    cloud = pkg.FakeCloud(clock=pkg.FakeClock())
    h1, t1, n1 = cloud.try_acquire_lease_fenced("l", "x", 15.0, nonce="A")
    _, t2, n2 = cloud.try_acquire_lease_fenced("l", "x", 15.0, nonce="B")
    assert (h1, n1) == ("x", "A") and n2 == "A" and t2 == t1


def test_stale_launch_rejected(pkg):
    clock = pkg.FakeClock()
    cloud = pkg.FakeCloud(clock=clock)
    name = pkg.sharding.lease_name(pkg.sharding.GLOBAL_KEY)
    cloud.try_acquire_lease_fenced(name, "a", 15.0, nonce="n1")
    clock.advance(16)
    _, t2, _ = cloud.try_acquire_lease_fenced(name, "b", 15.0, nonce="n2")
    (result,) = cloud.create_fleet([_request(pkg, fence=(name, t2 - 1))])
    assert isinstance(result, pkg.StaleFencingTokenError)
    assert cloud.fenced_rejections and cloud.fenced_rejections[0][0] == name
    assert not cloud.instances


def test_current_token_launch_accepted_and_stamped(pkg):
    cloud = pkg.FakeCloud(clock=pkg.FakeClock())
    name = pkg.sharding.lease_name(pkg.sharding.GLOBAL_KEY)
    _, token, _ = cloud.try_acquire_lease_fenced(name, "a", 15.0)
    (inst,) = cloud.create_fleet([_request(pkg, fence=(name, token))])
    assert inst.launch_fence == (name, token)


def test_stale_terminate_rejected_positionally(pkg):
    clock = pkg.FakeClock()
    cloud = pkg.FakeCloud(clock=clock)
    name = pkg.sharding.lease_name(("default", "zone-a"))
    _, t1, _ = cloud.try_acquire_lease_fenced(name, "a", 15.0, nonce="n1")
    (inst,) = cloud.create_fleet([_request(pkg)])
    clock.advance(16)
    cloud.try_acquire_lease_fenced(name, "b", 15.0, nonce="n2")
    results = cloud.terminate_instances([inst.id], fences={inst.id: (name, t1)})
    assert isinstance(results[0], pkg.StaleFencingTokenError)
    assert cloud.instances[inst.id].state == "running"


def test_rendezvous_deterministic_and_total(pkg):
    s = pkg.sharding
    keys = [s.GLOBAL_KEY] + [("p", f"zone-{c}") for c in "abcd"]
    members = ["replica-0", "replica-1", "replica-2"]
    first = {k: s.rendezvous_owner(k, members) for k in keys}
    assert first == {k: s.rendezvous_owner(k, members) for k in keys}
    assert all(o in members for o in first.values())


def test_rendezvous_minimal_movement_on_member_loss(pkg):
    s = pkg.sharding
    keys = [("p", f"zone-{i}") for i in range(32)]
    before = {k: s.rendezvous_owner(k, ["replica-0", "replica-1", "replica-2"]) for k in keys}
    after = {k: s.rendezvous_owner(k, ["replica-0", "replica-1"]) for k in keys}
    assert all(before[k] == "replica-2" for k in keys if before[k] != after[k])


def test_predicates_default_true_without_scope(pkg):
    s = pkg.sharding
    assert s.owns_global() and s.owns_key(("any", "zone")) and s.current() is None
    assert s.split_pending(["p1", "p2"]) == ({}, ["p1", "p2"], [])
    assert s.write_fence() is None and s.routes_here(object())


def test_scope_filters(pkg):
    s = pkg.sharding
    own = s.Ownership(replica="r0", keys={s.GLOBAL_KEY: 3, ("p", "z1"): 5})
    object.__setattr__(own, "_known", frozenset([s.GLOBAL_KEY, ("p", "z1"), ("p", "z2")]))
    with s.scope(own):
        assert s.owns_global() and s.owns_key(("p", "z1"))
        assert not s.owns_key(("p", "z2"))
        assert s.owns_key(("p", "z-new"))
        assert s.write_fence(key=("p", "z1")) == (s.lease_name(("p", "z1")), 5)
    assert s.current() is None


def test_write_fence_prefers_sanction_key(pkg):
    s = pkg.sharding
    own = s.Ownership(replica="r0", keys={s.GLOBAL_KEY: 3, ("p", "z1"): 5})
    object.__setattr__(own, "_known", frozenset([s.GLOBAL_KEY, ("p", "z1")]))
    with s.scope(own):
        assert s.write_fence()[0] == s.lease_name(s.GLOBAL_KEY)
        with s.sanction(("p", "z1")):
            assert s.write_fence() == (s.lease_name(("p", "z1")), 5)


def test_write_fence_stale_when_nothing_held(pkg):
    s = pkg.sharding
    own = s.Ownership(replica="r0", keys={})
    object.__setattr__(own, "_known", frozenset())
    with s.scope(own):
        name, token = s.write_fence(key=("p", "z1"))
        assert token == 0
    cloud = pkg.FakeCloud(clock=pkg.FakeClock())
    assert isinstance(cloud._check_fence((name, token), "create_fleet"),
                      pkg.StaleFencingTokenError)
    assert cloud.fenced_rejections


def test_port_refuses_the_elector():
    from karpenter_provider_aws_tpu_torch.operator.sharding import ShardElector

    with pytest.raises(NotImplementedError, match="elector"):
        ShardElector(None, None, identity="replica-0")


def test_fake_satisfies_protocol(pkg):
    cloud = pkg.FakeCloud()
    assert isinstance(cloud, pkg.backend.CloudBackend)
    for name in ("create_fleet", "describe_instances", "list_instances", "terminate_instances",
                 "get_instance", "tag_instance", "describe_availability_zones",
                 "describe_subnets", "describe_security_groups",
                 "describe_capacity_reservations", "describe_images", "create_launch_template",
                 "describe_launch_templates", "delete_launch_template",
                 "create_instance_profile", "delete_instance_profile"):
        assert callable(getattr(cloud, name)), name


def test_launch_request_is_backend_owned(pkg):
    assert pkg.cloudprovider.LaunchRequest is pkg.backend.LaunchRequest


def test_no_production_import_of_fake(pkg):
    """No module outside ``fake/`` imports from it but ``testenv.py`` (and,
    in the reference, the operator's hermetic-default seam)."""
    root = pathlib.Path(__file__).resolve().parents[1] / pkg.root
    allowed = {root / "testenv.py", root / "operator" / "operator.py"}
    offenders = [str(path.relative_to(root)) for path in root.rglob("*.py")
                 if not path.is_relative_to(root / "fake") and path not in allowed
                 and any(t in path.read_text()
                         for t in ("from ..fake", "from .fake", "import fake"))]
    assert offenders == []
