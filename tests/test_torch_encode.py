"""The torch package's host encode against the JAX package's: byte-equal.

Pods are built by each package's own ``make_pods`` from the same arguments
and compared by name (uids come from per-package counters). Every array of
``EncodedProblem`` must be equal in dtype, shape and bytes.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from karpenter_provider_aws_tpu_torch.interop import ARRAY_FIELDS
from karpenter_provider_aws_tpu_torch.ops import solve_cases


def _package(root: str) -> SimpleNamespace:
    models = importlib.import_module(f"{root}.models")
    pod = importlib.import_module(f"{root}.models.pod")
    return SimpleNamespace(
        root=root,
        lbl=models.labels,
        make_pods=pod.make_pods,
        Toleration=pod.Toleration,
        TopologySpreadConstraint=pod.TopologySpreadConstraint,
        PodAffinityTerm=pod.PodAffinityTerm,
        NodePool=models.NodePool,
        Requirement=models.Requirement,
        Operator=models.Operator,
        Taint=models.Taint,
        Disruption=models.Disruption,
        CatalogProvider=importlib.import_module(f"{root}.catalog").CatalogProvider,
        encode=importlib.import_module(f"{root}.ops.encode"),
    )


JAXPKG = _package("karpenter_provider_aws_tpu")
TORCHPKG = _package("karpenter_provider_aws_tpu_torch")


def _pool(pkg, name="default", taints=(), cats=("c", "m", "r")):
    return pkg.NodePool(
        name=name,
        requirements=[pkg.Requirement(pkg.lbl.INSTANCE_CATEGORY, pkg.Operator.IN, tuple(cats))],
        taints=list(taints),
        disruption=pkg.Disruption(consolidate_after_s=None),
    )


def headline(pkg, n=640):
    """The 50k-pod headline generator (64 shapes, seed 0), at ``n`` pods."""
    return solve_cases.headline_pods(pkg, n), [_pool(pkg)]


def config2(pkg, n=640):
    """config2_heterogeneous: selectors, taints and tolerations, two pools."""
    lbl = pkg.lbl
    rng = np.random.RandomState(0)
    pools = [_pool(pkg), _pool(pkg, name="tainted", taints=[pkg.Taint(key="team", value="ml")])]
    pods = []
    per = n // 64
    for i in range(64):
        cpu_m = int(rng.choice([100, 250, 500, 1000, 2000, 4000, 8000]))
        mem = cpu_m * int(rng.choice([1, 2, 4, 8]))
        kwargs = {}
        r = rng.rand()
        if r < 0.15:
            kwargs["node_selector"] = {lbl.ARCH: "arm64"}
        elif r < 0.25:
            kwargs["node_selector"] = {lbl.TOPOLOGY_ZONE: str(rng.choice(["zone-a", "zone-b"]))}
        elif r < 0.35:
            kwargs["tolerations"] = [pkg.Toleration(key="team", value="ml")]
        pods += pkg.make_pods(per, f"s{i}", {"cpu": f"{cpu_m}m", "memory": f"{mem}Mi"}, **kwargs)
    return pods, pools


def config3(pkg, n=500):
    """config3_topology: zone spread on every service, hostname
    anti-affinity on every fifth."""
    lbl = pkg.lbl
    pods = []
    per = n // 50
    for i in range(50):
        app = f"svc{i}"
        constraints = dict(
            labels={"app": app},
            topology_spread=[
                pkg.TopologySpreadConstraint(
                    topology_key=lbl.TOPOLOGY_ZONE, max_skew=1, label_selector={"app": app}
                )
            ],
        )
        if i % 5 == 0:
            constraints["anti_affinity"] = [
                pkg.PodAffinityTerm(topology_key=lbl.HOSTNAME, label_selector={"app": app})
            ]
        pods += pkg.make_pods(per, app, {"cpu": "500m", "memory": "1Gi"}, **constraints)
    return pods, [_pool(pkg)]


def config1(pkg, n=2000):
    """config1_homogeneous: 2k identical cpu/mem pods."""
    return pkg.make_pods(n, "web", {"cpu": "500m", "memory": "1Gi"}), [_pool(pkg)]


def config5(pkg, n=400):
    """config5_accelerators: GPU and Neuron pods beside cpu pods, two pools;
    ``config5_reservations`` pre-pays part of the accelerator fleet."""
    return (solve_cases.config5_pods(pkg, n),
            [_pool(pkg), _pool(pkg, name="accel", cats=("g", "p", "inf", "trn"))])


def config5_reservations(pkg, catalog) -> None:
    """config5's two capacity reservations (reserved captype at price 0)."""
    Reservation = importlib.import_module(f"{pkg.root}.catalog.reservations").Reservation
    catalog.reservations.update([Reservation(**r) for r in solve_cases.CONFIG5_RESERVATIONS])


def config6(pkg):
    """config6_mixed_tail: dual-arch and amd64-pinned groups on 16-vcpu c/m
    types, where each group leaves a singleton tail."""
    lbl = pkg.lbl
    pool = pkg.NodePool(
        name="default",
        requirements=[
            pkg.Requirement(lbl.INSTANCE_CATEGORY, pkg.Operator.IN, ("c", "m")),
            pkg.Requirement(lbl.INSTANCE_CPU, pkg.Operator.IN, ("16",)),
        ],
        disruption=pkg.Disruption(consolidate_after_s=None),
    )
    pods = pkg.make_pods(21, "dual", {"cpu": "6", "memory": "4Gi"})
    pods += pkg.make_pods(31, "amd", {"cpu": "4500m", "memory": "4Gi"},
                          node_selector={lbl.ARCH: "amd64"})
    return pods, [pool]


def config8(pkg):
    """config8_fleet_fragmentation: 300 deployments with zipf replica counts
    and mixed zone / capacity-type / arch pins."""
    return solve_cases.config8_pods(pkg), [_pool(pkg)]


CONFIGS = {"headline": headline, "config1": config1, "config2": config2, "config3": config3,
           "config5": config5, "config6": config6, "config8": config8}


def reference_arrays(problem) -> dict:
    return {f: getattr(problem, f) for f in ARRAY_FIELDS}


@pytest.mark.parametrize(
    "config,pool_index",
    [("headline", 0), ("config1", 0), ("config2", 0), ("config2", 1), ("config3", 0),
     ("config5", 0), ("config5", 1), ("config6", 0), ("config8", 0)],
)
def test_encode_byte_equal(config, pool_index, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_MARKET", "0")
    build = CONFIGS[config]
    out = {}
    for pkg in (JAXPKG, TORCHPKG):
        pods, pools = build(pkg)
        catalog = pkg.CatalogProvider()
        if config == "config5":
            config5_reservations(pkg, catalog)
        out[pkg.root] = pkg.encode.encode_problem(pods, catalog, nodepool=pools[pool_index])
    want, got = out[JAXPKG.root], out[TORCHPKG.root]
    assert len(want.group_pods) > 0
    for name in ARRAY_FIELDS:
        a, b = getattr(want, name), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert [[p.name for p in g] for g in want.group_pods] == [
        [p.name for p in g] for g in got.group_pods
    ]
    assert [(p.name, why) for p, why in want.unencodable] == [
        (p.name, why) for p, why in got.unencodable
    ]
    assert want.type_names == got.type_names and want.zones == got.zones
    # the padded form too: the device sees it
    pa, pb = JAXPKG.encode.pad_problem(want), TORCHPKG.encode.pad_problem(got)
    for name in ARRAY_FIELDS:
        assert getattr(pa, name).tobytes() == getattr(pb, name).tobytes(), name


def test_gang_pods_are_refused(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_GANGS", "1")
    pkg = TORCHPKG
    pods = pkg.make_pods(
        4, "gang", {"cpu": "1", "memory": "1Gi"},
        annotations={pkg.lbl.ANNOTATION_POD_GROUP: "g1"},
    )
    with pytest.raises(NotImplementedError, match="gang"):
        pkg.encode.encode_problem(pods, pkg.CatalogProvider(), nodepool=_pool(pkg))


def test_market_state_is_refused(monkeypatch):
    """A reservation encodes as the reference encodes it, with the market
    on (the default: an open-ended reservation window) and off (the static
    reserved column, committed price 0)."""
    from karpenter_provider_aws_tpu.catalog.reservations import Reservation as JR
    from karpenter_provider_aws_tpu_torch.catalog.reservations import Reservation

    for market in ("1", "0"):
        monkeypatch.setenv("KARPENTER_TPU_MARKET", market)
        catalog = TORCHPKG.CatalogProvider()
        catalog.reservations.update([
            Reservation(id="cr-1", instance_type="m5.large", zone="zone-a", count=2),
        ])
        ref = JAXPKG.CatalogProvider()
        ref.reservations.update([JR(id="cr-1", instance_type="m5.large", zone="zone-a", count=2)])
        a, b = ref.tensors(), catalog.tensors()
        assert a.price.tobytes() == b.price.tobytes(), market
        assert a.available.tobytes() == b.available.tobytes(), market
        ti = b.names.index("m5.large")
        assert b.available[ti, 0, TORCHPKG.lbl.RESERVED_INDEX]
