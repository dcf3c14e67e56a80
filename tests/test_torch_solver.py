"""``TorchSolver(device="cpu")`` against the JAX package's ``TPUSolver``.

Both solve the same pods (built by each package's own ``make_pods`` from the
same arguments) with the optimizer lane and the market off. The plans must
be the same: NodeSpecs (type, zone, captype and offering options, pod names,
price), binds, unschedulable reasons, and the total cost to rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from karpenter_provider_aws_tpu.scheduling import TPUSolver
from karpenter_provider_aws_tpu.scheduling.solver import ExistingNode as JExisting
from karpenter_provider_aws_tpu_torch.scheduling import ExistingNode as TExisting
from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver
from test_torch_encode import CONFIGS, JAXPKG, TORCHPKG, config2, config5_reservations, headline


@pytest.fixture(autouse=True)
def _optimizer_and_market_off(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    monkeypatch.setenv("KARPENTER_TPU_MARKET", "0")


def _plan(res):
    return {
        "specs": [
            (s.nodepool_name, list(s.instance_type_options), list(s.zone_options),
             list(s.capacity_type_options), list(s.offering_options),
             [p.name for p in s.pods], s.estimated_price)
            for s in res.node_specs
        ],
        "binds": [(p.name, node) for p, node in res.binds],
        "unschedulable": [(p.name, why) for p, why in res.unschedulable],
    }


def _existing(pkg, cls, catalog):
    """Two live nodes of the default pool with slack, same values in both
    packages."""
    out = []
    for name, itype, zone, frac in (("live-a", "m5.2xlarge", "zone-a", 0.3),
                                    ("live-b", "c5.4xlarge", "zone-b", 0.5)):
        alloc = catalog.allocatable(catalog.get(itype)).v.astype(np.float32)
        out.append(cls(
            name=name, nodepool_name="default", instance_type=itype, zone=zone,
            capacity_type="on-demand", used=(alloc * frac).astype(np.float32),
            allocatable=alloc,
        ))
    return out


def config2_weighted(pkg):
    """config2 with the tainted pool tried first: only the tolerating pods
    encode there, every other pod falls through to the default pool."""
    pods, pools = config2(pkg)
    pools[1].weight = 10
    return pods, pools


@pytest.mark.parametrize("config,existing", [
    ("headline", False), ("config2", False), ("config2_weighted", False),
    ("headline", True),
])
def test_same_plan_as_tpu_solver(config, existing):
    build = {"headline": headline, "config2": config2,
             "config2_weighted": config2_weighted}[config]
    results = {}
    for pkg, solver, existing_cls in ((JAXPKG, TPUSolver(), JExisting),
                                      (TORCHPKG, TorchSolver(device="cpu"), TExisting)):
        pods, pools = build(pkg)
        catalog = pkg.CatalogProvider()
        kw = {"existing": _existing(pkg, existing_cls, catalog)} if existing else {}
        results[pkg.root] = solver.solve(pods, pools, catalog, **kw)
    want, got = results[JAXPKG.root], results[TORCHPKG.root]
    assert got.pods_placed() > 0
    if existing:
        assert got.binds, "the live nodes' slack must take pods"
    if config == "config2_weighted":
        assert {s.nodepool_name for s in got.node_specs} == {"default", "tainted"}
    assert _plan(got) == _plan(want)
    assert got.total_cost == pytest.approx(want.total_cost, rel=1e-6)
    assert got.provenance["backend"] == "torch-plain"
    assert set(got.provenance["timings"]) >= {"encode_ms", "device_ms", "decode_ms"}


@pytest.mark.parametrize("config", ["config1", "config3", "config5", "config6", "config8"])
def test_same_plan_as_tpu_solver_on_the_solve_configs(config):
    """The reference's solve configs end to end (config5 with its two
    capacity reservations, as the static reserved column the market-off
    catalog encodes)."""
    results = {}
    for pkg, solver in ((JAXPKG, TPUSolver()), (TORCHPKG, TorchSolver(device="cpu"))):
        pods, pools = CONFIGS[config](pkg)
        catalog = pkg.CatalogProvider()
        if config == "config5":
            config5_reservations(pkg, catalog)
        results[pkg.root] = solver.solve(pods, pools, catalog)
    want, got = results[JAXPKG.root], results[TORCHPKG.root]
    assert got.pods_placed() == len(pods) - len(got.unschedulable) and got.pods_placed() > 0
    assert _plan(got) == _plan(want)
    assert got.total_cost == pytest.approx(want.total_cost, rel=1e-6)


@pytest.mark.parametrize("config", ["headline", "config3"])
def test_solve_encoded_on_the_reference_tensors(config):
    """The JAX package's own encoding, carried over by
    ``interop.problem_from_reference``: both solvers see the very same
    tensors and must return the same plan."""
    from karpenter_provider_aws_tpu.ops.encode import encode_problem
    from karpenter_provider_aws_tpu_torch.interop import ARRAY_FIELDS, problem_from_reference
    from test_torch_encode import config3

    pods, pools = {"headline": headline, "config3": config3}[config](JAXPKG)
    ref = encode_problem(pods, JAXPKG.CatalogProvider(), nodepool=pools[0])
    ours = problem_from_reference(
        {f: getattr(ref, f) for f in ARRAY_FIELDS}, group_pods=ref.group_pods,
        type_names=ref.type_names, zones=ref.zones, nodepool=ref.nodepool,
    )
    want = TPUSolver().solve_encoded(ref)
    got = TorchSolver(device="cpu").solve_encoded(ours)

    def specs(out):
        return [(s.instance_type_options, s.offering_options, [p.name for p in s.pods],
                 s.estimated_price) for s in out[0]]

    assert specs(got) and specs(got) == specs(want)
    assert got[2] == want[2]


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert TorchSolver().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchSolver()


@pytest.mark.parametrize("var,value", [
    ("KARPENTER_TPU_OPT_COLD_SKIP", "1"),
    ("KARPENTER_TPU_WHY", "1"),
    ("KARPENTER_TPU_PARTITION_SOLVE", "vmap"),
])
def test_unsupported_lanes_are_refused(var, value, monkeypatch):
    monkeypatch.setenv(var, value)
    pods, pools = headline(TORCHPKG, 64)
    with pytest.raises(NotImplementedError):
        TorchSolver(device="cpu").solve(pods, pools, TORCHPKG.CatalogProvider())
