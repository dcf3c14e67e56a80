"""The per-node agent (DaemonSet) overhead in the port's provisioning encode,
against the JAX package's.

With ``set_node_overhead({"cpu": "200m", "memory": "512Mi"})`` registered in
both packages, every candidate type's encoded capacity is its allocatable
less the agents', and the plans of config1 and config8 through
``TorchSolver(device="cpu")`` equal ``TPUSolver``'s. Re-registering the
overhead changes the encode cache's key, so a re-solve of the same pods is
encoded anew instead of being served the stale problem. Both registries are
cleared after each case.
"""

import importlib

import numpy as np
import pytest

from test_torch_encode import CONFIGS, JAXPKG, TORCHPKG
from test_torch_solver import _plan

AGENTS = {"cpu": "200m", "memory": "512Mi"}


@pytest.fixture(autouse=True)
def _agents(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    monkeypatch.setenv("KARPENTER_TPU_MARKET", "0")
    yield
    for pkg in (JAXPKG, TORCHPKG):
        importlib.import_module(f"{pkg.root}.ops.overhead").set_node_overhead(None)


def _overhead(pkg):
    return importlib.import_module(f"{pkg.root}.ops.overhead")


@pytest.mark.parametrize("config", ["config1", "config8"])
def test_overhead_capacity_and_plan_equal_reference(config):
    from karpenter_provider_aws_tpu.scheduling.solver import TPUSolver
    from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver

    problems, plans = {}, {}
    for pkg, solver in ((JAXPKG, TPUSolver()), (TORCHPKG, TorchSolver(device="cpu"))):
        _overhead(pkg).set_node_overhead(AGENTS)
        pods, pools = CONFIGS[config](pkg)
        catalog = pkg.CatalogProvider()
        problems[pkg.root] = pkg.encode.encode_problem(pods, catalog, nodepool=pools[0])
        plans[pkg.root] = _plan(solver.solve(pods, pools, catalog))
    want, got = problems[JAXPKG.root], problems[TORCHPKG.root]
    assert got.capacity.tobytes() == want.capacity.tobytes()
    assert got.type_names == want.type_names
    assert plans[TORCHPKG.root] == plans[JAXPKG.root]
    # the agents came off: cpu capacity is allocatable less 200m
    catalog = TORCHPKG.CatalogProvider()
    it = catalog.get(got.type_names[0])
    alloc = catalog.allocatable(it).v.astype(np.float32)
    assert got.capacity[0][0] == pytest.approx(alloc[0] - 200.0)


def test_reregistering_overhead_does_not_serve_a_stale_problem():
    pods, pools = CONFIGS["config1"](TORCHPKG)
    catalog = TORCHPKG.CatalogProvider()
    ov = _overhead(TORCHPKG)
    bare = TORCHPKG.encode.encode_problem(pods, catalog, nodepool=pools[0])
    assert TORCHPKG.encode.encode_problem(pods, catalog, nodepool=pools[0]) is bare
    ov.set_node_overhead(AGENTS)
    loaded = TORCHPKG.encode.encode_problem(pods, catalog, nodepool=pools[0])
    assert loaded is not bare

    def cpu(problem):  # by type name, past the types the encode pruned to zero capacity
        return {n: float(problem.capacity[i, 0]) for i, n in enumerate(problem.type_names)
                if not n.startswith("__pruned")}

    def less(problem, agents):  # the types both keep (the agents prune a few)
        got, base = cpu(problem), cpu(bare)
        assert len(got) > 0.9 * len(base)
        return {n: got[n] for n in got if n in base} == \
            {n: base[n] - agents for n in got if n in base}

    assert less(loaded, 200.0)
    ov.set_node_overhead({"cpu": "400m"})
    heavier = TORCHPKG.encode.encode_problem(pods, catalog, nodepool=pools[0])
    assert heavier is not loaded
    assert less(heavier, 400.0)
