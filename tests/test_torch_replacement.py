"""The torch package's replacement paths against the JAX package's.

- ``cheaper_replacement`` on clusters built by one generator for both
  packages (config4 at 40 and 200 nodes, the mixed cluster, an on-demand
  cluster of oversized nodes on which several replacements fire), with
  spot-to-spot off and on: the same (node name, type, price, offering
  options) list;
- the reservation case of ``tests/test_reservations.py`` with the market
  on: one free reserved slot justifies exactly one zero-priced replacement,
  a reserved node is never replaced, and a window that has not opened or
  has expired justifies none;
- ``repack_set_feasible`` with ``return_free=True`` (the free matrix after
  the placement) and ``allow_overflow=True`` (the overflow per group) on
  seeded candidate subsets, and ``replacement_for_groups`` on those
  overflows. These run on the same tensors in both packages (the
  reference's handed over, with the port's own pods in the reference's
  group order), because group ids follow per-package token counters.
Exact everywhere: deterministic host numpy.
"""

import numpy as np
import pytest

from test_torch_consolidate import CLUSTERS, _add_node, _bind, _handover
from test_torch_encode_delta import JAXPKG, TORCHPKG

from karpenter_provider_aws_tpu.utils.clock import FakeClock


def _pools(pkg):
    return {"default": pkg.NodePool(
        name="default",
        requirements=[pkg.Requirement(pkg.lbl.INSTANCE_CATEGORY, pkg.Operator.IN,
                                      ("c", "m", "r"))])}


def ondemand(pkg, n_nodes=30):
    """Oversized on-demand c/m nodes (8-16 vCPUs) holding 1-2 small pods
    each: most have a type 15% cheaper that holds their pods."""
    catalog = pkg.CatalogProvider()
    cluster = pkg.Cluster()
    rng = np.random.RandomState(5)
    types = [t for t in catalog.list() if t.category in ("c", "m") and 8 <= t.vcpus <= 16]
    for i in range(n_nodes):
        it = types[rng.randint(len(types))]
        zone = catalog.zones[rng.randint(len(catalog.zones))]
        node = _add_node(pkg, cluster, catalog, i, it, zone)
        node.labels = {**node.labels, pkg.lbl.CAPACITY_TYPE: "on-demand"}
        _bind(cluster, node, pkg.make_pods(1 + rng.randint(2), f"od{i}",
                                           {"cpu": "500m", "memory": "1Gi"}))
    return cluster, catalog


REPLACE_CLUSTERS = {**CLUSTERS, "ondemand": ondemand}


def _named(ct, out):
    return [(ct.node_names[i], t, p, list(opts)) for i, t, p, opts in out]


def _cheaper_both(build, **kw):
    out = {}
    for pkg in (JAXPKG, TORCHPKG):
        cluster, catalog = build(pkg)
        ct = pkg.cons.encode_cluster(cluster, catalog, incremental=False)
        out[pkg.root] = _named(ct, pkg.cons.cheaper_replacement(
            ct, catalog, nodepools=_pools(pkg),
            nodeclass_by_pool=cluster.nodeclass_by_pool(_pools(pkg)), **kw))
    return out[JAXPKG.root], out[TORCHPKG.root]


@pytest.mark.parametrize("spot_to_spot", [False, True])
@pytest.mark.parametrize("name", sorted(REPLACE_CLUSTERS))
def test_cheaper_replacement_equal(name, spot_to_spot):
    want, got = _cheaper_both(REPLACE_CLUSTERS[name], spot_to_spot=spot_to_spot)
    assert got == want
    if name == "ondemand":
        assert len(got) >= 3, "the on-demand cluster must fire replacements"
    if name.startswith("config4") and spot_to_spot:
        assert got, "spot-to-spot on: cheaper spot types replace spot nodes"


def test_cheaper_replacement_candidates_bound_the_rows():
    build = REPLACE_CLUSTERS["ondemand"]
    want, got = _cheaper_both(build, candidates=[0, 3, 5, 7, 11])
    assert got == want and 0 < len(got) <= 5


def _reserved_cluster(pkg, clock, window):
    """Two on-demand c5.4xlarge nodes in zone-a, each holding one 10-cpu pod,
    a reserved m5.4xlarge node, and one reservation slot of m5.4xlarge in
    zone-a whose window is ``window`` (start_s, end_s)."""
    import importlib

    Reservation = importlib.import_module(f"{pkg.root}.catalog.reservations").Reservation
    catalog = pkg.CatalogProvider(clock=clock)
    cluster = pkg.Cluster()
    for i, (itype, captype) in enumerate((("c5.4xlarge", "on-demand"),
                                          ("c5.4xlarge", "on-demand"),
                                          ("m5.4xlarge", "reserved"))):
        node = _add_node(pkg, cluster, catalog, i, catalog.get(itype), "zone-a")
        node.labels = {**node.labels, pkg.lbl.CAPACITY_TYPE: captype}
        _bind(cluster, node, pkg.make_pods(1, f"res{i}", {"cpu": "10", "memory": "20Gi"}))
    start, end = window
    catalog.reservations.update([Reservation(
        id="cr-1", instance_type="m5.4xlarge", zone="zone-a", count=1,
        start_s=start, end_s=end)])
    return cluster, catalog


@pytest.mark.parametrize("window,zero_priced", [
    ((None, None), 1), ((None, 5000.0), 1), ((5000.0, None), 0), ((None, 500.0), 0),
])
def test_reservation_case_with_the_market_on(window, zero_priced, monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_MARKET", raising=False)
    out = {}
    for pkg in (JAXPKG, TORCHPKG):
        clock = FakeClock(start=1000.0)
        cluster, catalog = _reserved_cluster(pkg, clock, window)
        ct = pkg.cons.encode_cluster(cluster, catalog, incremental=False)
        reserved = [i for i, c in enumerate(ct.node_captype) if c == "reserved"]
        assert reserved and all(ct.price[i] == 0.0 for i in reserved)
        res = pkg.cons.cheaper_replacement(ct, catalog, nodepools=_pools(pkg),
                                           reserved_allow={"default": True})
        assert not any(i in reserved for i, *_ in res)
        out[pkg.root] = _named(ct, res)
    assert out[TORCHPKG.root] == out[JAXPKG.root]
    assert sum(1 for o in out[TORCHPKG.root] if o[2] == 0.0) == zero_priced


def _shared_tensors(name):
    """The reference's ``ClusterTensors`` and the port's on the same arrays:
    the reference's handed over, with the port's own pods in the
    reference's group order (groups matched by their pods' names)."""
    jcl, jcat = REPLACE_CLUSTERS[name](JAXPKG)
    tcl, tcat = REPLACE_CLUSTERS[name](TORCHPKG)
    jct = JAXPKG.cons.encode_cluster(jcl, jcat, incremental=False)
    tct_own = TORCHPKG.cons.encode_cluster(tcl, tcat, incremental=False)
    by_names = {tuple(sorted(p.name for p in g)): g for g in tct_own.group_pods}
    tct = _handover(jct)
    tct.group_pods = [by_names[tuple(sorted(p.name for p in g))] for g in jct.group_pods]
    return jct, jcat, tct, tcat


def _subsets(ct, seed):
    rng = np.random.RandomState(seed)
    N = len(ct.node_names)
    return [sorted(rng.choice(N, size=k, replace=False).tolist())
            for k in (1, 2, max(2, N // 4), max(3, N // 2), 9 * N // 10, N - 3, N - 1)]


@pytest.mark.parametrize("name", ["config4_40", "config4_200", "mixed", "ondemand"])
def test_repack_set_feasible_options_and_replacement_for_groups(name):
    jct, jcat, tct, tcat = _shared_tensors(name)
    jpools, tpools = _pools(JAXPKG), _pools(TORCHPKG)
    fired = overflowed = 0
    for seed in range(3):
        for subset in _subsets(jct, seed):
            # return_free: the free matrix after the placement, or None
            want = JAXPKG.cons.repack_set_feasible(jct, subset, return_free=True)
            got = TORCHPKG.cons.repack_set_feasible(tct, subset, return_free=True)
            assert (got is None) == (want is None)
            if want is not None:
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            # free=: start from a caller's free matrix (here: half of it)
            half = jct.free * np.float32(0.5)
            want = JAXPKG.cons.repack_set_feasible(jct, subset, free=half, return_free=True)
            got = TORCHPKG.cons.repack_set_feasible(tct, subset, free=half.copy(),
                                                    return_free=True)
            assert (got is None) == (want is None)
            if want is not None:
                assert got.tobytes() == want.tobytes()
            if len(subset) == 1:
                r = TORCHPKG.cons.repack_feasible_numpy(tct, tct.free, subset[0])
                w = JAXPKG.cons.repack_feasible_numpy(jct, jct.free, subset[0])
                assert (r is None) == (w is None) and (w is None or r.tobytes() == w.tobytes())
            # allow_overflow: (free, {group: pods left over})
            jfree, jover = JAXPKG.cons.repack_set_feasible(jct, subset, allow_overflow=True)
            tfree, tover = TORCHPKG.cons.repack_set_feasible(tct, subset, allow_overflow=True)
            assert tfree.tobytes() == jfree.tobytes() and tover == jover
            overflowed += bool(tover)
            price_cap = float(sum(jct.price[i] for i in subset))
            has_spot = any(jct.node_captype[i] == "spot" for i in subset)
            for s2s in (False, True):
                kw = dict(margin=0.15, price_cap=price_cap, set_has_spot=has_spot,
                          spot_to_spot=s2s)
                want = JAXPKG.cons.replacement_for_groups(jct, jover, jcat, "default",
                                                          nodepools=jpools, **kw)
                got = TORCHPKG.cons.replacement_for_groups(tct, tover, tcat, "default",
                                                           nodepools=tpools, **kw)
                assert got == want, (subset, s2s)
                fired += got is not None
    assert overflowed, "no subset overflowed its survivors"
    if name != "mixed":
        assert fired, "no overflow found a replacement"
