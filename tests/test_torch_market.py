"""The torch package's market state against the JAX package's.

- ``MarketModel``: walked multipliers, reclaim probabilities, tick indices
  and the walked spot prices it pushes into the catalog are byte-identical
  to the reference's, per seed;
- the offering-window algebra (``apply_window_columns``,
  ``windows_cache_key``, ``dark_cell_reason``) gives the reference's answers;
- ``CatalogTensors`` price, availability and capacity, and the catalog's
  market cache-key fragment, equal the reference's with the market on, under
  the window cases of ``tests/test_market.py`` (the lifecycle, expiry
  darkening the column, an exhausted or expired window never winning, an
  open-ended reservation still winning), with a market model attached;
- config5 (two reservations, a ``MarketModel(seed=0)``) encodes byte-equal
  and ``TorchSolver(device="cpu")`` gives ``TPUSolver``'s plan, the market
  on by default and the optimizer off;
- with ``KARPENTER_TPU_MARKET=0`` the tensors are byte-identical to a
  provider that never held market state.
Both packages read one ``FakeClock`` time each. Exact everywhere.
"""

import importlib

import numpy as np
import pytest

from test_torch_encode import CONFIGS, JAXPKG, TORCHPKG, config5_reservations
from test_torch_solver import _plan

from karpenter_provider_aws_tpu.scheduling import TPUSolver
from karpenter_provider_aws_tpu.utils.clock import FakeClock
from karpenter_provider_aws_tpu_torch.scheduling import TorchSolver

PKGS = (JAXPKG, TORCHPKG)


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.root}.{name}")


@pytest.fixture(autouse=True)
def _market_on(monkeypatch):
    monkeypatch.delenv("KARPENTER_TPU_MARKET", raising=False)


def _market_catalog(pkg, seed, start=0.0, reservations=()):
    """A catalog on its own FakeClock at ``start`` with a seeded market model
    attached and applied once, and ``reservations`` (kwargs of
    ``Reservation``) in its store."""
    pricing = _mod(pkg, "catalog.pricing")
    clock = FakeClock(start=start)
    catalog = pkg.CatalogProvider(clock=clock, pricing=pricing.PricingProvider(clock=clock))
    model = pricing.MarketModel(seed=seed, clock=clock)
    catalog.pricing.market = model
    model.apply(catalog)
    if reservations:
        Reservation = _mod(pkg, "catalog.reservations").Reservation
        catalog.reservations.update([Reservation(**r) for r in reservations])
    return catalog, model, clock


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_market_model_byte_identical(seed):
    traces = {}
    for pkg in PKGS:
        catalog, model, clock = _market_catalog(pkg, seed)
        out = []
        for tick in range(4):
            if tick:
                clock.advance(3600.0)
                assert model.apply(catalog) > 0
            now = clock.now()
            for it in catalog.list()[::7]:
                for o in it.offerings:
                    if o.capacity_type != "spot":
                        continue
                    out.append((tick, it.name, o.zone, model.tick_index(now),
                                model.spot_multiplier(it.name, o.zone, now),
                                model.reclaim_probability(it.name, o.zone, now),
                                catalog.pricing.base_spot_price(it, o.zone),
                                catalog.pricing.spot_price(it, o.zone)))
        traces[pkg.root] = repr(out)
    assert traces[TORCHPKG.root] == traces[JAXPKG.root]
    assert len(traces[TORCHPKG.root]) > 1000


WINDOWS = [
    dict(id="open", instance_type="a", zone="z1", slots=2, committed_price=0.5),
    dict(id="cheaper", instance_type="a", zone="z1", slots=1, committed_price=0.2),
    dict(id="expired", instance_type="b", zone="z1", slots=2, end_s=10.0),
    dict(id="exhausted", instance_type="b", zone="z1", slots=2, used=2),
    dict(id="pending", instance_type="b", zone="z2", slots=1, start_s=500.0, end_s=900.0),
]


@pytest.mark.parametrize("now", [0.0, 100.0, 600.0, 1000.0])
def test_window_algebra_equal(now):
    out = {}
    for pkg in PKGS:
        market = _mod(pkg, "market")
        offerings = _mod(pkg, "market.offerings")
        windows = [market.OfferingWindow(**w) for w in WINDOWS]
        price = np.full((2, 2, 3), np.inf, dtype=np.float32)
        avail = np.zeros((2, 2, 3), dtype=bool)
        lit = market.apply_window_columns(price, avail, ("a", "b"), ("z1", "z2"), windows, now)
        out[pkg.root] = (
            lit, price.tobytes(), avail.tobytes(),
            market.windows_cache_key(windows, now),
            [offerings.dark_cell_reason(windows, t, z, now)
             for t in ("a", "b") for z in ("z1", "z2")],
            [(w.state_at(now), w.open_at(now), w.remaining) for w in windows],
        )
    assert out[TORCHPKG.root] == out[JAXPKG.root]


def _tensors_equal(cats, tag):
    a, b = (cats[p.root].tensors() for p in PKGS)
    for f in ("price", "available", "capacity"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f"{tag}: {f}"
    assert a.names == b.names and a.zones == b.zones
    assert cats[JAXPKG.root]._market_fragment() == cats[TORCHPKG.root]._market_fragment(), tag
    return b


CASES = {
    # (reservation kwargs, times to read, reserved cell available at each)
    "lifecycle": (dict(start_s=100.0, end_s=200.0), (50.0, 150.0, 250.0), (False, True, False)),
    "expiry_darkens_the_column": (dict(end_s=1000.0), (0.0, 1000.0), (True, False)),
    "exhausted_cannot_win": (dict(used=4), (0.0, 300.0), (False, False)),
    "open_ended_still_wins": (dict(), (0.0, 7200.0), (True, True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_catalog_tensors_equal_with_the_market_on(case):
    extra, times, lit = CASES[case]
    cats, clocks = {}, {}
    for pkg in PKGS:
        itype = pkg.CatalogProvider().list()[0].name
        res = dict(id="r", instance_type=itype, zone="zone-a", count=4, **extra)
        cats[pkg.root], _, clocks[pkg.root] = _market_catalog(pkg, 1, reservations=[res])
    rsv = TORCHPKG.lbl.RESERVED_INDEX
    for now, want in zip(times, lit):
        for pkg in PKGS:
            clocks[pkg.root].advance(now - clocks[pkg.root].now())
        t = _tensors_equal(cats, f"{case} at {now}")
        assert bool(t.available[0, 0, rsv]) is want, now
        assert bool(t.price[0, 0, rsv] == 0.0) is want, now  # inf when dark
        if want:  # the reserved offering wins the type's cheapest price
            assert t.min_price()[0] == 0.0


def test_config5_encode_and_plan_with_the_market_on(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "0")
    results, problems = {}, {}
    for pkg, solver in ((JAXPKG, TPUSolver()), (TORCHPKG, TorchSolver(device="cpu"))):
        pods, pools = CONFIGS["config5"](pkg)
        catalog, model, clock = _market_catalog(pkg, 0, start=3600.0)
        config5_reservations(pkg, catalog)
        problems[pkg.root] = pkg.encode.encode_problem(pods, catalog, nodepool=pools[1])
        results[pkg.root] = solver.solve(pods, pools, catalog)
    from karpenter_provider_aws_tpu_torch.interop import ARRAY_FIELDS

    for name in ARRAY_FIELDS:
        a, b = (getattr(problems[p.root], name) for p in PKGS)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    want, got = results[JAXPKG.root], results[TORCHPKG.root]
    assert got.pods_placed() == len(CONFIGS["config5"](TORCHPKG)[0])
    assert _plan(got) == _plan(want)
    assert got.total_cost == pytest.approx(want.total_cost, rel=1e-6)
    assert any("reserved" in s.capacity_type_options for s in got.node_specs)


def test_market_off_is_the_static_catalog(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_MARKET", "0")
    res = [dict(id="r", instance_type="m5.large", zone="zone-a", count=2, end_s=50.0)]
    catalog, model, clock = _market_catalog(TORCHPKG, 2, start=100.0, reservations=res)
    clock.advance(7200.0)
    assert model.apply(catalog) == 0  # the switch gates the walk too
    pricing = _mod(TORCHPKG, "catalog.pricing")
    virgin = TORCHPKG.CatalogProvider(clock=clock, pricing=pricing.PricingProvider(clock=clock))
    virgin.reservations.update(catalog.reservations.list())
    a, b = catalog.tensors(), virgin.tensors()
    for f in ("price", "available", "capacity"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f
    assert catalog._market_fragment() == ()
    # and equal to the reference's static path
    ref, _, rclock = _market_catalog(JAXPKG, 2, start=100.0, reservations=res)
    rclock.advance(7200.0)
    r = ref.tensors()
    assert r.price.tobytes() == a.price.tobytes()
    assert r.available.tobytes() == a.available.tobytes()
