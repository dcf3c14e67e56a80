"""The torch package's optimizer lane against the JAX package's.

- ``lp_slot_costs`` / ``lp_lower_bound`` equal the reference's exactly
  (float64) on the headline generator, config1/3/5/6/8 and frag seeds 0-2;
- the greedy oracle (``ffd_oracle``, ``oracle_cost``) and ``HostSolver``
  give the reference's nodes, unplaced counts, cost and specs;
- ``validate_plan`` and ``classify_reject`` give the reference's verdicts
  and reason strings;
- lane 0 of round 0 meets the reference's ``_program``: the LP logits to
  1 ulp on finite entries with the same ``-inf`` pattern, its pick the
  argmax of the reference's logits, its cost the reference's ``costs[0]`` to
  a relative 1e-6;
- the lanes' noise is the reference's: threefry keys and 32-bit bits
  exact, the float32 Gumbel draws within ``GUMBEL_ATOL``, every lane's
  pick and group order equal to the reference's on ``CASES`` and frag
  seeds 0-11, and lane-on plans, outcomes and ``lp_gap`` equal to
  ``TPUSolver``'s on config3, config8 and frag seeds 0-11;
- the plain lane op equals per-lane plain solves exactly;
- the adoption contract on ``TorchSolver(device="cpu")``, determinism per
  seed, the kill switch, the admission outcomes, no fallback on a lane
  failure, and ``optimizer_replace_sets`` equal to the reference's.

The reference runs on the CPU through XLA, as its own tests run it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_encode import CONFIGS, JAXPKG, TORCHPKG, _pool, config5_reservations
from test_torch_solver import _plan

from karpenter_provider_aws_tpu.ops.consolidate import optimizer_replace_sets as jreplace_sets
from karpenter_provider_aws_tpu.ops.encode import pad_problem as jpad
from karpenter_provider_aws_tpu.scheduling import HostSolver as JHostSolver
from karpenter_provider_aws_tpu.scheduling import TPUSolver
from karpenter_provider_aws_tpu.scheduling import optimizer as jopt
from karpenter_provider_aws_tpu.scheduling import oracle as joracle
from karpenter_provider_aws_tpu.scheduling import solver as jsolver
from karpenter_provider_aws_tpu_torch.ops import ffd as tffd
from karpenter_provider_aws_tpu_torch.ops import solve_cases
from karpenter_provider_aws_tpu_torch.ops.consolidate import optimizer_replace_sets
from karpenter_provider_aws_tpu_torch.ops.encode import bucket, pad_problem
from karpenter_provider_aws_tpu_torch.scheduling import ExistingNode, HostSolver, TorchSolver
from karpenter_provider_aws_tpu_torch.scheduling import optimizer as topt
from karpenter_provider_aws_tpu_torch.scheduling import oracle as toracle
from karpenter_provider_aws_tpu_torch.scheduling import solver as tsolver

#: node rows of the lane-0 comparison (every frag seed and config6 fit)
LANE_ROWS = 256


def frag(seed):
    def build(pkg):
        return solve_cases.frag_workload(pkg, seed), [_pool(pkg)]
    return build


CASES = {**{k: CONFIGS[k] for k in ("headline", "config1", "config3", "config5", "config6",
                                    "config8")},
         **{f"frag{s}": frag(s) for s in (0, 1, 2)}}
#: the frag seeds the reference's ``config6_frag_optimizer`` row draws
FRAG = {f"frag{s}": frag(s) for s in range(12)}
#: how far the float32 Gumbel draws may be from ``jax.random.gumbel``'s:
#: the port forms ``-log(-log(u))`` in float64 and rounds once, XLA in
#: float32; over every 2^23 mantissa the largest gap measured is 9.54e-7
#: (one ulp of a value in [8, 16))
GUMBEL_ATOL = 9.6e-7
#: cases whose lanes tie in real arithmetic: the reference sums a lane's
#: prices in float32 through XLA's reduction, which breaks the tie by one
#: ulp (config3: lanes 0 and 19 both cost $2.70258; XLA makes lane 19
#: $2.7025795), the port in float64, where the tie stays and lane 0 wins.
#: The plans cost the same; ROADMAP Queue C logs it
LANE_COST_TIES = {"config3"}


@pytest.fixture(autouse=True)
def _market_off_lane_on(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_MARKET", "0")
    for var in ("KARPENTER_TPU_OPTIMIZER", "KARPENTER_TPU_OPTIMIZER_SEED",
                "KARPENTER_TPU_OPTIMIZER_LANES", "KARPENTER_TPU_OPTIMIZER_MAX_GROUPS",
                "KARPENTER_TPU_OPTIMIZER_TIGHT", "KARPENTER_TPU_OPT_COLD_SKIP"):
        monkeypatch.delenv(var, raising=False)
    topt.OUTCOMES.clear()


def encoded(case):
    """The case's first pool encoded by each package: {root: problem}."""
    out = {}
    for pkg in (JAXPKG, TORCHPKG):
        pods, pools = CASES[case](pkg)
        catalog = pkg.CatalogProvider()
        if case == "config5":
            config5_reservations(pkg, catalog)
        out[pkg.root] = pkg.encode.encode_problem(pods, catalog, nodepool=pools[0])
    return out[JAXPKG.root], out[TORCHPKG.root]


def encoded_any(case):
    """``encoded`` over ``CASES`` and ``FRAG``."""
    if case in CASES:
        return encoded(case)
    out = {}
    for pkg in (JAXPKG, TORCHPKG):
        pods, pools = FRAG[case](pkg)
        out[pkg.root] = pkg.encode.encode_problem(pods, pkg.CatalogProvider(),
                                                  nodepool=pools[0])
    return out[JAXPKG.root], out[TORCHPKG.root]


# -- 1. the LP bound ------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_lp_bound_equals_reference(case):
    """Exact, float64."""
    ref, ours = encoded(case)
    want, got = jsolver.lp_slot_costs(ref), tsolver.lp_slot_costs(ours)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tsolver.lp_lower_bound(ours) == jsolver.lp_lower_bound(ref) > 0
    assert topt.lp_bound_for(ours) == jopt.lp_bound_for(ref)


# -- 2. the greedy oracle and HostSolver ------------------------------------------

@pytest.mark.parametrize("case", ["config6", "frag0", "frag1", "frag2"])
def test_ffd_oracle_equals_reference(case):
    """Same nodes (type, price, group counts, used, window), same unplaced,
    equal cost: exact."""
    ref, ours = encoded(case)
    (want, want_un), (got, got_un) = joracle.ffd_oracle(ref), toracle.ffd_oracle(ours)
    assert got_un == want_un
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.type_index, a.price, a.group_counts) == (b.type_index, b.price, b.group_counts)
        assert np.array_equal(a.used, b.used) and np.array_equal(a.window, b.window)
    assert toracle.oracle_cost(got) == joracle.oracle_cost(want)


@pytest.mark.parametrize("case", ["config1", "config2", "config3", "config5", "config6",
                                  "config8", *FRAG])
def test_host_solver_equals_reference(case):
    results = {}
    for pkg, solver in ((JAXPKG, JHostSolver()), (TORCHPKG, HostSolver())):
        pods, pools = {**CONFIGS, **FRAG}[case](pkg)
        results[pkg.root] = solver.solve(pods, pools, pkg.CatalogProvider())
    want, got = results[JAXPKG.root], results[TORCHPKG.root]
    assert got.node_specs and _plan(got) == _plan(want)
    assert got.total_cost == pytest.approx(want.total_cost, rel=1e-9)
    assert got.provenance["backend"] == "host"


# -- 3. the validator --------------------------------------------------------------

def _oracle_plan(problem):
    """A valid plan of ``problem`` from the greedy oracle, as arrays."""
    nodes, unplaced = toracle.ffd_oracle(problem)
    G, n = len(problem.group_pods), len(nodes)
    placed = np.zeros((G, n), dtype=np.int32)
    for i, node in enumerate(nodes):
        for g, c in node.group_counts.items():
            placed[g, i] = c
    un = np.array([unplaced.get(g, 0) for g in range(G)], dtype=np.int32)
    return {"node_type": np.array([x.type_index for x in nodes], dtype=np.int64),
            "node_price": np.array([x.price for x in nodes], dtype=np.float32),
            "used": np.stack([x.used for x in nodes]).astype(np.float32),
            "placed": placed, "node_window": np.stack([x.window for x in nodes]),
            "n_open": n, "unplaced": un}


def _corrupt(kind, problem, plan):
    plan = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in plan.items()}
    g0, n0 = (int(x[0]) for x in np.nonzero(plan["placed"]))
    if kind == "negative":
        plan["placed"][g0, n0] = -1
    elif kind == "conservation":
        plan["unplaced"][g0] += 1
    elif kind == "hostname":
        problem = dataclasses.replace(problem, max_per_node=np.ones_like(problem.max_per_node))
    elif kind == "capacity":
        plan["placed"][g0, n0] += 4_000
        plan["unplaced"][g0] -= 4_000
    elif kind == "used":
        plan["used"] = plan["used"] + 5.0
    elif kind == "incompatible":
        bad = np.nonzero(~(problem.compat[g0] & np.isfinite(problem.price[g0])))[0]
        plan["node_type"][n0] = bad[0]
    elif kind == "window":
        plan["node_window"][n0] = False
    elif kind == "empty_window":
        gw = problem.group_window.copy()
        gw[g0] = False
        problem = dataclasses.replace(problem, group_window=gw)
    elif kind == "several":
        # faults on two nodes, two on the first: the first node's first
        # check is the one reported
        bad = np.nonzero(~(problem.compat[g0] & np.isfinite(problem.price[g0])))[0]
        plan["node_type"][n0] = bad[0]
        plan["node_window"][n0] = False
        plan["node_window"][plan["n_open"] - 1] = False
    elif kind == "no_unplaced":
        plan["unplaced"] = None
    elif kind == "empty_plan":
        # nothing opened, every pod unplaced (a pod no type fits)
        plan["n_open"] = 0
        plan["unplaced"] = problem.counts[:len(problem.group_pods)].astype(np.int32)
    return problem, plan


@pytest.mark.parametrize("kind", ["valid", "negative", "conservation", "hostname", "capacity",
                                  "used", "incompatible", "window", "empty_window",
                                  "several", "no_unplaced", "empty_plan"])
def test_validate_plan_equals_reference(kind):
    """The corruptions of the reference's validator test, one per check and
    faults on several nodes, and a plan that opens no node, on frag seed
    0's greedy plan: the same verdict and reason string."""
    ref, ours = encoded("frag0")
    base = _oracle_plan(ours)
    verdicts = []
    for validate, problem in ((jopt.validate_plan, ref), (topt.validate_plan, ours)):
        problem, plan = _corrupt(kind, problem, base)
        verdicts.append(validate(problem, plan["node_type"], plan["node_price"], plan["used"],
                                 plan["placed"], plan["node_window"], plan["n_open"],
                                 plan["unplaced"]))
    assert verdicts[1] == verdicts[0]
    assert verdicts[1][0] == (kind in ("valid", "no_unplaced", "empty_plan")), verdicts[1]


@pytest.mark.parametrize("reason", [
    "negative placement", "pod conservation violated", "hostname cap violated",
    "node capacity exceeded", "used tensor inconsistent with placements",
    "incompatible group on node 3", "empty offering window on node 1",
    "stale node window on node 2", "", None, "something else",
])
def test_classify_reject_equals_reference(reason):
    assert topt.classify_reject(reason) == jopt.classify_reject(reason)


# -- 4. lane 0 of round 0 against the reference's program --------------------------

@pytest.fixture(scope="module")
def reference_lanes():
    """The reference's ``_program`` (2 lanes, ``LANE_ROWS`` rows, seed 0) on
    each case's padded problem, and its logits recomputed from the
    program's own jnp steps: {case: (costs, logits)}."""
    out = {}
    for case in ("frag0", "frag1", "frag2", "config6"):
        ref, _ = encoded(case)
        p = jpad(ref, bucket(len(ref.group_pods)))
        fn = jopt._program_cached(LANE_ROWS, 2)
        costs = np.asarray(fn(p.requests, p.counts, p.compat, p.capacity, p.price,
                              p.group_window, p.type_window, p.max_per_node,
                              jnp.asarray(0, dtype=jnp.uint32))[0])
        cap_safe = jnp.maximum(jnp.asarray(p.capacity), 1e-6)
        slots = jnp.max(jnp.asarray(p.requests)[:, None, :] / cap_safe[None, :, :], axis=-1)
        price = jnp.asarray(p.price)
        usable = jnp.asarray(p.compat) & jnp.isfinite(price)
        charge = jnp.where(usable, price * slots, jnp.inf)
        cmin = jnp.min(charge, axis=1, keepdims=True)
        regret = charge / jnp.maximum(cmin, 1e-9) - 1.0
        out[case] = (costs, np.asarray(jnp.where(usable, -jopt._BETA * regret, -jnp.inf)))
    return out


@pytest.mark.parametrize("case", ["frag0", "frag1", "frag2", "config6"])
def test_lane_zero_matches_reference_program(case, reference_lanes):
    """Logits to 1 ulp on finite entries and the same ``-inf`` pattern;
    lane 0's pick the argmax of the reference's logits; its cost the
    reference's ``costs[0]`` to a relative 1e-6."""
    want_costs, want_logits = reference_lanes[case]
    _, ours = encoded(case)
    padded = pad_problem(ours, bucket(len(ours.group_pods)))
    inp = TorchSolver(device="cpu")._device_inputs(padded)
    logits, _ = topt.lp_logits(inp["requests"], inp["compat"], inp["capacity"], inp["price"])
    got_logits = logits.numpy()
    finite = np.isfinite(want_logits)
    assert np.array_equal(np.isfinite(got_logits), finite)
    assert np.array_equal(got_logits[~finite], want_logits[~finite])
    ulp = np.spacing(np.maximum(np.abs(got_logits[finite]), np.abs(want_logits[finite])))
    assert (np.abs(got_logits[finite] - want_logits[finite]) <= ulp).all()
    out = topt.lane_program(inp, LANE_ROWS, 2, seed=0)
    assert np.array_equal(out["picks"][0, 0].numpy(), want_logits.argmax(axis=1))
    costs = out["costs"].numpy()
    assert costs.shape == want_costs.shape == (6,)
    assert costs[0] == pytest.approx(float(want_costs[0]), rel=1e-6)
    assert costs[0] < topt._UNPLACED_PENALTY  # lane 0 places every pod


def _reference_round(lg, taus, order_taus, key):
    """One round of the reference's ``_program``: each lane's pick and group
    order, from the same ``jax.random`` calls and jnp steps as its
    ``lane_solve``, vmapped over the lanes and jitted."""
    def lane(lg, tau, order_tau, k):
        G, T = lg.shape
        k_pick, k_order = jax.random.split(k)
        pick = jnp.argmax(lg + tau * jax.random.gumbel(k_pick, (G, T), dtype=jnp.float32), axis=1)
        noise = jax.random.gumbel(k_order, (G,), dtype=jnp.float32)
        return pick, jnp.argsort(jnp.arange(G, dtype=jnp.float32) + order_tau * noise)

    keys = jax.random.split(key, taus.shape[0])
    return jax.jit(jax.vmap(lane, in_axes=(None, 0, 0, 0)))(lg, taus, order_taus, keys)


def _noise_part(seed):
    """Keys, fold-ins, splits and 32-bit bits exact; float32 draws within
    ``GUMBEL_ATOL``: 3 rounds x 8 lanes at G 64 and T 768."""
    G, T = 64, 768
    all_noise, all_jitter, _ = topt.draws(seed, 8, G, T, "cpu")
    base = jax.random.PRNGKey(jnp.asarray(seed, dtype=jnp.uint32))
    assert tuple(np.asarray(base).tolist()) == topt.prng_key(seed)
    for rnd in range(3):
        k = jax.random.fold_in(base, rnd)
        assert tuple(np.asarray(k).tolist()) == topt.fold_in(topt.prng_key(seed), rnd)
        lane_keys = jax.random.split(k, 8)
        assert [tuple(x) for x in np.asarray(lane_keys).tolist()] == topt.split(
            topt.fold_in(topt.prng_key(seed), rnd), 8)
        picks, orders = topt.lane_keys(seed, rnd, 8)
        noise, jitter = all_noise[rnd], all_jitter[rnd]
        for lane in range(8):
            k_pick, k_order = jax.random.split(lane_keys[lane])
            assert tuple(np.asarray(k_pick).tolist()) == picks[lane]
            assert tuple(np.asarray(k_order).tolist()) == orders[lane]
            bits = np.asarray(jax.random.bits(k_pick, (G, T), dtype=jnp.uint32))
            got = topt.random_bits([picks[lane]], G * T, "cpu")[0].numpy()
            assert np.array_equal(got, bits.reshape(-1).astype(np.int64))
            want = np.asarray(jax.random.gumbel(k_pick, (G, T), dtype=jnp.float32))
            assert np.abs(noise[lane].numpy() - want).max() <= GUMBEL_ATOL
            want = np.asarray(jax.random.gumbel(k_order, (G,), dtype=jnp.float32))
            assert np.abs(jitter[lane].numpy() - want).max() <= GUMBEL_ATOL


def _picks_part(case):
    """Every lane's pick and group order, round by round, against the
    reference's ``_program`` steps on the same logits: no difference. The
    logits of a round after the first follow the incumbent, which the port
    takes from its own lane costs (held to the reference's by the plan
    part)."""
    _, ours = encoded_any(case)
    padded = pad_problem(ours, bucket(len(ours.group_pods)))
    inp = TorchSolver(device="cpu")._device_inputs(padded)
    logits, usable = topt.lp_logits(inp["requests"], inp["compat"], inp["capacity"],
                                    inp["price"])
    G, T = logits.shape
    out = topt.lane_program(inp, LANE_ROWS, 8, seed=0)
    tau = topt.ladders(8, G, "cpu")
    shared = topt.lane_types(inp, 8)
    costs, picks = out["costs"], out["picks"]
    base = jax.random.PRNGKey(jnp.asarray(0, dtype=jnp.uint32))
    noise, jitter, _ = topt.draws(0, 8, G, T, "cpu")
    lg, differ = logits, 0
    for rnd in range(3):
        got_pick, got_order, _ = topt.lane_inputs(inp, lg, tau[0, rnd], tau[1, rnd], noise[rnd],
                                                  jitter[rnd], shared)
        assert torch.equal(got_pick, picks[rnd])
        want_pick, want_order = _reference_round(jnp.asarray(lg.numpy()),
                                                 jnp.asarray(tau[0, rnd].numpy()),
                                                 jnp.asarray(tau[1, rnd].numpy()),
                                                 jax.random.fold_in(base, rnd))
        differ += int((got_pick.numpy() != np.asarray(want_pick)).any(axis=1).sum())
        differ += int((got_order.numpy() != np.asarray(want_order)).any(axis=1).sum())
        inc = picks[:rnd + 1].reshape(-1, G)[int(costs[:8 * (rnd + 1)].argmin())]
        bonus = torch.where(torch.arange(T)[None, :] == inc[:, None], topt._RECENTER, 0.0)
        lg = torch.where(usable, logits + bonus, -torch.inf)
    assert differ == 0, f"{differ} lane picks or orders differ from the reference's"


def _plan_part(case, monkeypatch):
    """Lane on in both packages: the same outcome, ``lp_gap`` and cost, and
    the same served plan, byte for byte (adopted or not), but for a lane
    cost tie (``LANE_COST_TIES``)."""
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1")
    build = {**CONFIGS, **FRAG}[case]
    pods, pools = build(JAXPKG)
    jsolver_ = TPUSolver()
    want = jsolver_.solve(pods, pools, JAXPKG.CatalogProvider())
    pods, pools = build(TORCHPKG)
    tsolver_ = TorchSolver(device="cpu")
    got = tsolver_.solve(pods, pools, TORCHPKG.CatalogProvider())
    assert tsolver_.timings["opt_lane"] == jsolver_.timings["opt_lane"]
    assert tsolver_.timings.get("lp_gap") == jsolver_.timings.get("lp_gap")
    assert got.total_cost == want.total_cost
    if case in LANE_COST_TIES:
        assert tsolver_.timings["opt_lane"] == "adopted"
        assert _plan(got) != _plan(want)  # a tie the reference's float32 breaks
    else:
        assert _plan(got) == _plan(want)
    return tsolver_.timings["opt_lane"]


@pytest.mark.parametrize("part,case", [
    *[("noise", seed) for seed in (0, 7)],
    *[("picks", case) for case in sorted(CASES) + [f"frag{s}" for s in range(3, 12)]],
    *[("plan", case) for case in ["config3", "config8", *FRAG]],
])
def test_lane_noise_equals_reference(part, case, monkeypatch):
    """The lane's noise is the reference's ``jax.random`` stream (ROADMAP
    C1): keys and bits exact, draws within ``GUMBEL_ATOL``, no lane's pick or
    order different, and the lane-on plan the reference's."""
    if part == "noise":
        _noise_part(case)
    elif part == "picks":
        _picks_part(case)
    else:
        outcome = _plan_part(case, monkeypatch)
        if case == "frag0":
            assert outcome == "adopted"


def test_gumbel_draws_are_fixed_by_the_counter():
    """The noise is a function of (seed, round, lane, stream, element): the
    same call gives the same bits, another seed other bits, each round and
    lane its own, inside (0, 1)'s Gumbel range; a narrower draw is a prefix
    of a wider one's flat elements."""
    noise, jitter, _ = topt.draws(0, 3, 16, 256, "cpu")
    assert noise.shape == (3, 3, 16, 256) and noise.dtype == torch.float32
    assert jitter.shape == (3, 3, 16)
    again = topt.draws(0, 3, 16, 256, "cpu")
    assert torch.equal(noise, again[0]) and torch.equal(jitter, again[1])
    assert not torch.equal(noise, topt.draws(1, 3, 16, 256, "cpu")[0])
    assert not torch.equal(noise[0, 0], noise[0, 1]) and not torch.equal(noise[0], noise[1])
    narrow = topt.draws(0, 3, 8, 256, "cpu")[0]
    assert torch.equal(narrow.reshape(3, 3, -1), noise.reshape(3, 3, -1)[..., :8 * 256])
    assert torch.isfinite(noise).all() and abs(float(noise.mean()) - 0.5772) < 0.05


def test_lane_noise_cache_serves_the_same_draws(monkeypatch):
    """``LaneNoise`` returns ``draws``' values, makes each shape's draws once
    and keeps the newest ``cap``; a solver's second lane-on solve of a shape
    reuses them and serves the same plan."""
    cache = topt.LaneNoise(cap=2)
    first = cache.get(0, 3, 16, 64, "cpu")
    want = topt.draws(0, 3, 16, 64, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(first, want))
    assert cache.get(0, 3, 16, 64, "cpu") is first
    cache.get(1, 3, 16, 64, "cpu")
    cache.get(0, 3, 8, 64, "cpu")  # evicts the oldest: (0, 3, 16, 64)
    assert cache.get(0, 3, 16, 64, "cpu") is not first

    made = []
    real = topt.draws
    monkeypatch.setattr(topt, "draws", lambda *a: made.append(a) or real(*a))
    pods = solve_cases.frag_workload(TORCHPKG, 2)
    solver = TorchSolver(device="cpu")
    plans = [_plan(solver.solve(pods, [_pool(TORCHPKG)], TORCHPKG.CatalogProvider()))
             for _ in range(2)]
    assert solver.timings["opt_lane"] == "adopted"
    assert len(made) == 1 and plans[0] == plans[1]


# -- 5. the plain lane op ------------------------------------------------------------

def test_plain_lanes_equal_per_lane_solves():
    """Three lanes of frag seed 0's round 0 (permuted orders, masked
    prices) through ``ffd_solve_lanes`` equal three plain solves: exact."""
    _, ours = encoded("frag0")
    padded = pad_problem(ours, bucket(len(ours.group_pods)))
    inp = TorchSolver(device="cpu")._device_inputs(padded)
    logits, _ = topt.lp_logits(inp["requests"], inp["compat"], inp["capacity"], inp["price"])
    noise, jitter, tau = topt.draws(0, 3, *logits.shape, "cpu")
    _, orders, args = topt.lane_inputs(inp, logits, tau[0, 0], tau[1, 0], noise[0], jitter[0],
                                       topt.lane_types(inp, 3))
    assert len({tuple(o.tolist()) for o in orders}) > 1  # the orders differ
    got = tffd.ffd_solve_lanes(*args, max_nodes=LANE_ROWS)
    for lane in range(3):
        one = [a[lane] for a in args]
        want = tffd.ffd_solve(*one[:7], max_per_node=one[7], max_nodes=LANE_ROWS)
        for field in want._fields:
            assert torch.equal(getattr(got, field)[lane], getattr(want, field)), (lane, field)
        assert got.total_cost()[lane] == want.total_cost()


# -- 6. the adoption contract ---------------------------------------------------------

def _solve(pods, monkeypatch, lane: bool, **kw):
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER", "1" if lane else "0")
    solver = TorchSolver(device="cpu")
    res = solver.solve(pods, [_pool(TORCHPKG)], TORCHPKG.CatalogProvider(), **kw)
    return solver, res


@pytest.mark.parametrize("seed", [0, 1, 2, 11])
def test_adoption_contract(seed, monkeypatch):
    """Lane on never costs more or places fewer pods than lane off; every
    committed spec fits its type; an adopted plan is strictly cheaper,
    labelled ``+opt-lp`` and carries ``lp_gap > 1``."""
    pods = solve_cases.frag_workload(TORCHPKG, seed)
    catalog = TORCHPKG.CatalogProvider()
    on, res_on = _solve(pods, monkeypatch, lane=True)
    _, res_off = _solve(pods, monkeypatch, lane=False)
    assert res_on.total_cost <= res_off.total_cost + 1e-6
    assert res_on.pods_placed() >= res_off.pods_placed()
    for spec in res_on.node_specs:
        it = catalog.get(spec.instance_type_options[0])
        total = np.zeros_like(np.asarray(it.capacity().v, dtype=np.float64))
        for pod in spec.pods:
            total += np.asarray(pod.requests.v, dtype=np.float64)
        alloc = np.asarray(catalog.allocatable(it).v, dtype=np.float64)
        assert (total <= alloc + 1e-3).all(), spec.instance_type_options[0]
    lane = on.timings["opt_lane"]
    assert lane == "adopted" or lane.startswith("rejected")
    if lane == "adopted":
        assert res_on.total_cost < res_off.total_cost
        assert res_on.provenance["backend"].endswith("+opt-lp")
        assert res_on.provenance["lp_gap"] > 1.0
        assert res_on.provenance["opt_adopted"] == 1


def test_frag_seed_zero_adopts(monkeypatch):
    """Seed 0 of the frag family adopts the lane's plan (the reference's
    adopts the same plan: ``test_lane_noise_equals_reference``)."""
    on, res = _solve(solve_cases.frag_workload(TORCHPKG, 0), monkeypatch, lane=True)
    assert on.timings["opt_lane"] == "adopted" and on.timings["opt_saving"] > 0
    assert res.provenance["backend"] == "torch-plain+opt-lp"
    assert topt.OUTCOMES == {"adopted": 1}


@pytest.mark.parametrize("case", ["frag0", "frag1", "config8"])
def test_lane_plan_options_equal_host_ranking(case, monkeypatch):
    """The lane plan's launch options, ranked on the device inside the
    dispatch (the rows the refine changed re-ranked on the host), equal the
    host ranking of every row, which is how the reference decodes a lane
    plan: the same type lists, spec by spec."""
    real_decode, real_arbitrate = tsolver._decode_nodes, TorchSolver._optimizer_arbitrate
    in_lane, seen = [], []

    def arbitrate(self, *a, **kw):
        in_lane.append(True)
        try:
            return real_arbitrate(self, *a, **kw)
        finally:
            in_lane.pop()

    def decode(*a, ranked_idx=None, ranked_n=None, stale_rank=None, **kw):
        got = real_decode(*a, ranked_idx=ranked_idx, ranked_n=ranked_n, stale_rank=stale_rank,
                          **kw)
        if in_lane:
            assert ranked_idx is not None
            want = real_decode(*a, **kw)
            seen.append(([x.instance_type_options for x in got[0]],
                         [x.instance_type_options for x in want[0]]))
        return got

    monkeypatch.setattr(TorchSolver, "_optimizer_arbitrate", arbitrate)
    monkeypatch.setattr(tsolver, "_decode_nodes", decode)
    pods, pools = CASES[case](TORCHPKG)
    solver = TorchSolver(device="cpu")
    solver.solve(pods, pools, TORCHPKG.CatalogProvider())
    assert solver.timings["opt_lane"] == "adopted"
    assert len(seen) == 1 and seen[0][0] and seen[0][0] == seen[0][1]


# -- 7. determinism and the kill switch -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_same_seed_same_plan(seed, monkeypatch):
    pods = solve_cases.frag_workload(TORCHPKG, 2)
    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER_SEED", str(seed))
    a = _solve(pods, monkeypatch, lane=True)[1]
    b = _solve(pods, monkeypatch, lane=True)[1]
    assert _plan(a) == _plan(b) and a.total_cost == b.total_cost


def test_kill_switch_serves_the_ffd_plan(monkeypatch):
    """``KARPENTER_TPU_OPTIMIZER=0`` gives the plan the lane-on solve held
    as its FFD plan, and ``TPUSolver``'s plan with the lane off."""
    seen = []
    arbitrate = TorchSolver._optimizer_arbitrate

    def spy(self, problem, ffd_out, opt, hist_key):
        seen.append(ffd_out[0])
        return arbitrate(self, problem, ffd_out, opt, hist_key)

    monkeypatch.setattr(TorchSolver, "_optimizer_arbitrate", spy)
    pods = solve_cases.frag_workload(TORCHPKG, 11)
    on, _ = _solve(pods, monkeypatch, lane=True)
    assert on.timings["opt_lane"] == "adopted"
    off, res_off = _solve(pods, monkeypatch, lane=False)
    assert off.timings["opt_lane"] == "disabled"
    assert "+opt-lp" not in res_off.provenance["backend"]
    assert _plan(SimpleResult(seen[0])) == _plan(res_off)
    jpods = solve_cases.frag_workload(JAXPKG, 11)
    want = TPUSolver().solve(jpods, [_pool(JAXPKG)], JAXPKG.CatalogProvider())
    assert _plan(res_off) == _plan(want)


@dataclasses.dataclass
class SimpleResult:
    node_specs: list
    binds: tuple = ()
    unschedulable: tuple = ()


# -- 8. admission ------------------------------------------------------------------------

def test_admission_outcomes(monkeypatch):
    """Each admission outcome leaves the FFD plan in place and is counted
    in ``OUTCOMES``: ``disabled``, ``skipped_large``, ``skipped_existing``,
    ``skipped_tight``."""
    pods = solve_cases.frag_workload(TORCHPKG, 1)
    catalog = TORCHPKG.CatalogProvider()
    solver, _ = _solve(pods, monkeypatch, lane=False)
    assert solver.timings["opt_lane"] == "disabled"

    monkeypatch.setenv("KARPENTER_TPU_OPTIMIZER_MAX_GROUPS", "1")
    solver, _ = _solve(pods, monkeypatch, lane=True)
    assert solver.timings["opt_lane"] == "skipped_large"
    monkeypatch.delenv("KARPENTER_TPU_OPTIMIZER_MAX_GROUPS")

    it = next(t for t in catalog.list() if t.category == "m" and t.vcpus == 16)
    alloc = np.asarray(catalog.allocatable(it).v, dtype=np.float32)
    live = [ExistingNode(name="live-0", nodepool_name="default", instance_type=it.name,
                         zone="zone-a", capacity_type="on-demand",
                         used=np.zeros_like(alloc), allocatable=alloc)]
    solver, res = _solve(pods, monkeypatch, lane=True, existing=live)
    assert solver.timings["opt_lane"] == "skipped_existing" and res.binds
    assert "+opt-lp" not in res.provenance["backend"]

    # a homogeneous wave: its first solve measures the FFD plan's gap to the
    # LP bound; pinned under the threshold, the repeat skips the lane
    wave = TORCHPKG.make_pods(256, "web", {"cpu": "500m", "memory": "1Gi"})
    solver = TorchSolver(device="cpu")
    pool = _pool(TORCHPKG)
    solver.solve(wave, [pool], catalog)
    assert solver.timings["lp_gap"] > 0 and solver._opt_gap_hist
    for key in solver._opt_gap_hist:
        solver._opt_gap_hist[key] = 1.0
    solver.solve(wave, [pool], catalog)
    assert solver.timings["opt_lane"] == "skipped_tight"
    for outcome in ("disabled", "skipped_large", "skipped_existing", "skipped_tight"):
        assert topt.OUTCOMES[outcome] == 1, (outcome, topt.OUTCOMES)


def test_cold_skip_is_refused(monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_OPT_COLD_SKIP", "1")
    with pytest.raises(NotImplementedError, match="COLD_SKIP"):
        _solve(solve_cases.frag_workload(TORCHPKG, 0), monkeypatch, lane=True)


# -- 9. no fallback ------------------------------------------------------------------------

@pytest.mark.parametrize("stage", ["dispatch_optimizer", "fetch"])
def test_lane_failure_raises(stage, monkeypatch):
    """A lane that raises at dispatch or fetch raises out of ``solve()``:
    no FFD plan is served in its place."""
    def boom(*args, **kwargs):
        raise RuntimeError(f"lane lost at {stage}")

    monkeypatch.setattr(topt, stage, boom)
    with pytest.raises(RuntimeError, match="lane lost"):
        _solve(solve_cases.frag_workload(TORCHPKG, 0), monkeypatch, lane=True)


# -- 10. the consolidation arm ----------------------------------------------------------------

class _CT:
    def __init__(self, price):
        self.price = np.asarray(price, dtype=np.float32)


@pytest.mark.parametrize("prices,cand,seed", [
    (np.linspace(0.1, 1.0, 24), list(range(24)), 0),
    (np.linspace(0.1, 1.0, 24), list(range(23, -1, -1)), 3),
    (np.random.RandomState(5).uniform(0.01, 4.0, 40), list(range(40)), 7),
    (np.linspace(0.1, 1.0, 24), [4, 9], 0),
])
def test_replace_sets_equal_reference(prices, cand, seed):
    got = optimizer_replace_sets(_CT(prices), cand, seed=seed)
    assert got == jreplace_sets(_CT(prices), cand, seed=seed)
    assert got == optimizer_replace_sets(_CT(prices), cand, seed=seed)
    for subset in got:
        assert 2 <= len(subset) <= 16 and set(subset) <= set(cand)
