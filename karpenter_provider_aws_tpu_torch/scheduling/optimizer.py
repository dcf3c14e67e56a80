"""The optimizer lane: beat the greedy FFD, never lose.

The counterpart of the JAX package's ``scheduling/optimizer.py``. Each
eligible solve runs, beside its FFD plan, a device program of three parts:

 1. **LP relaxation.** Each group's fractional slot cost on each usable
    type, ``price_t * max_r(req_gr / cap_tr)``, and from it a relative
    regret against the group's cheapest type; the logits are
    ``-16 * regret`` where the type is usable, ``-inf`` elsewhere.
 2. **Seeded rounding and an annealing repack, in lanes.** ``L`` lanes (8 by
    default) each round the logits to one type per group with Gumbel noise
    at a per-lane temperature (lane 0 takes the plain argmax), jitter the
    FFD group order on a second ladder (odd lanes only), and run the FFD
    with every other type's price masked to ``inf``. Three rounds, each
    re-keyed and cooled by 0.7; rounds after the first add a bonus of 4 to
    the incumbent best lane's picks. A lane's cost is its open rows' prices
    plus 1e6 a pod left unplaced, summed in float64. The lanes of a round
    are ONE launch of the FFD kernel (``ops.ffd_cuda.ffd_solve_lanes``);
    everything else is torch ops on the device, and nothing waits on the
    host until the arbitration fetches the best lane's plan in one copy.
 3. **The host adoption contract** (``TorchSolver._optimizer_arbitrate``):
    the lane's plan is served only when it passes ``validate_plan``, places
    at least as many pods as the FFD plan and, after the same
    ``_refine_plan``, prices strictly cheaper. Otherwise the FFD plan
    serves, byte for byte.

The noise is the reference's own ``jax.random`` stream, rebuilt in int64
torch ops (which give the same integer bits on every device): threefry2x32
keyed as the reference's ``_program`` keys it (``PRNGKey(seed)``,
``fold_in(base, round)``, ``split(k, lanes)``, then ``split(lane_key)``
into a pick key and an order key), the 32-bit bits of
``jax_threefry_partitionable`` (the two output words XORed), and
``jax.random.uniform``'s float32 mantissa trick over ``[tiny, 1)``. Only
the Gumbel transform ``-log(-log(u))`` differs: it is formed in float64 and
rounded to float32, so that the CPU and the card agree (``chip_smoke.py``
counts the values that differ over all 2^23 mantissa inputs); jax forms it
in float32 through XLA's ``log``, and the two differ by at most 9.5e-7
(``tests/test_torch_optimizer.py::test_lane_noise_equals_reference``).
Lane 0 of round 0 draws nothing that matters (its temperatures are 0). The
draws depend only on (seed, lanes, G, T), so a solver keeps its newest
shapes' draws (``LaneNoise``) and a later solve of a shape bucket reuses them.

There is no breaker and no fallback: a lane that raises raises out of the
solve. Only the contract's algorithmic outcomes leave the FFD plan in place.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from ..ops import ffd_cuda
from ..ops.ffd import compact_plan, rank_launch_options

#: cost per unplaced pod inside lane selection: dominates any real fleet
#: price, so a lane can never win by leaving work behind
_UNPLACED_PENALTY = 1.0e6
#: relative-regret sharpening of the LP weights
_BETA = 16.0
#: annealing schedule: rounds of lane restarts, per-round ladder cooling,
#: and the logits bonus recentering each round on the incumbent best
_ROUNDS = 3
_COOL = 0.7
_RECENTER = 4.0

#: lane outcomes since the last reset (adopted, rejected, skipped_large,
#: skipped_existing, skipped_tight, disabled); each also counts on the
#: reference's ``karpenter_optimizer_lane_total{outcome}``, which never resets
OUTCOMES: dict = {}


def optimizer_enabled() -> bool:
    """The kill switch, read per solve: ``KARPENTER_TPU_OPTIMIZER=0``
    serves the FFD plan alone, byte-identical to a solve without the lane."""
    return os.environ.get("KARPENTER_TPU_OPTIMIZER", "1") != "0"


def optimizer_lanes() -> int:
    """Lanes per round (``_ROUNDS`` rounds run)."""
    return max(2, int(os.environ.get("KARPENTER_TPU_OPTIMIZER_LANES", "8")))


def tight_threshold() -> float:
    """FFD-cost / LP-bound ratio under which the lane is provably not worth
    dispatching (``skipped_tight``)."""
    return float(os.environ.get("KARPENTER_TPU_OPTIMIZER_TIGHT", "1.01"))


def max_groups() -> int:
    """Group-axis ceiling for a lane dispatch (``skipped_large``)."""
    return int(os.environ.get("KARPENTER_TPU_OPTIMIZER_MAX_GROUPS", "2048"))


def optimizer_seed() -> int:
    return int(os.environ.get("KARPENTER_TPU_OPTIMIZER_SEED", "0"))


def refuse_cold_skip() -> None:
    """Lazy lane admission on a cold start rides the reference's compile
    ledger and warmup manifest, which this package does not carry:
    ``KARPENTER_TPU_OPT_COLD_SKIP=1`` raises. Its default ``auto`` means off
    here, as in any reference process without a warmup manifest."""
    value = os.environ.get("KARPENTER_TPU_OPT_COLD_SKIP", "auto")
    if value not in ("0", "auto"):
        raise NotImplementedError(
            f"lazy lane admission (KARPENTER_TPU_OPT_COLD_SKIP={value}) is not supported "
            "by the torch solver yet"
        )


def count_outcome(outcome: str, n: int = 1) -> None:
    from ..metrics import OPTIMIZER_LANE

    OUTCOMES[outcome] = OUTCOMES.get(outcome, 0) + n
    OPTIMIZER_LANE.inc(n, outcome=outcome)


def gap_key(problem, hist_key) -> tuple:
    """Admission-memory key: the solver's shape-bucket signature plus a
    content digest of the problem's group tensors (a tight homogeneous wave
    must not suppress the lane on a fragmented burst of the same buckets),
    memoized on the problem object."""
    hit = problem.__dict__.get("_opt_gap_digest")
    if hit is None:
        G = len(problem.group_pods)
        h = hashlib.blake2b(digest_size=8)
        h.update(np.ascontiguousarray(problem.requests[:G]))
        h.update(np.ascontiguousarray(problem.counts[:G]))
        h.update(np.ascontiguousarray(problem.price[:G]))
        hit = problem.__dict__["_opt_gap_digest"] = h.digest()
    return (hist_key, hit)


def lp_bound_for(problem) -> float:
    """``scheduling.solver.lp_lower_bound`` memoized on the problem object."""
    hit = problem.__dict__.get("_lp_bound_memo")
    if hit is None:
        from .solver import lp_lower_bound

        hit = problem.__dict__["_lp_bound_memo"] = float(lp_lower_bound(problem))
    return hit


# ---------------------------------------------------------------------------
# the lane program
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
#: threefry2x32's rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: float32's smallest normal value, ``jax.random.gumbel``'s uniform floor
_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of ``jax._src.prng``, on Python
    ints or int64 tensors holding values in [0, 2^32); keys and counters
    broadcast against each other. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a, b = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = (((b << r) & _M32) | (b >> (32 - r))) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + i + 1) & _M32
    return a, b


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey`` of a uint32 seed: the words (0, seed)."""
    return (0, int(seed) & _M32)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: threefry of the counters (0, data), split
    into halves as ``threefry_2x32`` splits a two-element count."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def split(key: tuple, num: int = 2) -> list:
    """``jax.random.split`` with ``jax_threefry_partitionable``: key ``i``
    is both output words of threefry on the counters (0, i)."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def lane_keys(seed: int, rnd: int, lanes: int) -> tuple:
    """Round ``rnd``'s per-lane (pick, order) keys, as the reference's
    ``_program`` derives them: ``split(fold_in(PRNGKey(seed), rnd),
    lanes)``, then ``split`` of each lane's key."""
    pairs = [split(k) for k in split(fold_in(prng_key(seed), rnd), lanes)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def random_bits(keys: list, n: int, device) -> torch.Tensor:
    """[len(keys), n] 32-bit draws (int64 in [0, 2^32)) of each key over
    the flat element index, as ``jax.random.bits`` with
    ``jax_threefry_partitionable``: the counters (0, i), the two output
    words XORed."""
    k = torch.tensor(keys, dtype=torch.int64, device=device)               # [K, 2]
    idx = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(k[:, :1], k[:, 1:], 0, idx[None])
    return a ^ b


def gumbel_of_mantissa(m: torch.Tensor) -> torch.Tensor:
    """The float32 Gumbel value of 23-bit mantissas (int64 in [0, 2^23)):
    ``jax.random.uniform``'s ``u = max(tiny, f * (1 - tiny) + tiny)`` of
    ``f = bitcast(m | 0x3F800000) - 1`` in float32, then ``-log(-log(u))``
    in float64, rounded to float32."""
    f = (m | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(f * (1.0 - _TINY) + _TINY, min=_TINY)
    return (-torch.log(-torch.log(u.double()))).to(torch.float32)


def gumbel_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The float32 Gumbel value of 32-bit draws: their top 23 bits."""
    return gumbel_of_mantissa(bits >> 9)


def ladders(lanes: int, groups: int, device) -> torch.Tensor:
    """The temperature ladders [2, rounds, lanes]: type noise ``[0,
    geomspace(0.2, 3, L - 1)]`` and, on odd lanes only, order noise
    ``geomspace(2, max(G / 2, 4), L)`` over the padded group count, round r
    cooled by ``0.7 ** r`` (float32, as the reference computes them)."""
    taus = np.concatenate([[0.0], np.geomspace(0.2, 3.0, lanes - 1)]).astype(np.float32)
    order_taus = np.where(np.arange(lanes) % 2 == 1,
                          np.geomspace(2.0, max(groups / 2.0, 4.0), lanes),
                          0.0).astype(np.float32)
    ladder = np.stack([np.stack([t * np.float32(_COOL ** r) for r in range(_ROUNDS)])
                       for t in (taus, order_taus)])
    return torch.from_numpy(ladder).to(device)


def lp_logits(requests, compat, capacity, price) -> tuple[torch.Tensor, torch.Tensor]:
    """The LP relaxation's relative-regret logits [G, T] (``-inf`` where the
    type is unusable) and the usable mask, in the reference's float32 steps."""
    inf = torch.tensor(float("inf"), device=price.device)
    cap_safe = torch.clamp(capacity, min=1e-6)                                  # [T, R]
    slots = (requests[:, None, :] / cap_safe[None, :, :]).amax(dim=-1)          # [G, T]
    usable = compat & torch.isfinite(price)
    charge = torch.where(usable, price * slots, inf)
    cmin = charge.amin(dim=1, keepdim=True)                                     # [G, 1]
    regret = charge / torch.clamp(cmin, min=1e-9) - 1.0
    return torch.where(usable, -_BETA * regret, -inf), usable


def draws(seed: int, lanes: int, groups: int, types: int, device):
    """Every round's noise, drawn at once (no draw depends on a result): type
    noise [rounds, lanes, G, T] and order noise [rounds, lanes, G], as
    ``jax.random.gumbel(k_pick, (G, T))`` and ``gumbel(k_order, (G,))`` draw
    them for each round's lanes, each in ONE threefry call over every
    round's lane keys; and ``ladders``."""
    keys = [lane_keys(seed, r, lanes) for r in range(_ROUNDS)]
    pick = [k for pk, _ in keys for k in pk]
    order = [k for _, ok in keys for k in ok]
    noise = gumbel_of_bits(random_bits(pick, groups * types, device))
    jitter = gumbel_of_bits(random_bits(order, groups, device))
    return (noise.view(_ROUNDS, lanes, groups, types), jitter.view(_ROUNDS, lanes, groups),
            ladders(lanes, groups, device))


class LaneNoise:
    """``draws`` by (seed, lanes, G, T, device), the newest ``cap`` kept. The
    noise depends on nothing else, so a solver that solves a shape bucket
    again reuses its draws instead of enqueuing the threefry ops again; the
    values are ``draws``' own. Callers only read the tensors."""

    def __init__(self, cap: int = 4):
        self.cap = cap
        self._draws: dict = {}

    def get(self, seed: int, lanes: int, groups: int, types: int, device) -> tuple:
        key = (int(seed), int(lanes), int(groups), int(types), str(torch.device(device)))
        hit = self._draws.pop(key, None)
        if hit is None:
            hit = draws(seed, lanes, groups, types, device)
        self._draws[key] = hit
        while len(self._draws) > self.cap:
            self._draws.pop(next(iter(self._draws)))
        return hit


def lane_types(inp: dict, lanes: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The type-axis inputs every lane shares, one copy a lane (the kernel
    offsets every input by its lane): capacity [L, T, R] and the type
    window bits [L, T]. Built once per lane program."""
    T, R = inp["capacity"].shape
    return (inp["capacity"].expand(lanes, T, R).contiguous(),
            inp["type_window"].expand(lanes, T).contiguous())


def lane_inputs(inp: dict, lg: torch.Tensor, tau, order_tau, noise, jitter, shared: tuple):
    """One round's lanes: each lane's type pick per group (argmax of the
    logits plus tau times its noise), its group order (a stable argsort of
    the index plus order tau times its noise), and the FFD inputs in that
    order with every type but the pick priced ``inf``. ``tau``,
    ``order_tau`` [L], ``noise`` [L, G, T] and ``jitter`` [L, G] are one
    round's of ``draws``; ``shared`` is ``lane_types(inp, L)``. Returns
    (picks [L, G] in encode order, orders [L, G], the kernel's inputs with a
    leading lane axis)."""
    G, T = lg.shape
    dev = lg.device
    capacity, type_window = shared
    picks = (lg[None] + tau[:, None, None] * noise).argmax(dim=-1)               # [L, G]
    keys = torch.arange(G, dtype=torch.float32, device=dev)[None] + order_tau[:, None] * jitter
    orders = torch.argsort(keys, dim=1, stable=True)                             # [L, G]
    pick_perm = picks.gather(1, orders)
    types = torch.arange(T, device=dev)
    price = torch.where(types == pick_perm[..., None], inp["price"][orders],
                        torch.tensor(float("inf"), device=dev))
    args = (inp["requests"][orders], inp["counts"][orders], inp["compat"][orders],
            capacity, price, inp["group_window"][orders], type_window,
            inp["max_per_node"][orders])
    return picks, orders, args


def first_round(inp: dict, lanes: int, seed: int = 0) -> tuple:
    """Round 0's lanes on ``inp``, as ``lane_program`` builds them: the FFD
    kernel's inputs with a leading lane axis (lanes differing in group order
    and price mask), to hold the lane launch to plain solves."""
    logits, _ = lp_logits(inp["requests"], inp["compat"], inp["capacity"], inp["price"])
    noise, jitter, tau = draws(seed, lanes, *logits.shape, logits.device)
    return lane_inputs(inp, logits, tau[0, 0], tau[1, 0], noise[0], jitter[0],
                       lane_types(inp, lanes))[2]


_FIELDS = ("node_type", "node_price", "node_window", "n_open", "used", "placed", "unplaced")


def lane_program(inp: dict, max_nodes: int, lanes: int, seed: int,
                 noise_cache: Optional[LaneNoise] = None) -> dict:
    """The whole lane program on the inputs' device, as the reference's
    ``_program`` computes it: ``_ROUNDS`` rounds of ``lanes`` FFD solves
    (one ``ffd_solve_lanes`` call a round), then the best of all lanes.

    Returns device tensors: ``costs`` [rounds * lanes] float64 (round-major,
    as the reference concatenates them), ``picks`` [rounds, lanes, G], the
    best lane's ``node_type``, ``node_price``, ``node_window``, ``n_open``,
    ``used`` [N, R], and its ``placed`` [G, N] and ``unplaced`` [G] in
    encode group order; ``input_bytes``, the bytes one round's lane inputs
    take. Nothing here waits on the device: the winner is picked with
    ``index_select`` by a device index, never by a host one. ``noise_cache``,
    where given, serves the draws."""
    logits, usable = lp_logits(inp["requests"], inp["compat"], inp["capacity"], inp["price"])
    G, T = logits.shape
    dev = logits.device
    draw = draws if noise_cache is None else noise_cache.get
    noise, jitter, tau = draw(seed, lanes, G, T, dev)
    shared = lane_types(inp, lanes)
    types = torch.arange(T, device=dev)
    costs, picks, best_costs, best = [], [], [], []
    lg = logits
    for rnd in range(_ROUNDS):
        pk, orders, args = lane_inputs(inp, lg, tau[0, rnd], tau[1, rnd], noise[rnd],
                                       jitter[rnd], shared)
        res = ffd_cuda.ffd_solve_lanes(*args, max_nodes=max_nodes)
        cost = res.total_cost() + _UNPLACED_PENALTY * res.unplaced.sum(dim=1).double()
        costs.append(cost)
        picks.append(pk)
        # the round's best lane (first of equals), then the best of the rounds
        # so far: the argmin over every lane run so far, without keeping them
        b = cost.argmin().reshape(1)
        best_costs.append(cost.index_select(0, b))
        best.append({"pick": pk.index_select(0, b)[0], "order": orders.index_select(0, b)[0],
                     **{f: getattr(res, f).index_select(0, b)[0] for f in _FIELDS}})
        inc = torch.cat(best_costs).argmin().reshape(1)
        incumbent = torch.stack([x["pick"] for x in best]).index_select(0, inc)[0]   # [G]
        bonus = torch.where(types[None, :] == incumbent[:, None], _RECENTER, 0.0)
        lg = torch.where(usable, logits + bonus, -torch.inf)
    win = {k: torch.stack([x[k] for x in best]).index_select(0, inc)[0] for k in best[0]}
    # the winner's groups back into encode order
    placed = torch.empty_like(win["placed"]).index_copy_(0, win["order"], win["placed"])
    unplaced = torch.empty_like(win["unplaced"]).index_copy_(0, win["order"], win["unplaced"])
    return {"costs": torch.cat(costs), "picks": torch.stack(picks),
            "node_type": win["node_type"], "node_price": win["node_price"],
            "node_window": win["node_window"], "n_open": win["n_open"], "used": win["used"],
            "placed": placed, "unplaced": unplaced,
            "input_bytes": sum(t.numel() * t.element_size() for t in args)}


def dispatch_optimizer(inp: dict, max_nodes: int, rank_k: int, seed: Optional[int] = None,
                       lanes: Optional[int] = None,
                       noise_cache: Optional[LaneNoise] = None) -> dict:
    """Enqueue the lane program on the solver's device inputs (the padded
    problem's tensors, uploaded once per problem), rank the best plan's
    launch options on the device (``rank_launch_options``, the ``rank_k``
    cheapest types a row, as the FFD plan's are ranked) and pack what the
    arbitration fetches into one buffer: nothing waits on the device here.
    A failure raises: the caller does not catch it."""
    lanes = lanes or optimizer_lanes()
    seed = optimizer_seed() if seed is None else int(seed)
    out = lane_program(inp, int(max_nodes), int(lanes), seed, noise_cache=noise_cache)
    GB = inp["requests"].shape[0]
    E = int(max(1024, 4 * GB, 2 * max_nodes))
    nz, cnt, total_nz = compact_plan(out["placed"], E)
    ranked_idx, ranked_n, _best = rank_launch_options(
        out["placed"], inp["price"], out["used"], inp["capacity"], inp["type_window"],
        out["node_window"], out["node_type"], inp["exotic"], k=rank_k,
    )
    parts = [
        ("costs", out["costs"].view(torch.int32)), ("node_type", out["node_type"]),
        ("node_price", out["node_price"].view(torch.int32)),
        ("n_open", out["n_open"].reshape(1)), ("node_window", out["node_window"]),
        ("unplaced", out["unplaced"]), ("nz", nz), ("nz_cnt", cnt),
        ("total_nz", total_nz.reshape(1)),
        ("ranked_idx", ranked_idx.to(torch.int32).reshape(-1)),
        ("ranked_n", ranked_n.to(torch.int32)),
    ]
    return {"flat": torch.cat([t for _, t in parts]),
            "layout": [(name, t.numel()) for name, t in parts],
            "placed_dev": out["placed"], "rows": int(max_nodes), "GB": GB,
            "rank_k": int(ranked_idx.shape[1]),
            "lanes": int(lanes), "input_bytes": out["input_bytes"]}


def fetch(opt: dict) -> dict:
    """The dispatched lane's best plan on the host, in ONE device-to-host
    copy: costs [rounds * lanes] float64, node_type, node_price, n_open,
    node_window bits, unplaced, the sparse plan (nz, nz_cnt, total_nz) and
    the ranked launch options (ranked_idx [N, k], ranked_n [N])."""
    flat = opt["flat"].cpu().numpy()
    out, off = {}, 0
    for name, n in opt["layout"]:
        out[name] = flat[off:off + n]
        off += n
    out["costs"] = out["costs"].view(np.float64)
    out["node_price"] = out["node_price"].view(np.float32)
    out["n_open"] = int(out["n_open"][0])
    out["total_nz"] = int(out["total_nz"][0])
    out["ranked_idx"] = out["ranked_idx"].reshape(opt["rows"], opt["rank_k"])
    return out


# ---------------------------------------------------------------------------
# host-side adoption contract
# ---------------------------------------------------------------------------

def classify_reject(reason: str) -> str:
    """Map a ``validate_plan`` rejection string onto the why-engine's
    constraint-plane vocabulary."""
    r = reason or ""
    if "conservation" in r or "negative placement" in r:
        return "lane:validator:conservation"
    if "hostname cap" in r:
        return "lane:validator:hostname"
    if "capacity exceeded" in r or "used tensor" in r:
        return "lane:validator:shape"
    if "incompatible group" in r:
        return "lane:validator:requirements"
    if "offering window" in r or "node window" in r:
        return "lane:validator:offering-dark"
    return "lane:validator"


def validate_plan(problem, node_type, node_price, used, placed, node_window,
                  n_open: int, unplaced=None) -> tuple[bool, str]:
    """The host validator every adopted lane plan must pass: pod
    conservation, per-node capacity, group/type compatibility and finite
    price, a live joint (zone, captype) offering window per node, and
    hostname caps. Pure numpy; a False verdict costs the solve the lane
    only (the FFD plan serves)."""
    G = len(problem.group_pods)
    eps = 1e-3
    placed = placed[:G, :n_open]
    if (placed < 0).any():
        return False, "negative placement"
    have = placed.sum(axis=1)
    if unplaced is not None:
        if (have + unplaced[:G] != problem.counts[:G]).any():
            return False, "pod conservation violated"
    elif (have > problem.counts[:G]).any():
        return False, "pod conservation violated"
    if problem.max_per_node is not None:
        if (placed > problem.max_per_node[:G, None]).any():
            return False, "hostname cap violated"
    cap = problem.capacity[node_type[:n_open]]                # [n, R]
    load = placed.T.astype(np.float64) @ problem.requests[:G]
    if (load > cap + eps).any():
        return False, "node capacity exceeded"
    if used is not None and not np.allclose(
        load, used[:n_open], rtol=1e-3, atol=1e-2
    ):
        return False, "used tensor inconsistent with placements"
    # per node holding pods, in node order, the first of: a group that
    # cannot use the node's type, an empty joint offering window (the type's
    # window and every group's on it), a node window outside it
    on = placed > 0                                           # [G, n]
    t = np.asarray(node_type[:n_open], dtype=np.int64)
    usable = problem.compat[:G][:, t] & np.isfinite(problem.price[:G][:, t])
    bad_compat = (on & ~usable).any(axis=0)
    gw = problem.group_window[:G]
    # groups on each node that lack each (zone, captype) bit: a 0/1 product,
    # exact in float32 below 2^24 groups
    zc = int(np.prod(gw.shape[1:]))                           # (zone, captype) bits
    missing = on.T.astype(np.float32) @ (~gw).reshape(G, zc).astype(np.float32)
    w = problem.type_window[t] & (missing == 0).reshape(t.shape[0], *gw.shape[1:])
    empty = ~w.reshape(t.shape[0], zc).any(axis=1)
    stale = np.zeros_like(empty)
    if node_window is not None:
        stale = ~(node_window[:n_open] & w).reshape(t.shape[0], zc).any(axis=1)
    bad = on.any(axis=0) & (bad_compat | empty | stale)
    if bad.any():
        n = int(np.argmax(bad))
        if bad_compat[n]:
            return False, f"incompatible group on node {n}"
        if empty[n]:
            return False, f"empty offering window on node {n}"
        return False, f"stale node window on node {n}"
    return True, ""
