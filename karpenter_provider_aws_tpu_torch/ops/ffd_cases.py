"""Seeded solve problems that hold the FFD kernel to its plain version.

Each case is a tuple ``(args, max_nodes, init, n_pre, Z, C)``: ``args`` are
the host arrays in ``ffd_solve``'s argument order (requests, counts, compat,
capacity, price, group window [G, Z, C] bool, type window [T, Z, C] bool,
max_per_node); ``init`` is None or the pre-opened rows' (node_type,
node_price, used, node_cap, node_window [N, Z, C] bool), the first ``n_pre``
of them open. Every group with a nonzero count requests something, so the
JAX package's scan (an int32 prefix) is exact on them. ``tests/test_torch_ffd.py``
(against the JAX package on the CPU), ``tests/test_torch_ffd_cuda.py`` and
``chip_smoke.py`` (the kernel against the plain version on the card) share
them.
"""

from __future__ import annotations

import numpy as np

_BIG = 1 << 30


def random_problem(rng, G, T, R, Z, C) -> tuple:
    """Pods request cpu, memory and the pods axis; 70% compatibility, 80%
    window bits, a fifth of the groups hostname-capped at 1..4 a row."""
    requests = np.zeros((G, R), dtype=np.float32)
    requests[:, 0] = rng.choice([100, 250, 500, 1000, 2000], G)
    requests[:, 1] = rng.choice([256, 512, 1024, 4096], G)
    requests[:, 2] = 1.0  # the pods axis
    counts = rng.randint(1, 40, G).astype(np.int32)
    compat = rng.rand(G, T) < 0.7
    compat[:, 0] = True
    capacity = np.zeros((T, R), dtype=np.float32)
    capacity[:, 0] = rng.choice([4000, 8000, 16000, 32000], T)
    capacity[:, 1] = rng.choice([8192, 16384, 65536], T)
    capacity[:, 2] = rng.choice([29, 58, 110, 250], T)
    price = np.where(
        compat, rng.uniform(0.05, 3.0, (G, T)).astype(np.float32), np.inf
    ).astype(np.float32)
    group_window = rng.rand(G, Z, C) < 0.8
    group_window[:, 0, 0] = True
    type_window = rng.rand(T, Z, C) < 0.8
    type_window[:, 0, 0] = True
    mpn = np.where(rng.rand(G) < 0.2, rng.randint(1, 5, G), _BIG).astype(np.int32)
    return requests, counts, compat, capacity, price, group_window, type_window, mpn


def pre_opened(rng, capacity, type_window, N, R, n_pre) -> tuple:
    """``n_pre`` live rows of random types, 20-60% used, price 0."""
    T, Z, C = type_window.shape
    node_type = np.zeros(N, dtype=np.int32)
    node_price = np.zeros(N, dtype=np.float32)
    used = np.zeros((N, R), dtype=np.float32)
    node_cap = np.zeros((N, R), dtype=np.float32)
    node_window = np.zeros((N, Z, C), dtype=bool)
    for i in range(n_pre):
        t = rng.randint(T)
        node_type[i] = t
        node_cap[i] = capacity[t]
        used[i] = capacity[t] * rng.uniform(0.2, 0.6)
        node_window[i] = type_window[t]
    return node_type, node_price, used, node_cap, node_window


def small_cases(seeds: int = 4) -> dict:
    """name -> case, small enough for the JAX package's Pallas kernel in
    interpret mode. The kernel keeps up to ~2,000-3,000 rows on one CTA and
    spreads more over 8 CTAs, each holding a slice of ``ceil(N / 8)`` rows
    (``ops.ffd_cuda.active_ctas``); ``open_span`` and
    ``exhaustion_boundary`` aim at those slices' edges."""
    cases = {}
    for seed in range(seeds):
        rng = np.random.RandomState(seed)
        cases[f"random{seed}"] = (random_problem(rng, 12, 40, 4, 3, 3), 256, None, 0, 3, 3)
    args = list(random_problem(np.random.RandomState(7), 8, 10, 4, 2, 3))
    args[1] = (args[1] * 50).astype(np.int32)  # overflow 16 rows
    cases["row_exhaustion"] = (tuple(args), 16, None, 0, 2, 3)
    rng = np.random.RandomState(11)
    args = list(random_problem(rng, 6, 20, 4, 3, 3))
    args[7][:] = _BIG  # pre-row fill requires uncapped groups
    cases["pre_opened"] = (tuple(args), 128, pre_opened(rng, args[3], args[6], 128, 4, 5),
                           5, 3, 3)
    # count-0 groups between real ones, not only at the end
    args = list(random_problem(np.random.RandomState(12), 16, 40, 4, 3, 3))
    args[1][[1, 2, 5, 8, 9, 13]] = 0
    cases["interleaved_zero_counts"] = (tuple(args), 256, None, 0, 3, 3)
    # 4,096 rows are eight 512-row slices. The first group opens 2,250 rows
    # in one trip, across five; the second first-fits two a row into their
    # slack, a prefix that crosses two slice edges.
    args = list(random_problem(np.random.RandomState(13), 4, 10, 4, 2, 3))
    args[0][:2, :3] = ((1500, 1024, 1), (500, 256, 1))
    args[1][:] = (4500, 3000, 15, 12)
    args[3][:, :3] = (4000, 8192, 29)
    args[7][:] = _BIG
    cases["open_span"] = (tuple(args), 4096, None, 0, 2, 3)
    # 3,300 rows are eight slices of 413: the first group opens 1,500 rows,
    # the second runs out of rows in a trip over [1,500, 3,300), which
    # crosses four slice edges
    args = list(random_problem(np.random.RandomState(16), 3, 10, 4, 2, 3))
    args[0][:2, :3] = ((2000, 1024, 1), (1000, 512, 1))
    args[1][:] = (3000, 10000, 7)
    args[3][:, :3] = (4000, 8192, 29)
    args[7][:] = _BIG
    cases["exhaustion_boundary"] = (tuple(args), 3300, None, 0, 2, 3)
    # R = 16: the sixteenth axis requested by some groups
    rng = np.random.RandomState(15)
    args = list(random_problem(rng, 10, 30, 16, 3, 3))
    args[0][:, 15] = rng.choice([0.0, 1.0, 2.0], 10)
    args[3][:, 15] = rng.choice([50.0, 100.0], 30)
    cases["r16"] = (tuple(args), 128, None, 0, 3, 3)
    # pre-opened rows beside hostname-capped groups, which must stay off them
    rng = np.random.RandomState(14)
    args = list(random_problem(rng, 8, 20, 4, 3, 3))
    args[7][:] = np.array([_BIG, 2, _BIG, 1, _BIG, 3, _BIG, _BIG], dtype=np.int32)
    cases["pre_opened_capped"] = (tuple(args), 128, pre_opened(rng, args[3], args[6], 128, 4, 8),
                                  8, 3, 3)
    return cases


def card_cases() -> dict:
    """name -> case that only the kernel's test on the card holds: too large
    for Pallas interpret mode, or one the JAX package's scan gets wrong. The
    global-memory branch (20,480 rows at R = 10, past the shared-memory
    budget, 12,000 of them a pre-opened live fleet), T at the wrapper's
    maximum (2,048), and a group that requests nothing on six pre-opened
    rows (it fits 2^30 a row, so an int32 prefix would wrap)."""
    rng = np.random.RandomState(21)
    N, R, n_pre = 20_480, 10, 12_000
    args = list(random_problem(rng, 64, 200, R, 4, 3))
    args[1] = rng.randint(50, 400, 64).astype(np.int32)
    cases = {"global_branch": (tuple(args), N, pre_opened(rng, args[3], args[6], N, R, n_pre),
                               n_pre, 4, 3)}
    args = random_problem(np.random.RandomState(22), 24, 2048, 4, 3, 3)
    cases["t_max"] = (args, 512, None, 0, 3, 3)
    N, R, T, n_pre = 8, 3, 2, 6
    ones = np.ones((1, 1), dtype=bool)
    args = (np.zeros((1, R), np.float32), np.array([10], np.int32), np.ones((1, T), bool),
            np.full((T, R), 100.0, np.float32), np.ones((1, T), np.float32), ones[None],
            np.ones((T, 1, 1), bool), np.array([_BIG], np.int32))
    init = (np.zeros(N, np.int32), np.zeros(N, np.float32), np.zeros((N, R), np.float32),
            np.full((N, R), 100.0, np.float32), np.ones((N, 1, 1), bool))
    cases["zero_request"] = (args, N, init, n_pre, 1, 1)
    return cases
