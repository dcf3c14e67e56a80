"""Seeded screen problems that hold the repack kernel to its plain version.

Each case is a tuple of host arrays in ``repack_check``'s argument order:
(free, requests, group_ids, group_counts, cap, candidates). The random
family is the JAX package's ``tests/test_repack_pallas.py::_random_problem``
(copied: this package imports nothing of the JAX package), beside the edge
cases that file checks. ``tests/test_torch_consolidate.py``,
``tests/test_torch_repack_cuda.py`` and ``chip_smoke.py`` share them.
"""

from __future__ import annotations

import numpy as np

#: (N, G, GMAX) of the reference's ``TestKernelParity`` shapes
SHAPES = ((40, 8, 4), (130, 16, 8), (64, 5, 32))


def random_problem(rng, N, G, GMAX, R=9, fill=0.4) -> tuple:
    """The reference's random family; every node is a candidate."""
    free = (rng.rand(N, R) * 8).astype(np.float32)
    requests = (rng.rand(G, R) * 4).astype(np.float32)
    requests[:, 3:] = 0.0
    gids = rng.randint(0, G, (N, GMAX)).astype(np.int32)
    gcounts = ((rng.rand(N, GMAX) < fill).astype(np.int32)
               * rng.randint(1, 4, (N, GMAX))).astype(np.int32)
    compat = rng.rand(G, N) < 0.8
    return free, requests, gids, gcounts, compat, np.arange(N, dtype=np.int32)


def small_cases(seeds: int = 3) -> dict:
    """name -> case: the random family at ``SHAPES`` (seed s takes shape
    s % 3), a candidate subset, an empty node, nothing-fits,
    self-exclusion, and a float hostname cap tight enough that verdicts
    split."""
    cases = {}
    for seed in range(seeds):
        N, G, GMAX = SHAPES[seed % 3]
        cases[f"random{seed}_{N}x{G}x{GMAX}"] = random_problem(
            np.random.RandomState(seed), N, G, GMAX)
    sub = random_problem(np.random.RandomState(3), 60, 10, 6)
    cases["subset"] = sub[:5] + (np.array([3, 17, 42, 59], dtype=np.int32),)
    free, requests, gids, gcounts, compat, cand = random_problem(
        np.random.RandomState(4), 30, 6, 4)
    gcounts[7] = 0
    cases["empty_node"] = (free, requests, gids, gcounts, compat, cand)
    N, G, GMAX, R = 20, 3, 2, 9
    cases["nothing_fits"] = (
        np.zeros((N, R), np.float32), np.ones((G, R), np.float32),
        np.zeros((N, GMAX), np.int32), np.ones((N, GMAX), np.int32),
        np.ones((G, N), bool), np.arange(N, dtype=np.int32),
    )
    free = np.zeros((2, 9), np.float32)
    free[0, 0] = 10.0
    requests = np.zeros((1, 9), np.float32)
    requests[0, 0] = 1.0
    cases["self_exclusion"] = (
        free, requests, np.zeros((2, 1), np.int32), np.array([[1], [0]], np.int32),
        np.ones((1, 2), bool), np.arange(2, dtype=np.int32),
    )
    rng = np.random.RandomState(5)
    free, requests, gids, gcounts, compat, cand = random_problem(rng, 50, 6, 4, fill=0.7)
    free *= 0.6
    hostname_cap = np.where(compat, rng.randint(0, 4, compat.shape), 0).astype(np.float32)
    cases["float_cap"] = (free, requests, gids, gcounts, hostname_cap, cand)
    return cases


def large_cases() -> dict:
    """name -> case past the kernel's shared-memory budget, so it runs on
    the global scratch: N = 8,192 (one tile of the kernel's node loop) and
    N = 12,000 (two tiles, so the placements' prefix carries from the first
    to the second). Compatibility is sparse, so a group has a handful of
    targets and verdicts split; at 12,000 the first tile holds a third as
    many targets as the second, so many candidates need both."""
    rng = np.random.RandomState(6)
    case = random_problem(rng, 8192, 8, 4, R=10)
    compat = rng.rand(8, 8192) < 0.002
    cases = {"global_scratch_8192": case[:4] + (compat,) + case[5:]}
    rng = np.random.RandomState(8)
    case = random_problem(rng, 12000, 8, 4, R=10)
    density = np.where(np.arange(12000) < 8192, 0.0002, 0.0015)
    compat = rng.rand(8, 12000) < density
    cases["two_tiles_12000"] = case[:4] + (compat,) + case[5:]
    return cases
