"""Seeded screen problems that hold the repack kernel to its plain version.

Each case is a tuple of host arrays in ``repack_check``'s argument order:
(free, requests, group_ids, group_counts, cap, candidates). The random
family is the JAX package's ``tests/test_repack_pallas.py::_random_problem``
(copied: this package imports nothing of the JAX package), beside the edge
cases that file checks, cases aimed at the kernel's table design
(``path_cases``), two wide ones (``large_cases``), a dense cluster of
large nodes (``dense_cases``) and an encoded cluster padded as the
device-resident mirror holds it (``mirror_cases``).
``tests/test_torch_consolidate.py``, ``tests/test_torch_repack_table.py``,
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


def path_cases() -> dict:
    """name -> case aimed at one part of the kernel's table design:

    - ``long_touch``: candidates whose live slots before the last hold
      hundreds of pods, placed one a row, so they fill hundreds of rows
      (one passes, one fails), beside candidates of one or two pods;
    - ``repeat_group``: one group in several slots of each candidate on
      rows with room for two or three pods, so a row is touched twice;
    - ``negative_count``: counts below zero after a slot that left pods
      unplaced (they cancel it, as in the plain version), zero counts
      between live slots, and a negative count after the last live one;
    - ``no_groups``: nodes without pods (G = 0, S = 0): every one passes.
    """
    cases = {}
    N, R = 300, 9
    free = np.zeros((N, R), np.float32)
    free[:, 0] = 1.5  # one pod of group 0 a row
    free[:, 1] = 8.0
    requests = np.zeros((3, R), np.float32)
    requests[0, 0] = 1.0
    requests[1, 1] = 2.0
    requests[2, :2] = (0.25, 1.0)
    gids = np.tile(np.array([[0, 1, 2, 1]], np.int32), (N, 1))
    gcounts = np.tile(np.array([[1, 1, 0, 2]], np.int32), (N, 1))
    gcounts[0] = (100, 60, 0, 3)     # 160 pods before the last slot: passes
    gcounts[1] = (300, 40, 9, 1)     # 299 rows hold 299 pods of group 0: fails
    gids[2], gcounts[2] = (0, 2, 0, 1), (129, 1, 0, 1)  # 129 rows, then group 2
    gcounts[3] = (128, 0, 0, 1)      # 128 rows
    compat = np.ones((3, N), bool)
    compat[2, ::3] = False
    cases["long_touch"] = (free, requests, gids, gcounts, compat,
                           np.arange(N, dtype=np.int32))

    rng = np.random.RandomState(9)
    N, G, S = 48, 2, 6
    free = np.zeros((N, R), np.float32)
    free[:, 0] = rng.choice([2.5, 3.5], N).astype(np.float32)
    free[:, 1] = (rng.rand(N) * 3).astype(np.float32)
    requests = np.zeros((G, R), np.float32)
    requests[0, 0] = 1.0
    requests[1, :2] = (0.5, 0.75)
    gids = rng.randint(0, G, (N, S)).astype(np.int32)
    gcounts = rng.randint(0, 4, (N, S)).astype(np.int32)
    cap = np.where(rng.rand(G, N) < 0.15, rng.randint(1, 4, (G, N)), 0).astype(np.float32)
    cases["repeat_group"] = (free, requests, gids, gcounts, cap,
                             np.arange(N, dtype=np.int32))

    N = 6
    free = np.zeros((N, R), np.float32)
    free[:, 0] = (1.0, 1.0, 2.0, 0.0, 1.0, 0.5)
    requests = np.zeros((2, R), np.float32)
    requests[0, 0] = 1.0
    requests[1, 0] = 0.5
    gids = np.zeros((N, 4), np.int32)
    gids[:, 1] = 1
    gcounts = np.array([[6, -2, 0, 0],    # 4 fit, -2 cancels the 2 left: passes
                        [9, 0, -3, 0],    # 4 fit, -3 leaves 2: fails
                        [3, 0, 1, -1],    # a live slot after the unplaced one
                        [0, 0, 0, -1],    # nothing live: -1, fails
                        [5, 2, -1, -4],   # both live slots short
                        [-1, 1, 0, 0]], np.int32)
    cases["negative_count"] = (free, requests, gids, gcounts, np.ones((2, N), bool),
                               np.arange(N, dtype=np.int32))
    cases["no_groups"] = (np.ones((3, R), np.float32), np.zeros((0, R), np.float32),
                          np.zeros((3, 0), np.int32), np.zeros((3, 0), np.int32),
                          np.zeros((0, 3), bool), np.arange(3, dtype=np.int32))
    return cases


def large_cases() -> dict:
    """name -> case at two widths past what one block's shared memory
    holds as a free matrix: N = 8,192 and N = 12,000. Compatibility is
    sparse (0.2%; at 12,000 the first 8,192 rows hold about a third as
    many targets as the 3,808 past them), so a group has a handful of
    targets, verdicts split, and the rows an earlier slot fills lie
    thousands of rows apart."""
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


#: allocatable (cpu in millicores, memory in MiB, pods: the ENI-limited
#: count) of large c/m/r types of the port's catalog, as
#: ``CatalogProvider().allocatable`` gives them: c5.12xlarge, c5.18xlarge,
#: c5a.16xlarge, m5.8xlarge, m5.12xlarge, m5.24xlarge, r5.12xlarge,
#: r4.16xlarge
DENSE_TYPES = np.array([
    (47710, 87902.2, 234), (71650, 127834.8, 737), (63670, 112679.6, 737),
    (31750, 118212.6, 234), (47710, 178833.4, 234), (95590, 355162.8, 737),
    (47710, 360695.8, 234), (63670, 476404.4, 737)], np.float32)


def dense_cases(n_nodes: int = 5000, seed: int = 10) -> dict:
    """name -> case: ``dense_5000``, a cluster of ``n_nodes`` large nodes
    holding 150-230 pods each, of 8 of 24 deployments (cpu 50m-300m, memory
    64Mi-1Gi, one pod each). Each node is the smallest of ``DENSE_TYPES``
    (at its ENI-limited pod count) that holds its pods, or the one after
    it. R = 10 in the encoder's axis order (cpu, memory, pods first); the
    cap is the uint16 hostname headroom (60,000 uncapped) with 10% of
    (deployment, node) pairs barred. Every node is a candidate with 8 live
    slots, so earlier slots' pods fill rows before the last slot is
    answered."""
    rng = np.random.RandomState(seed)
    N, R, G, S = n_nodes, 10, 24, 8
    requests = np.zeros((G, R), np.float32)
    requests[:, 0] = rng.choice([50, 100, 150, 200, 300], G)
    requests[:, 1] = rng.choice([64, 128, 256, 512, 1024], G)
    requests[:, 2] = 1.0
    gids = np.stack([rng.choice(G, S, replace=False) for _ in range(N)]).astype(np.int32)
    share = rng.dirichlet(np.ones(S), size=N)
    total = rng.randint(150, 231, size=N)
    gcounts = 1 + np.diff(np.round(np.cumsum(share, axis=1) * (total - S)[:, None]), axis=1,
                          prepend=0).astype(np.int32)
    used = np.einsum("ns,nsr->nr", gcounts.astype(np.float32), requests[gids])
    by_cpu = DENSE_TYPES[np.argsort(DENSE_TYPES[:, 0], kind="stable")]
    holds = (by_cpu[None, :, :] >= used[:, None, :3]).all(axis=2)  # [N, types]
    if not holds.any(axis=1).all():
        raise AssertionError("a node's pods outgrew the largest type")
    first = np.argmax(holds, axis=1)
    pick = np.minimum(first + rng.randint(2, size=N), len(by_cpu) - 1)
    pick = np.where(holds[np.arange(N), pick], pick, first)
    alloc = np.zeros((N, R), np.float32)
    alloc[:, :3] = by_cpu[pick]
    free = (alloc - used).astype(np.float32)
    cap = np.where(rng.rand(G, N) < 0.1, 0, 60000).astype(np.uint16)
    return {f"dense_{N}": (free, requests, gids, gcounts, cap, np.arange(N, dtype=np.int32))}


def mirror_cases(ct) -> dict:
    """name -> case: ``mirror_padded``, the encoded cluster ``ct``'s screen
    inputs padded exactly as ``ops/device_state.py``'s upload pads them
    (its buckets without the process-wide ratchet): rows past the live N
    with zero free and zero cap, groups past G with zero requests, slots
    past the live width counting 0, the float32 cap; the candidates are the
    live N only."""
    from .consolidate import live_slot_width
    from .device_state import padded_screen_arrays, screen_buckets

    NB, GB, S = screen_buckets(len(ct.node_names), ct.requests.shape[0],
                               live_slot_width(ct.group_counts))
    a = padded_screen_arrays(ct, NB, GB, S)
    return {"mirror_padded": tuple(a[k] for k in (
        "free", "requests", "group_ids", "group_counts", "cap", "candidates"))}
