"""The repository's solve workloads, as pending pods.

Each builder takes ``pkg``, any object with the ``lbl`` (labels module) and
``make_pods`` of a package, so the same pods can be built by the JAX package
and by this one. ``tests/test_torch_encode.py`` and ``tests/test_torch_solver.py``
(both packages, on the CPU) and ``chip_smoke.py`` (this package, on the
card) share them.
"""

from __future__ import annotations

import numpy as np


def headline_pods(pkg, n: int = 50_000) -> list:
    """``bench.py``'s headline problem generator: 64 shapes (seed 0), 15%
    pinned to arm64 and 10% to a zone, ``n // 64`` pods each."""
    lbl = pkg.lbl
    rng = np.random.RandomState(0)
    pods = []
    per = max(1, n // 64)
    for i in range(64):
        cpu_m = int(rng.choice([100, 250, 500, 1000, 2000, 4000, 8000]))
        mem_mi = cpu_m * int(rng.choice([1, 2, 4, 8]))
        kwargs = {}
        r = rng.rand()
        if r < 0.15:
            kwargs["node_selector"] = {lbl.ARCH: "arm64"}
        elif r < 0.25:
            kwargs["node_selector"] = {lbl.TOPOLOGY_ZONE: str(rng.choice(["zone-a", "zone-b"]))}
        pods += pkg.make_pods(per, f"shape{i}", {"cpu": f"{cpu_m}m", "memory": f"{mem_mi}Mi"},
                              **kwargs)
    return pods


def config8_pods(pkg, n_deployments: int = 300, seed: int = 3) -> list:
    """``benchmarks/solve_configs.py``'s ``config8_fleet_fragmentation``:
    300 deployments with zipf replica counts and mixed zone / capacity-type
    / arch pins, seed 3."""
    lbl = pkg.lbl
    rng = np.random.RandomState(seed)
    pods = []
    zones = ("zone-a", "zone-b", "zone-c", "zone-d")
    for i in range(n_deployments):
        replicas = int(np.clip(rng.zipf(1.7), 1, 25))
        cpu_m = int(rng.choice([250, 500, 1000, 1500, 2000, 2500, 3000, 5000, 7000]))
        mem = int(cpu_m * rng.choice([1, 2, 4, 8]))
        kwargs = {}
        r = rng.rand()
        if r < 0.25:
            kwargs["node_selector"] = {lbl.TOPOLOGY_ZONE: str(rng.choice(zones))}
        elif r < 0.45:
            kwargs["node_selector"] = {lbl.CAPACITY_TYPE: "on-demand"}
        elif r < 0.6:
            kwargs["node_selector"] = {lbl.ARCH: "arm64"}
        pods += pkg.make_pods(replicas, f"d{i}", {"cpu": f"{cpu_m}m", "memory": f"{mem}Mi"},
                              **kwargs)
    return pods
