"""The repository's solve workloads, as pending pods.

Each builder takes ``pkg``, any object with the ``lbl`` (labels module) and
``make_pods`` of a package, so the same pods can be built by the JAX package
and by this one. ``tests/test_torch_encode.py`` and ``tests/test_torch_solver.py``
(both packages, on the CPU) and ``chip_smoke.py`` (this package, on the
card) share them; ``tests/test_torch_market.py`` and
``tests/test_torch_optimizer.py`` too.
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


def config5_pods(pkg, n: int = 4000) -> list:
    """``benchmarks/solve_configs.py``'s ``config5_accelerators``: a quarter
    GPU pods, an eighth Neuron pods, the rest cpu pods."""
    pods = pkg.make_pods(n // 4, "gpu", {"cpu": "4", "memory": "16Gi", "nvidia.com/gpu": 1})
    pods += pkg.make_pods(n // 8, "neuron",
                          {"cpu": "8", "memory": "32Gi", "aws.amazon.com/neuron": 1})
    pods += pkg.make_pods(n - n // 4 - n // 8, "cpu", {"cpu": "1", "memory": "2Gi"})
    return pods


#: config5's two capacity reservations (reserved capacity at price 0):
#: ``Reservation`` keyword arguments
CONFIG5_RESERVATIONS = (
    dict(id="cr-gpu", instance_type="g5.12xlarge", zone="zone-a", count=20),
    dict(id="cr-trn", instance_type="trn1.32xlarge", zone="zone-b", count=4),
)


#: the ``frag`` trace's burst shapes (``sim/traces.py`` ``FRAG_SHAPES``):
#: (tall, wide) pairs sized so a greedy FFD interleaves singleton tail nodes
#: (tall pods bind on cpu, wide pods on memory)
FRAG_SHAPES = (
    (("7000m", "6Gi"), ("1500m", "12Gi")),
    (("6000m", "4Gi"), ("2000m", "14Gi")),
    (("5000m", "8Gi"), ("1000m", "10Gi")),
)


def frag_workload(pkg, seed: int, scale: float = 1.0) -> list:
    """``benchmarks/optimizer_bench.py``'s ``frag_workload``: one seeded
    fragmentation instance, a ``FRAG_SHAPES`` burst pair (odd counts of
    tall and wide pods) over a zipf fleet mix with zone / capacity-type /
    arch pins. The reference's ``config6_frag_optimizer`` row draws seeds
    0-11 of it."""
    lbl = pkg.lbl
    rng = np.random.RandomState(seed)
    pods = []
    tall, wide = FRAG_SHAPES[seed % len(FRAG_SHAPES)]
    n_tall = (max(3, int(14 * scale)) | 1)
    n_wide = (max(3, int(14 * scale) + rng.randint(3)) | 1)
    pods += pkg.make_pods(n_tall, f"fragT{seed}", {"cpu": tall[0], "memory": tall[1]})
    pods += pkg.make_pods(n_wide, f"fragW{seed}", {"cpu": wide[0], "memory": wide[1]})
    zones = ("zone-a", "zone-b", "zone-c", "zone-d")
    for i in range(max(int(40 * scale), 12)):
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
        pods += pkg.make_pods(replicas, f"d{seed}_{i}",
                              {"cpu": f"{cpu_m}m", "memory": f"{mem}Mi"}, **kwargs)
    return pods
