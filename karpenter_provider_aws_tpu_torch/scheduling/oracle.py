"""Pure-numpy per-pod FFD: the greedy oracle the solver's cost is set against.

The counterpart of the JAX package's ``scheduling/oracle.py``, copied: the
literal reference algorithm (designs/bin-packing.md:29-43), pods in encode
order (already FFD-sorted), each pod first-fit onto open nodes, a new node
of the best cost-per-slot type otherwise. It runs on the encoded tensors,
so its choices are comparable with the solver's (same compat masks, same
prices, same type choice). It measures plans (``cost_vs_oracle``,
``HostSolver``); no solve falls back to it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.encode import EncodedProblem

_EPS = 1e-4


@dataclass
class OracleNode:
    type_index: int
    price: float
    cap: np.ndarray
    used: np.ndarray
    window: np.ndarray = None      # [Z, C] bool remaining (zone, captype) window
    group_counts: dict[int, int] = field(default_factory=dict)


_UNBOUNDED = 1 << 30  # all-zero request: the same sentinel as ops/ffd.py


def _fit_count(cap_rem: np.ndarray, req: np.ndarray) -> int:
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = np.where(req > 0, np.floor((cap_rem + _EPS) / np.where(req > 0, req, 1.0)), np.inf)
    return max(int(min(ratios.min(), _UNBOUNDED)), 0)


def ffd_oracle(problem: EncodedProblem, max_nodes: int = 100000) -> tuple[list[OracleNode], dict[int, int]]:
    """Returns (nodes, unplaced: group_index -> count). Group order is the
    encode order (already FFD-sorted)."""
    nodes: list[OracleNode] = []
    unplaced: dict[int, int] = {}
    G = len(problem.group_pods)
    for g in range(G):
        req = problem.requests[g]
        cnt = int(problem.counts[g])
        compat = problem.compat[g]
        price = problem.price[g]
        gw = problem.group_window[g]
        mpn = int(problem.max_per_node[g]) if problem.max_per_node is not None else 1 << 30
        # 1. first-fit across open nodes, one pod at a time (literal FFD).
        for node in nodes:
            if cnt == 0:
                break
            if not compat[node.type_index]:
                continue
            if not (node.window & gw).any():
                continue
            k = min(_fit_count(node.cap - node.used, req), mpn)
            take = min(k, cnt)
            if take > 0:
                node.used = node.used + req * take
                node.group_counts[g] = node.group_counts.get(g, 0) + take
                node.window = node.window & gw
                cnt -= take
        # 2. open new nodes: cost-per-slot greedy. Score arithmetic stays in
        # float32 so argmin tie-breaking matches the device solver exactly.
        with np.errstate(divide="ignore", invalid="ignore"):
            ratios = np.where(
                req[None, :] > 0,
                np.floor((problem.capacity + _EPS) / np.where(req > 0, req, 1.0)[None, :]),
                np.inf,
            )
        k_type = np.maximum(np.minimum(ratios.min(axis=1), _UNBOUNDED), 0).astype(np.int32)
        feasible = compat & (k_type >= 1) & np.isfinite(price)
        while cnt > 0 and len(nodes) < max_nodes:
            if not feasible.any():
                break
            eff = np.minimum(np.minimum(k_type, mpn), max(cnt, 1)).astype(np.float32)
            score = np.where(feasible, price.astype(np.float32) / np.maximum(eff, 1), np.inf).astype(np.float32)
            t = int(score.argmin())
            take = min(int(k_type[t]), cnt, mpn)
            nodes.append(
                OracleNode(
                    type_index=t,
                    price=float(price[t]),
                    cap=problem.capacity[t].copy(),
                    used=req * take,
                    window=gw & problem.type_window[t],
                    group_counts={g: take},
                )
            )
            cnt -= take
        if cnt > 0:
            unplaced[g] = cnt
    return nodes, unplaced


def oracle_cost(nodes: list[OracleNode]) -> float:
    return float(sum(n.price for n in nodes))
