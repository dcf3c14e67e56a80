"""The Solver boundary on PyTorch: pods + nodepools + catalog -> node plan.

``TorchSolver`` is the counterpart of the JAX package's ``TPUSolver``. A solve
encodes each pool's pods on the host (``ops/encode.py``), runs the FFD over
all groups as ONE kernel launch (``ops/ffd_cuda.py``), ranks launch options
and compacts the plan with torch ops on the device, copies the sparse plan to
the host in ONE transfer, then refines and decodes it with the reference's
host code.

Multi-nodepool handling mirrors the core scheduler: nodepools are tried in
weight order; pods a nodepool cannot place fall through to the next.

Market state (reservation windows, a market model's reclaim premium) rides
the catalog's price and availability tensors, as in the reference.

Not carried yet, and refused when asked for (``NotImplementedError``): gang
scheduling, the optimizer lane, partition lanes and why-attribution. There is no degraded mode: a CUDA solve either runs the
kernel or raises.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..catalog.provider import CatalogProvider
from ..models import labels as lbl
from ..models.nodepool import NodePool
from ..models.pod import Pod
from ..models.resources import ResourceVector
from ..ops import ffd_cuda
from ..ops.encode import EncodedProblem, bucket, encode_problem, pad_problem
from ..ops.ffd import (
    compact_plan,
    empty_state,
    pack_window_bits,
    rank_launch_options,
    unpack_window_bits,
)

# Launch-path truncation parity: instance.go:52-53 — at most 60 instance
# types are carried into a single launch request.
MAX_INSTANCE_TYPE_OPTIONS = 60


@dataclass
class NodeSpec:
    """One node to create: ranked launch options + the pods it was packed for.

    ``offering_options`` is the joint launchable set — every (zone,
    capacity_type) pair listed has a live offering for at least the committed
    type; ``zone_options``/``capacity_type_options`` are its marginals.
    """

    nodepool_name: str
    instance_type_options: list[str]           # ranked cheapest-first
    zone_options: list[str]
    capacity_type_options: list[str]
    offering_options: list[tuple[str, str]] = field(default_factory=list)
    pods: list[Pod] = field(default_factory=list)
    estimated_price: float = 0.0


@dataclass
class ExistingNode:
    """A live cluster node offered to the solver as pre-opened capacity.

    The solve then packs pending pods onto existing slack *inside the same
    device program* that opens new nodes (parity: the core scheduler's
    in-flight/existing virtual nodes, designs/bin-packing.md:18-43) instead
    of a host-side O(pods x nodes) loop."""

    name: str
    nodepool_name: str
    instance_type: str
    zone: str
    capacity_type: str
    used: np.ndarray         # [R] resources consumed by bound pods
    allocatable: np.ndarray  # [R] node-reported allocatable
    taints: tuple = ()       # actual node taints (may diverge from the pool)
    labels: dict = field(default_factory=dict)  # actual node labels (ditto)


@dataclass
class SolveResult:
    node_specs: list[NodeSpec] = field(default_factory=list)
    # pods the plan lands on EXISTING nodes: (pod, node_name)
    binds: list[tuple[Pod, str]] = field(default_factory=list)
    unschedulable: list[tuple[Pod, str]] = field(default_factory=list)
    total_cost: float = 0.0                    # $/hr of committed choices
    solve_seconds: float = 0.0
    num_pods: int = 0
    # what computed this plan: {"backend", "device", "timings"} per-stage ms
    provenance: dict = field(default_factory=dict)

    def pods_placed(self) -> int:
        return sum(len(s.pods) for s in self.node_specs) + len(self.binds)


def _node_rows_bucket(n: int, minimum: int = 64) -> int:
    """Next value >= n on the {2^k, 1.5 * 2^k} ladder.

    The node-row axis drives both per-scan-step work and plan-fetch bytes;
    power-of-2-only buckets overshoot by up to 2x right above a boundary
    (est 2995 -> 4096). The half-step ladder caps overshoot at 1.5x for one
    extra compile bucket per octave."""
    p = minimum
    while True:
        if n <= p:
            return p
        if n <= p * 3 // 2:
            return p * 3 // 2
        p *= 2


def _node_bucket(num_pods: int) -> int:
    return min(max(bucket(max(num_pods, 1), minimum=64), 64), 8192)


def _estimate_nodes(problem: EncodedProblem, G: int) -> int:
    """Demand-driven node-row estimate for the FFD scan.

    Sizing N by pod count alone made every downstream stage (scan width,
    device->host fetch, refine, decode) pay for rows that never open: 10k
    half-cpu pods fit ~400 nodes, not 8192. Per group, assume the open
    phase's own choice — the cheapest usable type — and count nodes at that
    type's fit, capped by hostname topology; sum over groups (no-sharing
    upper-ish bound), then 2x headroom. The solver retries at the full
    pod-count bucket if the estimate ever proves too small (detected, not
    assumed: rows exhausted AND pods unplaced)."""
    counts = problem.counts[:G].astype(np.float64)
    req = problem.requests[:G]
    price = problem.price[:G]
    finite = np.isfinite(price)
    usable = finite.any(axis=1)
    if not usable.any():
        return 64
    # per-(group, type) fit, then the OPEN phase's own choice rule — the
    # type minimizing price per slot. Estimating at the cheapest-absolute
    # type assumed tiny nodes and over-allocated rows ~2x on workloads
    # where a larger type wins on $/slot.
    # per-resource mins accumulate into one [G, T] array — the one-shot
    # [G, T, R] broadcast peaked at O(T) times more host memory for the
    # same answer (R is small and fixed)
    k_gt = np.full((G, problem.capacity.shape[0]), np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in range(req.shape[1]):
            col = req[:, r]
            rows = col > 0  # unrequested resources don't constrain
            if not rows.any():
                continue
            ratio = np.floor(
                (problem.capacity[None, :, r] + 1e-4) / col[rows][:, None]
            )
            k_gt[rows] = np.minimum(k_gt[rows], ratio)
    k_gt = np.clip(k_gt, 0.0, float(1 << 30))
    # eff is capped by the group's own count, mirroring the scan's
    # eff = min(k, rem): a 100-slot node is only 50-slots-efficient for a
    # 50-pod group
    eff = np.minimum(k_gt, np.maximum(counts, 1.0)[:, None])
    score = np.where(finite & (k_gt >= 1), price / np.maximum(eff, 1.0), np.inf)
    pref = np.argmin(score, axis=1)                            # [G]
    k_per_node = np.clip(k_gt[np.arange(G), pref], 1.0, float(1 << 30))
    mpn = np.maximum(problem.max_per_node[:G], 1)
    k_eff = np.minimum(k_per_node, mpn)
    nodes_g = np.ceil(counts / k_eff)
    # hostname-capped groups SHARE nodes with each other (different
    # services' anti-affinity pods co-locate fine): counting them per-group
    # overshoots by the number of capped services — take their max, not sum
    capped = (problem.max_per_node[:G] < (1 << 30)) & usable
    est = float(nodes_g[usable & ~capped].sum())
    if capped.any():
        est += float(nodes_g[capped].max())
    return int(est * 2.0) + 8


def _decode_nodes(
    problem: EncodedProblem,
    node_type: np.ndarray,
    node_price: np.ndarray,
    used: np.ndarray,
    n_open: int,
    placed: np.ndarray,
    nodepool_name: str,
    node_window: np.ndarray,
    ranked_idx: Optional[np.ndarray] = None,   # [N, K] device-ranked types
    ranked_n: Optional[np.ndarray] = None,     # [N] valid prefix length
    stale_rank: Optional[np.ndarray] = None,   # [N] recompute ranking on host
    n_pre: int = 0,
    pre_names: Optional[Sequence[str]] = None,
) -> tuple[list[NodeSpec], list[tuple[Pod, str]]]:
    """Turn device output into NodeSpecs (new nodes) + binds (existing).

    Rows ``[0, n_pre)`` are pre-opened existing nodes: their pods become
    (pod, node_name) binds, not launches.

    Flexibility recovery: the solver commits one type per node, but the
    launch path wants ranked alternatives to survive ICE (parity: the
    scheduler handing CloudProvider.Create many instanceType options).
    A type qualifies if every group on the node accepts it (finite price)
    and its allocatable covers the node's packed resources.

    ``ranked_idx``/``ranked_n`` carry the ranking precomputed on device by
    ``ops.ffd.rank_launch_options`` (device path; ranked_n = per-node valid
    prefix length); without them the ranking runs here in numpy.
    """
    specs: list[NodeSpec] = []
    binds: list[tuple[Pod, str]] = []
    G = len(problem.group_pods)
    # per-group cursor into the concrete pod lists
    cursors = [0] * G
    cap = problem.capacity  # [T, R]
    # Vectorized window marginals for the whole plan (one pass instead of
    # ~7 tiny .any() reductions per node inside the loop).
    nw = node_window[:n_open]
    win_z = nw.any(axis=2)          # [n_open, Z]
    win_c = nw.any(axis=1)          # [n_open, C]
    # memoized name/option lists per distinct window bit-pattern — plans
    # typically carry a handful of distinct windows across thousands of nodes
    zs, cts = problem.zones, lbl.CAPACITY_TYPES
    _win_memo: dict[bytes, tuple] = {}

    def _window_lists(n: int) -> tuple:
        key = nw[n].tobytes()
        hit = _win_memo.get(key)
        if hit is None:
            w = nw[n]
            # TUPLES: these are shared across every NodeSpec with the same
            # window — immutability makes the read-only contract structural
            # (a consumer trying .append/.sort raises instead of corrupting
            # sibling specs); launch_claim list()-copies what it keeps
            hit = (
                tuple((z, ct) for zi, z in enumerate(zs) for ci, ct in enumerate(cts) if w[zi, ci]),
                tuple(z for zi, z in enumerate(zs) if win_z[n, zi]),
                tuple(ct for ci, ct in enumerate(cts) if win_c[n, ci]),
            )
            _win_memo[key] = hit
        return hit

    # One nonzero pass over the whole plan instead of a [G] slice per node,
    # and ONE bulk ranked-name materialization (a single C-level .tolist()
    # of the [n_open, k] name matrix) — the per-node Python loops and
    # per-node fancy-index + tolist were ~1/6 of e2e solve wall at 2k+ nodes.
    gq, nq = np.nonzero(placed[:G, :n_open])
    cq = placed[gq, nq]
    by_node: dict[int, list[tuple[int, int]]] = {}
    for g, n, c in zip(gq.tolist(), nq.tolist(), cq.tolist()):
        by_node.setdefault(n, []).append((g, c))
    all_ranked_names = None
    if ranked_idx is not None:
        kmax = min(ranked_idx.shape[1], MAX_INSTANCE_TYPE_OPTIONS)
        names_arr = np.asarray(problem.type_names, dtype=object)
        all_ranked_names = names_arr[ranked_idx[:n_open, :kmax]].tolist()
        ranked_n_l = np.minimum(
            np.asarray(ranked_n[:n_open], dtype=np.int64), kmax
        ).tolist()
    node_type_l = np.asarray(node_type[:n_open], dtype=np.int64).tolist()

    for n in range(n_open):
        group_take = by_node.get(n, ())
        pods: list[Pod] = []
        group_idx = [g for g, _ in group_take]
        for g, take in group_take:
            plist = problem.group_pods[g]
            if problem.atomic is not None and problem.atomic[g]:
                # atomic (co-located) group: its one placed unit IS the
                # whole pod list
                if take > 0:
                    pods.extend(plist[cursors[g]:])
                    cursors[g] = len(plist)
                continue
            pods.extend(plist[cursors[g]: cursors[g] + take])
            cursors[g] += take
        if not pods and not group_idx:
            continue
        if n < n_pre:
            name = pre_names[n]
            binds.extend((pod, name) for pod in pods)
            continue
        committed = node_type_l[n]
        if ranked_idx is not None and (stale_rank is None or not stale_rank[n]):
            type_names = all_ranked_names[n][: ranked_n_l[n]]
        else:
            # combined per-type price across the node's groups (inf if any
            # group cannot use the type) -> ranked alternatives; an
            # alternative must also offer the node's final window
            combined = problem.price[group_idx].max(axis=0)  # [T]
            fits = (used[n][None, :] <= cap + 1e-4).all(axis=1)
            window = (problem.type_window & node_window[n][None, :, :]).any(axis=(1, 2))
            usable = np.isfinite(combined) & fits & window
            # Exotic (bare-metal) filter parity: instance.go:456-477 — metal
            # types never ride along as launch alternatives when any standard
            # type qualifies; lowest-price fleet allocation could otherwise
            # land on hardware nobody asked for.
            exotic = problem.type_exotic
            if exotic is not None and (usable & ~exotic).any() and not exotic[committed]:
                usable = usable & ~exotic
            order = np.argsort(np.where(usable, combined, np.inf), kind="stable")
            n_usable = int(usable.sum())
            ranked = order[: min(n_usable, MAX_INSTANCE_TYPE_OPTIONS)]
            type_names = [problem.type_names[t] for t in ranked]
        if problem.type_names[committed] not in type_names:
            type_names = [problem.type_names[committed]] + type_names[:-1]

        # The solver narrowed each node's joint (zone, captype) window as
        # groups landed (intersected with the committed type's live
        # offerings), so every pair in it is directly launchable. The
        # option lists are SHARED across specs with the same window (plans
        # carry a handful of distinct windows across thousands of nodes,
        # and consumers treat them as read-only snapshots — the claim
        # builder copies what it keeps): per-spec list copies were a
        # measurable slice of decode at thousands of nodes.
        offering_options, zone_options, captype_options = _window_lists(n)
        specs.append(
            NodeSpec(
                nodepool_name=nodepool_name,
                instance_type_options=type_names,
                zone_options=zone_options,
                capacity_type_options=captype_options,
                offering_options=offering_options,
                pods=pods,
                estimated_price=float(node_price[n]),
            )
        )
    return specs, binds


def _refine_plan(
    problem: EncodedProblem,
    node_type: np.ndarray,    # [N]
    node_price: np.ndarray,   # [N]
    used: np.ndarray,         # [N, R] (mutated)
    node_window: np.ndarray,  # [N, Z, C] (mutated)
    placed: np.ndarray,       # [G', N] (mutated; G' >= G real groups)
    n_open: int,
    max_tries: int = 256,
    util_threshold: float = 0.9,
    n_pre: int = 0,
    node_cap: Optional[np.ndarray] = None,  # [N, R] actual per-node allocatable
) -> tuple[np.ndarray, np.ndarray]:
    """Packed-cost refinement (SURVEY.md section 7.3): drop under-filled plan
    nodes whose pods first-fit into the remaining nodes' slack.

    The greedy FFD leaves a partial tail node per group run; when several
    groups' tails interleave, the final plan can carry nodes the rest of the
    plan could absorb. This pass re-runs the consolidation proof *on the
    plan itself* (cheapest form of the LP-relaxation refinement: a
    feasibility-preserving cost descent) and commits every drop — so the
    launched cost can be strictly BELOW the reference's greedy, never above.

    Candidates are the ``max_tries`` lowest-utilization nodes under
    ``util_threshold``, tried most-expensive-first; every move respects
    group compatibility (finite price for the receiver's committed type),
    the joint (zone, captype) window (receivers narrow like the scan does),
    and hostname caps. Returns (dropped[N], stale_rank[N]) — receivers'
    precomputed launch rankings must be recomputed host-side.
    """
    G = len(problem.group_pods)
    Nn = len(node_type)
    dropped = np.zeros(Nn, dtype=bool)
    stale = np.zeros(Nn, dtype=bool)
    # Every array below is sliced to the LIVE rows: the node buffer is a
    # power-of-2 bucket, and paying O(bucket) per trial when only n_open
    # rows exist made this pass the biggest host cost of a topology solve.
    # numpy basic slices are views — commits propagate to the caller.
    L = n_open
    placed_l = placed[:G, :L]
    used_l = used[:L]
    window_l = node_window[:L]
    ntype_l = node_type[:L]
    idx = np.arange(L)
    pods_on = placed_l.sum(axis=0)
    # Actual per-node allocatable when provided (pre-opened existing nodes
    # may report less than the catalog value); catalog fallback otherwise.
    cap = (node_cap[:L] if node_cap is not None else problem.capacity[ntype_l])
    free = cap - used_l
    with np.errstate(invalid="ignore", divide="ignore"):
        util = (used_l / np.maximum(cap, 1e-9)).max(axis=1)
    # Existing nodes are never drop candidates here — retiring live capacity
    # is the consolidation controller's call, not the provisioner's.
    cand = (idx >= n_pre) & (pods_on > 0) & (util < util_threshold)
    cand_idx = idx[cand]
    if cand_idx.size == 0:
        return dropped, stale
    # bounded: lowest-utilization pool, most-expensive-first within it
    pool = cand_idx[np.argsort(util[cand_idx], kind="stable")][:max_tries]
    pool = pool[np.argsort(-node_price[pool], kind="stable")]

    dropped_l = dropped[:L]
    stale_l = stale[:L]
    mpn = problem.max_per_node
    finite_price = np.isfinite(problem.price)  # [G, T]
    fail_streak = 0
    for n in pool:
        if fail_streak >= 32:
            # cost descent is best-effort: a long failure run means the
            # remaining (even-lower-utilization) candidates are unlikely to
            # repack either — stop paying O(G x N) per miss
            break
        gids = np.nonzero(placed_l[:, n])[0]
        # trial first-fit of every group of n into the surviving slack;
        # windows narrow DURING the trial (a receiver taking group g1 then
        # g2 must keep a non-empty joint window, like the device scan)
        trial_free = free.copy()
        trial_window = window_l.copy()
        moves: list[tuple[int, np.ndarray]] = []
        ok = True
        for g in gids:
            cnt = int(placed_l[g, n])
            req = problem.requests[g]
            gw = problem.group_window[g]
            elig = ~dropped_l & (idx != n)
            elig &= finite_price[g][ntype_l]
            elig &= (trial_window & gw[None, :, :]).any(axis=(1, 2))
            if int(mpn[g]) < (1 << 30):
                # hostname-capped groups stay off existing nodes (their
                # per-node occupancy is invisible here — same rule as the
                # device scan's pre_ok mask)
                elig &= idx >= n_pre
            with_req = req > 0
            ratio = np.where(
                with_req[None, :],
                np.floor((trial_free + 1e-4) / np.where(with_req, req, 1.0)[None, :]),
                np.inf,
            )
            k = np.clip(np.nanmin(ratio, axis=1), 0, float(1 << 30)).astype(np.int64)
            k = np.minimum(k, int(mpn[g]) - placed_l[g])
            k = np.where(elig, k, 0)
            cum = np.cumsum(k) - k
            take = np.clip(cnt - cum, 0, k).astype(np.int64)
            if int(take.sum()) < cnt:
                ok = False
                break
            trial_free -= take[:, None] * req[None, :]
            recv = take > 0
            trial_window[recv] &= gw[None, :, :]
            moves.append((int(g), take))
        if not ok:
            fail_streak += 1
            continue
        fail_streak = 0
        # commit: move pods, grow receivers, adopt trial windows, drop node
        for g, take in moves:
            recv = np.nonzero(take)[0]
            placed_l[g, recv] += take[recv]
            used_l[recv] += take[recv, None] * problem.requests[g][None, :]
            stale_l[recv] = True
            placed_l[g, n] = 0
        window_l[:] = trial_window
        free = cap - used_l
        free[n] = 0
        used_l[n] = 0
        dropped_l[n] = True
    return dropped, stale


def _encode_existing(problem: EncodedProblem, existing: Sequence[ExistingNode]):
    """Existing nodes -> pre-opened row arrays in the problem's tensor space.

    Nodes whose type/zone/captype fall outside the catalog snapshot are
    skipped, as are nodes carrying scheduling-effect taints beyond the
    pool template (group compat only covers template taints — an
    out-of-band ``NoSchedule`` taint must not be silently violated) and
    nodes whose labels diverge from the pool template (group compat is
    computed from the CURRENT template, but a live
    node carries labels stamped at launch — a since-edited template could
    otherwise receive device-path binds its actual labels don't satisfy;
    drift eventually replaces such nodes, but binds must not race it).
    Skipped nodes can still receive pods via the host binder, which checks
    actual labels."""
    tidx = {n: i for i, n in enumerate(problem.type_names)}
    zidx = {z: i for i, z in enumerate(problem.zones)}
    cidx = {c: i for i, c in enumerate(lbl.CAPACITY_TYPES)}
    Z, C = problem.group_window.shape[1], problem.group_window.shape[2]
    template = {
        (t.key, t.value, t.effect)
        for t in (problem.nodepool.taints if problem.nodepool else [])
    }
    template_labels = dict(problem.nodepool.labels) if problem.nodepool else {}
    names: list[str] = []
    ptype, pused, pcap, pwin = [], [], [], []
    for e in existing:
        t = tidx.get(e.instance_type)
        z = zidx.get(e.zone)
        c = cidx.get(e.capacity_type)
        if t is None or z is None or c is None:
            continue
        if any(
            getattr(tt, "effect", "") in ("NoSchedule", "NoExecute")
            and (tt.key, tt.value, tt.effect) not in template
            for tt in e.taints
        ):
            continue
        # labels stamped at launch must still agree with the template the
        # compat matrix was computed from (e.labels empty = caller predates
        # label snapshots; template-only callers keep the old behavior)
        if e.labels and any(
            e.labels.get(k) != v for k, v in template_labels.items()
        ):
            continue
        w = np.zeros((Z, C), dtype=bool)
        w[z, c] = True
        names.append(e.name)
        ptype.append(t)
        pused.append(e.used)
        pcap.append(e.allocatable)
        pwin.append(w)
    if not names:
        return None
    return (
        names,
        np.asarray(ptype, dtype=np.int32),
        np.stack(pused).astype(np.float32),
        np.stack(pcap).astype(np.float32),
        np.stack(pwin),
    )


def _refuse_unsupported() -> None:
    """Features the JAX package arms through its environment switches that
    this package does not carry: an explicit request raises instead of being
    ignored. Left unset, they are off here."""
    for var, what, off in (
        ("KARPENTER_TPU_OPTIMIZER", "the optimizer lane", ("0",)),
        ("KARPENTER_TPU_WHY", "why-attribution", ("0",)),
        ("KARPENTER_TPU_PARTITION_SOLVE", "partition lanes", ("0", "auto")),
    ):
        value = os.environ.get(var)
        if value is not None and value not in off:
            raise NotImplementedError(
                f"{what} ({var}={value}) is not supported by the torch solver yet"
            )


class TorchSolver:
    """Device-backed solver. ``device=None`` means ``"cuda"``; the CPU runs
    only when asked for (``device="cpu"``), through the plain PyTorch FFD.
    ``refine`` enables the packed-cost descent pass (``_refine_plan``)."""

    def __init__(self, device=None, max_nodes: Optional[int] = None,
                 refine: bool = True):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to solve on the CPU"
            )
        self.max_nodes = max_nodes
        self.refine = refine
        # per-stage wall clock of the LAST solve (encode / device / decode)
        self.timings: dict = {}
        # observed n_open / sparse-plan nonzeros per problem signature: what
        # the last solve of a signature actually used sizes the next one
        self._n_open_hist: dict[tuple, int] = {}
        self._nz_hist: dict[tuple, int] = {}
        # refine no-op tracking: after two no-op refines on a signature the
        # pass is skipped, re-checked every 8th solve
        self._refine_zero_streak: dict[tuple, int] = {}
        self._refine_skip_ctr: dict[tuple, int] = {}

    def backend_label(self) -> str:
        return "cuda-ffd" if self.device.type == "cuda" else "torch-plain"

    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def _device_inputs(self, padded: EncodedProblem) -> dict:
        """The padded problem's tensors on the solver's device, built once
        per problem object (the encode cache hands back the same object to
        a re-solve of the same pods)."""
        memo = padded.__dict__.setdefault("_torch_inputs", {})
        hit = memo.get(self.device)
        if hit is None:
            T = padded.capacity.shape[0]
            exotic = (padded.type_exotic if padded.type_exotic is not None
                      else np.zeros(T, dtype=bool))
            mpn = np.minimum(padded.max_per_node.astype(np.int64), 1 << 30)
            host = {
                "requests": padded.requests.astype(np.float32),
                "counts": padded.counts.astype(np.int32),
                "compat": padded.compat.astype(bool),
                "capacity": padded.capacity.astype(np.float32),
                "price": padded.price.astype(np.float32),
                "group_window": pack_window_bits(padded.group_window),
                "type_window": pack_window_bits(padded.type_window),
                "max_per_node": mpn.astype(np.int32),
                "exotic": exotic.astype(bool),
            }
            hit = memo[self.device] = {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in host.items()
            }
        return hit

    def _run(self, problem, dev_in: dict, N: int, pre_rows, n_pre: int,
             GB: int, hist_key) -> tuple[dict, object]:
        """One kernel launch, the ranking and the sparse plan on the device,
        then ONE device-to-host copy. Returns (host arrays, device result)."""
        R = dev_in["requests"].shape[1]
        state = None
        if pre_rows:
            _nm, ptype, pused, pcap, pwin = pre_rows
            node_type0 = np.zeros(N, dtype=np.int32)
            used0 = np.zeros((N, R), dtype=np.float32)
            cap0 = np.zeros((N, R), dtype=np.float32)
            win0 = np.zeros(N, dtype=np.int32)
            node_type0[:n_pre] = ptype
            used0[:n_pre] = pused
            cap0[:n_pre] = pcap
            win0[:n_pre] = pack_window_bits(pwin)
            st = empty_state(N, R, self.device, n_open=n_pre)
            state = st._replace(
                node_type=torch.from_numpy(node_type0).to(self.device),
                used=torch.from_numpy(used0).to(self.device),
                node_cap=torch.from_numpy(cap0).to(self.device),
                node_window=torch.from_numpy(win0).to(self.device),
            )
        res = ffd_cuda.ffd_solve(
            dev_in["requests"], dev_in["counts"], dev_in["compat"],
            dev_in["capacity"], dev_in["price"], dev_in["group_window"],
            dev_in["type_window"], max_per_node=dev_in["max_per_node"],
            max_nodes=N, init_state=state, n_pre=n_pre,
        )
        k = min(MAX_INSTANCE_TYPE_OPTIONS, problem.capacity.shape[0])
        ranked_idx, ranked_n, best_price = rank_launch_options(
            res.placed, dev_in["price"], res.used, dev_in["capacity"],
            dev_in["type_window"], res.node_window, res.node_type,
            dev_in["exotic"], k=k,
        )
        # the sparse plan buffer sizes itself to what plans of this
        # signature produced (floor 2N covers ~2 groups per open row)
        nz_seen = self._nz_hist.get(hist_key)
        E = bucket(max(1024, 2 * N, 4 * GB,
                       0 if nz_seen is None else int(nz_seen * 1.5) + 64))
        nz, nz_cnt, total_nz = compact_plan(res.placed, E)
        G = dev_in["requests"].shape[0]
        parts = [
            ("nz", nz, E), ("nz_cnt", nz_cnt, E), ("total_nz", total_nz.reshape(1), 1),
            ("unplaced", res.unplaced, G), ("node_type", res.node_type, N),
            ("node_price", res.node_price.view(torch.int32), N),
            ("n_open", res.n_open.reshape(1), 1), ("node_window", res.node_window, N),
            ("ranked_idx", ranked_idx.to(torch.int32).reshape(-1), N * k),
            ("ranked_n", ranked_n.to(torch.int32), N),
            ("best_price", best_price.view(torch.int32), N),
        ]
        # ONE device-to-host copy for everything the decode needs
        flat = torch.cat([t for _, t, _ in parts]).cpu().numpy()
        out, off = {}, 0
        for name, _t, n in parts:
            out[name] = flat[off:off + n]
            off += n
        out["node_price"] = out["node_price"].view(np.float32)
        out["best_price"] = out["best_price"].view(np.float32)
        out["ranked_idx"] = out["ranked_idx"].reshape(N, k)
        out["total_nz"] = int(out["total_nz"][0])
        out["n_open"] = int(out["n_open"][0])
        return out, res

    def solve_encoded(
        self, problem: EncodedProblem, existing: Optional[Sequence[ExistingNode]] = None,
    ) -> tuple[list[NodeSpec], list[tuple[Pod, str]], dict[int, int]]:
        G = len(problem.group_pods)
        if G == 0:
            return [], [], {}
        num_pods = int(problem.counts[:G].sum())
        # Pre-open existing nodes: committed type index, current usage,
        # one-hot (zone, captype) window, price 0 (sunk cost — filling live
        # slack must always beat opening a new node).
        pre_rows = _encode_existing(problem, existing) if existing else None
        n_pre = len(pre_rows[0]) if pre_rows else 0
        names = pre_rows[0] if pre_rows else []

        GB = bucket(G)
        pad_memo = problem.__dict__.setdefault("_pad_memo", {})
        padded = pad_memo.get(GB)
        if padded is None:
            padded = pad_memo[GB] = pad_problem(problem, GB)
        dev_in = self._device_inputs(padded)

        # ``max_nodes`` bounds FRESH nodes only: pre-opened existing rows ride
        # on top, bucketed separately. Without an explicit cap, N starts at
        # the demand estimate and retries at the full pod-count bucket iff
        # the solve ran out of rows with pods left.
        N_cap = self.max_nodes or _node_bucket(num_pods)
        hist_key = (
            problem.nodepool.name if problem.nodepool else "",
            GB,
            bucket(max(num_pods, 1)),
        )
        if self.max_nodes:
            N = N_cap
        else:
            hist = self._n_open_hist.get(hist_key)
            est = (
                int(hist * 1.25) + 8
                if hist is not None
                else _estimate_nodes(problem, G)
            )
            N = min(_node_rows_bucket(max(est, 64)), N_cap)
        pre_extra = bucket(n_pre, minimum=256) if n_pre else 0
        return self._wait(problem, dev_in, N, N_cap, pre_extra, hist_key,
                          pre_rows, names, n_pre, GB)

    def _wait(self, problem, dev_in, N, N_cap, pre_extra, hist_key, pre_rows,
              names, n_pre, GB):
        """Run the device program, fetch its plan, retry once at ``N_cap``
        rows if the rows ran out, then commit-downsize, refine and decode."""
        G = len(problem.group_pods)
        t_dev = time.perf_counter()
        out, res = self._run(problem, dev_in, N + pre_extra, pre_rows, n_pre, GB, hist_key)
        unplaced_arr = out["unplaced"][:G]
        n_open = out["n_open"]
        if unplaced_arr.sum() > 0 and n_open >= N + pre_extra and N < N_cap:
            # estimate proved too small (rows exhausted, pods left over):
            # one retry at the full bucket
            N = N_cap
            out, res = self._run(problem, dev_in, N + pre_extra, pre_rows, n_pre, GB, hist_key)
            unplaced_arr = out["unplaced"][:G]
            n_open = out["n_open"]

        # Dense plan reconstruction from the sparse form: `placed` scatters
        # back on the host, and `used` is exactly placements x requests (plus
        # the pre-opened rows' starting usage).
        Nr = N + pre_extra
        Z, C = problem.group_window.shape[1], problem.group_window.shape[2]
        node_window = unpack_window_bits(out["node_window"], Z, C)
        nz, nz_cnt, total_nz = out["nz"], out["nz_cnt"], out["total_nz"]
        if total_nz > nz.shape[0]:
            # the sparse buffer overflowed: fetch the dense plan
            placed = res.placed.cpu().numpy().astype(np.int32)
            used = res.used.cpu().numpy()
        else:
            placed = np.zeros((GB, Nr), dtype=np.int32)
            valid = nz >= 0
            placed.reshape(-1)[nz[valid]] = nz_cnt[valid]
            used = placed[:G].T.astype(np.float32) @ problem.requests[:G]
            if n_pre:
                used[:n_pre] += pre_rows[2]
        res = None  # the device buffers are not needed past this point
        self.timings["device_ms"] = self.timings.get("device_ms", 0.0) + (
            (time.perf_counter() - t_dev) * 1e3
        )
        self.timings["n_rows"] = self.timings.get("n_rows", 0) + Nr
        self.timings["n_open"] = self.timings.get("n_open", 0) + n_open
        self._n_open_hist[hist_key] = n_open - n_pre
        self._nz_hist[hist_key] = total_nz
        if len(self._n_open_hist) > 256:  # bound: signatures are few in practice
            self._n_open_hist.clear()
            self._nz_hist.clear()
            self._refine_zero_streak.clear()
            self._refine_skip_ctr.clear()
        ranked_idx, ranked_n, best_price = (
            out["ranked_idx"], out["ranked_n"], out["best_price"]
        )
        # Commit-downsize: re-commit each fresh node to the cheapest type its
        # FINAL packed load fits (ranked[0] — feasibility, window and the
        # exotic filter all proven on the device).
        node_type = np.array(out["node_type"], copy=True)
        node_price = np.array(out["node_price"], copy=True)
        if n_open > n_pre and os.environ.get("KARPENTER_TPU_DOWNSIZE", "1") == "1":
            rows = np.arange(n_open)
            bp = np.asarray(best_price[:n_open], dtype=np.float32)
            down = (
                (rows >= n_pre)
                & (np.asarray(ranked_n[:n_open]) > 0)
                & np.isfinite(bp)
                & (bp + 1e-6 < node_price[:n_open])
            )
            if down.any():
                node_type[:n_open][down] = ranked_idx[:n_open, 0][down]
                node_price[:n_open][down] = bp[down]
        # reconstructed, not fetched: committed types index the catalog
        # capacity; pre-opened rows keep their node-reported allocatable
        node_cap = problem.capacity[node_type]
        if n_pre:
            node_cap[:n_pre] = pre_rows[3]

        # Packed-cost descent: drop plan nodes the rest of the plan absorbs.
        t_host = time.perf_counter()
        stale_rank = None
        run_refine = self.refine and n_open - n_pre > 2
        if run_refine and self._refine_zero_streak.get(hist_key, 0) >= 2:
            ctr = self._refine_skip_ctr.get(hist_key, 0) + 1
            self._refine_skip_ctr[hist_key] = ctr
            if ctr % 8 != 0:  # skip, but re-check every 8th solve
                run_refine = False
        if run_refine:
            dropped, stale_rank = _refine_plan(
                problem, node_type, node_price, used, node_window, placed, n_open,
                n_pre=n_pre, node_cap=node_cap,
            )
            if dropped.any():
                self._refine_zero_streak[hist_key] = 0
                self._refine_skip_ctr.pop(hist_key, None)
            else:
                self._refine_zero_streak[hist_key] = (
                    self._refine_zero_streak.get(hist_key, 0) + 1
                )
        specs, binds = _decode_nodes(
            problem,
            node_type,
            node_price,
            used,
            n_open,
            placed,
            problem.nodepool.name if problem.nodepool else "",
            node_window,
            ranked_idx=ranked_idx,
            ranked_n=ranked_n,
            stale_rank=stale_rank,
            n_pre=n_pre,
            pre_names=names,
        )
        unplaced = {g: int(c) for g, c in enumerate(unplaced_arr) if c > 0}
        self.timings["decode_ms"] = self.timings.get("decode_ms", 0.0) + (
            (time.perf_counter() - t_host) * 1e3
        )
        return specs, binds, unplaced

    def solve(self, pods, nodepools, catalog, in_use=None, occupancy=None, type_allow=None,
              reserved_allow=None, existing=None, nodeclass_by_pool=None,
              revision=None) -> SolveResult:
        _refuse_unsupported()
        return _solve_multi_nodepool(self, pods, nodepools, catalog, in_use, occupancy,
                                     type_allow, reserved_allow, existing,
                                     nodeclass_by_pool=nodeclass_by_pool,
                                     revision=revision)


def _enforce_pool_constraints(
    specs: list[NodeSpec],
    pool: NodePool,
    catalog: CatalogProvider,
    in_use,
    nodeclass=None,
) -> tuple[list[NodeSpec], list[tuple[Pod, str]]]:
    """Apply NodePool.spec.limits and requirement minValues to a node plan.

    Limits parity (core NodePool.spec.limits): cumulative *capacity* of
    launched nodes (plus capacity already in use) must not exceed the cap;
    nodes beyond it are rejected and their pods fall through.

    minValues parity: a launch whose instance-type flexibility has fewer
    distinct values for a minValues-bearing key than required is rejected.
    """
    min_values_keys = [
        (r.key, r.min_values) for r in pool.requirements if r.min_values
    ]
    kept: list[NodeSpec] = []
    rejected: list[tuple[Pod, str]] = []
    in_use = in_use.copy() if in_use is not None else ResourceVector()
    for spec in specs:
        if min_values_keys:
            ok = True
            for key, need in min_values_keys:
                distinct = {
                    catalog.get(name).labels().get(key)
                    for name in spec.instance_type_options
                    if catalog.get(name) is not None
                } - {None}
                if len(distinct) < need:
                    ok = False
                    for pod in spec.pods:
                        rejected.append(
                            (pod, f"minValues for {key} not met ({len(distinct)} < {need})")
                        )
                    break
            if not ok:
                continue
        if not pool.limits.unlimited:
            it = catalog.get(spec.instance_type_options[0])
            # capacity accounting must match what the claim will record
            # (nodeclass ephemeral rules), or limits drift from reality
            candidate = in_use + it.capacity(
                **(nodeclass.capacity_kwargs() if nodeclass else {})
            )
            if pool.limits.exceeded_by(candidate):
                for pod in spec.pods:
                    rejected.append((pod, "would exceed nodepool limits"))
                continue
            in_use = candidate
        kept.append(spec)
    return kept, rejected


def certainly_unplaceable(problem, pool_existing=None) -> list[Pod]:
    """Pods a pool's device solve is GUARANTEED to leave unplaced,
    computed host-side from the encode: a group with no instance type
    that is compatible AND finitely priced AND has a live (zone,
    captype) offering inside the group's window can never place —
    exactly the device scan's no-usable-type condition. (Capacity
    shortfalls are NOT certain: the scan retries at the full node
    bucket; limits/minValues rejections happen host-side after.)

    Pre-opened EXISTING rows weaken the condition (the double-placement
    bug): ffd._step's phase-1 first-fit gates
    only on committed-type compat + window intersection (ffd.py:91),
    NOT on live offerings or finite price, so a group the fresh-capacity
    test calls hopeless could still land on a live node's slack
    (spot offerings ICE'd while spot nodes run). Such a group is NOT
    certain; calling it certain chained its pods into pool k+1's
    pipelined problem while pool k's in-flight solve could still bind
    them — one pod placed twice. The predicate mirrors the device
    gate conservatively (no fit check: a non-fitting group merely
    rides the sequential straggler pass, it can never double-place).
    Hostname-capped groups are barred from pre-opened rows by the
    scan's ``pre_ok`` mask, so existing nodes don't rescue them."""
    G = len(problem.group_pods)
    live = np.einsum(
        "gzc,tzc->gt", problem.group_window[:G], problem.type_window
    ) > 0
    usable = (
        problem.compat[:G] & np.isfinite(problem.price[:G]) & live
    ).any(axis=1)
    if pool_existing and not usable.all():
        pre = _encode_existing(problem, pool_existing)
        if pre is not None:
            _, ptype, _pused, _pcap, pwin = pre
            compat_pre = problem.compat[:G][:, ptype]          # [G, P]
            win_pre = np.einsum(
                "gzc,pzc->gp", problem.group_window[:G], pwin
            ) > 0
            uncapped = problem.max_per_node[:G] >= (1 << 30)
            usable = usable | (
                (compat_pre & win_pre).any(axis=1) & uncapped
            )
    out: list[Pod] = []
    for g in np.nonzero(~usable)[0]:
        out.extend(problem.group_pods[g])
    return out


def _solve_multi_nodepool(
    impl, pods, nodepools, catalog, in_use=None, occupancy=None, type_allow=None,
    reserved_allow=None, existing=None, nodeclass_by_pool=None, revision=None,
) -> SolveResult:
    t0 = time.perf_counter()
    impl.timings = {}
    result = SolveResult(num_pods=len(pods))
    remaining: list[Pod] = list(pods)
    reasons: dict[str, str] = {}
    in_use = in_use or {}
    # State shared across pools AND relaxation rounds, so the relaxed round
    # never re-offers what an earlier round consumed:
    #  - used_delta: existing-node slack bound by earlier rounds
    #  - launched_extra: capacity launched per pool (counts against limits)
    used_delta: dict[str, np.ndarray] = {}
    launched_extra: dict[str, object] = {}

    def pool_encode(pods_in, pool, include_preferences):
        allowed = type_allow.get(pool.name) if type_allow else None
        # reserved_allow: per-pool gate on the pre-paid capacity type; pools
        # absent from an explicit map get no reserved access (isolation).
        allow_res = (
            reserved_allow.get(pool.name, False)
            if reserved_allow is not None
            else True
        )
        t_enc = time.perf_counter()
        problem = encode_problem(
            pods_in, catalog, nodepool=pool, occupancy=occupancy,
            allowed_types=allowed, allow_reserved=allow_res,
            include_preferences=include_preferences,
            nodeclass=(nodeclass_by_pool or {}).get(pool.name),
            revision=revision,
        )
        # accumulate across rounds: one solve() = one breakdown
        impl.timings["encode_ms"] = impl.timings.get("encode_ms", 0.0) + (
            (time.perf_counter() - t_enc) * 1e3
        )
        for pod, why in problem.unencodable:
            reasons[pod.uid] = f"nodepool {pool.name}: {why}"
        # This pool's own live nodes ride along as pre-opened capacity, with
        # slack already bound by earlier rounds subtracted.
        pool_existing = None
        if existing:
            pool_existing = []
            for e in existing:
                if e.nodepool_name != pool.name:
                    continue
                d = used_delta.get(e.name)
                pool_existing.append(
                    e if d is None else dataclasses.replace(e, used=e.used + d)
                )
        return problem, pool_existing

    def pool_round(pods_in, pool, include_preferences, staged=None):
        if staged is None:
            problem, pool_existing = pool_encode(pods_in, pool, include_preferences)
            solved = impl.solve_encoded(problem, existing=pool_existing)
        else:
            problem, solved = staged
        specs, binds, unplaced = solved
        for pod, name in binds:
            cur = used_delta.get(name)
            used_delta[name] = pod.requests.v if cur is None else cur + pod.requests.v
        result.binds.extend(binds)
        used = in_use.get(pool.name)
        extra = launched_extra.get(pool.name)
        if extra is not None:
            used = extra if used is None else used + extra
        pool_nc = (nodeclass_by_pool or {}).get(pool.name)
        specs, rejected = _enforce_pool_constraints(
            specs, pool, catalog, used, nodeclass=pool_nc
        )
        for spec in specs:
            it = catalog.get(spec.instance_type_options[0])
            if it is not None:
                cap = it.capacity(
                    **(pool_nc.capacity_kwargs() if pool_nc else {})
                )
                prev = launched_extra.get(pool.name)
                launched_extra[pool.name] = cap if prev is None else prev + cap
        result.node_specs.extend(specs)
        # pods that didn't land fall through
        leftover: list[Pod] = [p for p, _ in problem.unencodable]
        for pod, why in rejected:
            reasons[pod.uid] = f"nodepool {pool.name}: {why}"
            leftover.append(pod)
        for g, cnt in unplaced.items():
            plist = problem.group_pods[g]
            if problem.atomic is not None and problem.atomic[g]:
                # one unplaced unit = every pod of the co-located group
                tail = plist
            else:
                tail = plist[len(plist) - cnt:]
            leftover.extend(tail)
            for pod in tail:
                reasons[pod.uid] = (
                    f"nodepool {pool.name}: no instance type fits"
                )
        return leftover

    def full_round(pods_list, include_preferences):
        pools_order = sorted(nodepools, key=lambda p: -p.weight)
        if len(pools_order) <= 1:
            rem = pods_list
            for pool in pools_order:
                if not rem:
                    break
                rem = pool_round(rem, pool, include_preferences)
            return rem
        # Several pools: pool k+1 is offered the pods pool k is CERTAIN to
        # leave (host-computable from the encode), and their groups are
        # zeroed in pool k's problem so no pod is owned by two pools. Pods
        # a pool declined for other reasons (limits, minValues, rows) catch
        # up in a sequential straggler pass. The JAX package overlaps the
        # pools' device programs here; this package solves them in order,
        # with the same assignment of pods to pools.
        staged = []
        rem = pods_list
        for pool in pools_order:
            if not rem:
                break
            problem, pool_existing = pool_encode(rem, pool, include_preferences)
            certain = [p for p, _ in problem.unencodable]
            hopeless = certainly_unplaceable(problem, pool_existing)
            if hopeless:
                hopeless_uids = {p.uid for p in hopeless}
                counts = problem.counts.copy()
                for g, plist in enumerate(problem.group_pods):
                    if plist and plist[0].uid in hopeless_uids:
                        counts[g] = 0
                problem = dataclasses.replace(problem, counts=counts)
            certain += hopeless
            solved = impl.solve_encoded(problem, existing=pool_existing)
            staged.append((pool, problem, solved, {p.uid for p in certain}))
            rem = certain
        stragglers: list[Pod] = []
        for pool, problem, solved, certain_uids in staged:
            leftover = pool_round(
                None, pool, include_preferences, staged=(problem, solved)
            )
            stragglers += [p for p in leftover if p.uid not in certain_uids]
        if stragglers:
            later = stragglers
            for pool in pools_order:
                if not later:
                    break
                later = pool_round(later, pool, include_preferences)
            rem = rem + later
        return rem

    remaining = full_round(remaining, True)
    # Preference relaxation AFTER the full pool sweep (karpenter relaxes only
    # once every nodepool has been tried with preferences intact).
    prefs = [p for p in remaining if p.preferred_node_affinity]
    if prefs:
        others = [p for p in remaining if not p.preferred_node_affinity]
        remaining = others + full_round(prefs, False)
    for pod in remaining:
        result.unschedulable.append(
            (pod, reasons.get(pod.uid, "no nodepool can schedule this pod"))
        )
    result.total_cost = float(sum(s.estimated_price for s in result.node_specs))
    result.solve_seconds = time.perf_counter() - t0
    result.provenance = {
        "backend": impl.backend_label(),
        "device": impl.device_name(),
        "timings": dict(impl.timings),
    }
    return result
