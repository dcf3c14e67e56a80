"""Partition lanes on one card, and the cross-partition plan merge.

The counterpart of the lane half of the JAX package's ``parallel/mesh.py``:

- ``stack_lane_problems`` stacks K group-padded ``EncodedProblem``s onto a
  leading lane axis with common type and zone buckets (numpy, copied);
- ``solve_partition_lanes`` runs the K lanes as ONE launch of the FFD
  kernel (``ops.ffd_cuda.ffd_solve_lanes``), each lane from its own
  pre-opened rows and ``n_pre``; CPU tensors run the plain version lane by
  lane. There is no fallback between the two;
- ``merge_partition_plans`` flattens the lanes' plans into one node
  namespace and runs the packed-cost descent over the concatenated group
  axis (numpy, copied), so an under-filled tail node of one partition
  drains into another partition's slack.

``lanes_mode()`` answers ``"vmap"``: one card runs every lane in one
launch. The reference's ``"shard_map"`` (lanes sharded over a device mesh),
``make_mesh``, ``solve_sharded``, ``screen_sharded`` and
``merge_sharded_plan`` need more than one device; they raise
``NotImplementedError`` until the 4-card slice carries them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_NO_MESH = ("the multi-device partition paths (a device mesh, the sharded solve, screen "
            "and merge, lanes sharded over devices) need more than one card; this "
            "package runs partition lanes on one card, and the 4-card slice carries "
            "these")

#: the fields of a stacked lane problem, in the FFD kernel's argument order
LANE_FIELDS = ("requests", "counts", "compat", "capacity", "price", "group_window",
               "type_window", "max_per_node")


def make_mesh(n_devices: Optional[int] = None):
    raise NotImplementedError(_NO_MESH)


def solve_sharded(*args, **kwargs):
    raise NotImplementedError(_NO_MESH)


def screen_sharded(*args, **kwargs):
    raise NotImplementedError(_NO_MESH)


def merge_sharded_plan(*args, **kwargs):
    raise NotImplementedError(_NO_MESH)


def lanes_mode() -> str:
    """How partition lanes run here: ``"vmap"``, every lane in one launch
    on one card (the reference's name for its single-program lanes)."""
    return "vmap"


def stack_lane_problems(padded_list):
    """Stack K group-padded ``EncodedProblem``s onto a leading lane axis
    with common type/zone buckets. Padded types are structurally unusable
    (compat False, price inf, dead offering windows) and padded zones carry
    no offerings, so every lane solves exactly its own problem; committed
    type indices stay valid in each lane's ORIGINAL axis (padding appends).
    Returns (args dict of stacked numpy arrays, (TB, ZB))."""
    TB = max(p.capacity.shape[0] for p in padded_list)
    ZB = max(p.group_window.shape[1] for p in padded_list)

    def padTZ(a, t_axis=None, z_axis=None, fill=0):
        widths = [(0, 0)] * a.ndim
        if t_axis is not None:
            widths[t_axis] = (0, TB - a.shape[t_axis])
        if z_axis is not None:
            widths[z_axis] = (0, ZB - a.shape[z_axis])
        if not any(w != (0, 0) for w in widths):
            return a
        return np.pad(a, widths, constant_values=fill)

    args = {
        "requests": np.stack([p.requests for p in padded_list]),
        "counts": np.stack([p.counts for p in padded_list]),
        "compat": np.stack([padTZ(p.compat, t_axis=1) for p in padded_list]),
        "capacity": np.stack([padTZ(p.capacity, t_axis=0) for p in padded_list]),
        "price": np.stack(
            [padTZ(p.price, t_axis=1, fill=np.inf) for p in padded_list]
        ),
        "group_window": np.stack(
            [padTZ(p.group_window, z_axis=1) for p in padded_list]
        ),
        "type_window": np.stack(
            [padTZ(p.type_window, t_axis=0, z_axis=1) for p in padded_list]
        ),
        "max_per_node": np.stack([p.max_per_node for p in padded_list]),
    }
    return args, (TB, ZB)


def stack_lane_states(pre, max_nodes: int, R: int, ZB: int, C: int) -> tuple:
    """The lanes' initial node state as host arrays of ``max_nodes`` rows a
    lane: lane k's first rows are ``pre[k]``, ``(node_type, used, node_cap,
    node_window [n, Z, C] bool)`` of its ``n`` pre-opened live rows (price
    0), or none where ``pre[k]`` is None. Returns ((node_type, node_price,
    used, node_cap, node_window [K, N, ZB, C], n_open), n_pres)."""
    K = len(pre)
    state = (np.zeros((K, max_nodes), np.int32), np.zeros((K, max_nodes), np.float32),
             np.zeros((K, max_nodes, R), np.float32), np.zeros((K, max_nodes, R), np.float32),
             np.zeros((K, max_nodes, ZB, C), bool), np.zeros(K, np.int32))
    for k, rows in enumerate(pre):
        if rows is None:
            continue
        ptype, pused, pcap, pwin = rows
        n = len(ptype)
        state[0][k, :n] = ptype
        state[2][k, :n] = pused
        state[3][k, :n] = pcap
        state[4][k, :n, : pwin.shape[1]] = pwin
        state[5][k] = n
    return state, [int(v) for v in state[5]]


def lane_tensors(args, device) -> dict:
    """``stack_lane_problems``' arrays as the FFD kernel takes them, on
    ``device``: float32 requests, capacity and price, int32 counts and
    hostname caps (clamped to 2^30), and the (zone, capacity type) windows
    packed into int32 bits (bit ``z*C + c``; the common zone bucket appends
    zones, so a lane's bits are those of its own axis)."""
    from ..ops.ffd import pack_window_bits

    host = {
        "requests": args["requests"].astype(np.float32),
        "counts": args["counts"].astype(np.int32),
        "compat": args["compat"].astype(bool),
        "capacity": args["capacity"].astype(np.float32),
        "price": args["price"].astype(np.float32),
        "group_window": pack_window_bits(args["group_window"]),
        "type_window": pack_window_bits(args["type_window"]),
        "max_per_node": np.minimum(args["max_per_node"].astype(np.int64), 1 << 30)
        .astype(np.int32),
    }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}


def lane_state(init_state, device):
    """A lane-stacked ``ops.ffd._State`` on ``device`` from host arrays:
    node_type [K, N], node_price [K, N], used and node_cap [K, N, R],
    node_window [K, N, ZB, C] bool (packed into int32 bits), n_open [K]."""
    from ..ops.ffd import _State, pack_window_bits

    node_type, node_price, used, node_cap, node_window, n_open = init_state
    host = (np.asarray(node_type, dtype=np.int32), np.asarray(node_price, dtype=np.float32),
            np.asarray(used, dtype=np.float32), np.asarray(node_cap, dtype=np.float32),
            pack_window_bits(node_window), np.asarray(n_open, dtype=np.int32))
    return _State(*(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host))


def solve_partition_lanes(args, init_state, n_pres, max_nodes: int, device=None,
                          mode: Optional[str] = None):
    """Run K stacked lanes (``stack_lane_problems``' arrays) as ONE launch
    of the FFD kernel on a CUDA ``device`` (the default), or lane by lane
    through the plain version on the CPU. ``init_state`` is the lanes'
    pre-opened rows as host arrays (see :func:`lane_state`), ``n_pres`` the
    per-lane pre-row counts; every lane has ``max_nodes`` rows. Returns the
    batched ``FFDResult`` (leading lane axis, window bits) and the lane
    tensors on the device. ``mode`` ``"shard_map"`` raises: one card."""
    from ..ops import ffd_cuda

    mode = mode or lanes_mode()
    if mode != "vmap":
        raise NotImplementedError(_NO_MESH)
    dev = torch.device("cuda" if device is None else device)
    t = lane_tensors(args, dev)
    state = lane_state(init_state, dev)
    if state.used.shape[1] != max_nodes:
        raise ValueError(f"the initial state has {state.used.shape[1]} rows, "
                         f"max_nodes is {max_nodes}")
    n_pre = torch.from_numpy(np.asarray(n_pres, dtype=np.int32)).to(dev)
    res = ffd_cuda.ffd_solve_lanes(*(t[k] for k in LANE_FIELDS), max_nodes=max_nodes,
                                   init_state=state, n_pre=n_pre)
    return res, t


def lane_plans(problems, res) -> list[dict]:
    """The lanes of a ``solve_partition_lanes`` result as host plan dicts
    (node_type, node_price, used, node_window [N, Z, C] bool on the lane's
    own zone axis, placed, n_open), as ``merge_partition_plans`` takes
    them: ONE device-to-host copy per field."""
    from ..ops.ffd import unpack_window_bits

    host = {f: getattr(res, f).cpu().numpy()
            for f in ("node_type", "node_price", "used", "node_window", "placed", "n_open")}
    out = []
    for k, p in enumerate(problems):
        Z, C = p.group_window.shape[1], p.group_window.shape[2]
        out.append({
            "node_type": host["node_type"][k],
            "node_price": host["node_price"][k],
            "used": host["used"][k],
            "node_window": unpack_window_bits(host["node_window"][k], Z, C),
            "placed": host["placed"][k],
            "n_open": int(host["n_open"][k]),
        })
    return out


def merge_partition_plans(problems, lane_plans, max_tries: int = 512,
                          util_threshold: float = 0.97):
    """Cross-partition plan merge: flatten per-partition lane plans into
    one global node namespace and run the packed-cost descent over the
    CONCATENATED group axis: an under-filled tail node from one partition
    drains into another partition's slack whenever group compatibility,
    windows, and hostname caps allow.

    ``problems`` must share a zone axis (partitions of one pool do);
    ``lane_plans`` are per-lane dicts with node_type/node_price/used/
    node_window/placed/n_open in host numpy. Returns the merged plan dict
    with cost_lanes / cost_merged.
    """
    from ..scheduling.solver import _refine_plan

    first = problems[0]
    for p in problems[1:]:
        if p.zones != first.zones:
            raise ValueError("merge_partition_plans needs a shared zone axis")
    # Union type axis by NAME: per-problem type-axis compaction keeps only
    # types with live offerings inside that problem's window, so two zone
    # partitions of one pool legitimately carry different type axes.
    union: list = list(first.type_names)
    uidx = {n: i for i, n in enumerate(union)}
    for p in problems[1:]:
        for n in p.type_names:
            if n not in uidx:
                uidx[n] = len(union)
                union.append(n)
    T = len(union)
    R = first.capacity.shape[1]
    Z, C = first.group_window.shape[1], first.group_window.shape[2]
    capacity = np.zeros((T, R), dtype=first.capacity.dtype)
    type_window = np.zeros((T, Z, C), dtype=bool)
    type_exotic = np.zeros(T, dtype=bool)
    tmaps = []
    for p in problems:
        tmap = np.array([uidx[n] for n in p.type_names], dtype=np.int64)
        tmaps.append(tmap)
        capacity[tmap] = p.capacity
        type_window[tmap] |= p.type_window
        if p.type_exotic is not None:
            type_exotic[tmap] |= p.type_exotic
    Gs = [len(p.group_pods) for p in problems]
    G = sum(Gs)

    def remapT(p, tmap, a, fill):
        out = np.full((a.shape[0], T), fill, dtype=a.dtype)
        out[:, tmap] = a
        return out

    combined = dataclasses.replace(
        first,
        requests=np.concatenate([p.requests[: len(p.group_pods)] for p in problems]),
        counts=np.concatenate([p.counts[: len(p.group_pods)] for p in problems]),
        compat=np.concatenate([
            remapT(p, tm, p.compat[: len(p.group_pods)], False)
            for p, tm in zip(problems, tmaps)
        ]),
        price=np.concatenate([
            remapT(p, tm, p.price[: len(p.group_pods)], np.inf)
            for p, tm in zip(problems, tmaps)
        ]),
        capacity=capacity,
        type_window=type_window,
        type_exotic=type_exotic,
        type_names=tuple(union),
        group_window=np.concatenate(
            [p.group_window[: len(p.group_pods)] for p in problems]
        ),
        max_per_node=np.concatenate(
            [p.max_per_node[: len(p.group_pods)] for p in problems]
        ),
        group_pods=[pl for p in problems for pl in p.group_pods],
        atomic=(
            np.concatenate([
                (p.atomic[: len(p.group_pods)] if p.atomic is not None
                 else np.zeros(len(p.group_pods), dtype=bool))
                for p in problems
            ])
            if any(p.atomic is not None for p in problems) else None
        ),
    )
    n_opens = [int(pl["n_open"]) for pl in lane_plans]
    offsets = np.concatenate([[0], np.cumsum(n_opens)]).astype(int)
    M = int(offsets[-1])
    m_type = np.zeros(M, dtype=np.int64)
    m_price = np.zeros(M, dtype=np.float32)
    m_used = np.zeros((M, R), dtype=np.float32)
    m_window = np.zeros((M, Z, C), dtype=bool)
    m_placed = np.zeros((G, M), dtype=np.int64)
    g_off = 0
    for k, (p, pl) in enumerate(zip(problems, lane_plans)):
        lo, hi = offsets[k], offsets[k + 1]
        n = hi - lo
        m_type[lo:hi] = tmaps[k][np.asarray(pl["node_type"][:n], dtype=np.int64)]
        m_price[lo:hi] = pl["node_price"][:n]
        m_used[lo:hi] = pl["used"][:n]
        m_window[lo:hi] = pl["node_window"][:n, :Z]
        m_placed[g_off:g_off + Gs[k], lo:hi] = pl["placed"][: Gs[k], :n]
        g_off += Gs[k]
    cost_lanes = float(m_price.sum())
    dropped, _ = _refine_plan(
        combined, m_type, m_price, m_used, m_window, m_placed, M,
        max_tries=max_tries, util_threshold=util_threshold,
    )
    cost_merged = float(np.where(~dropped, m_price, 0.0).sum())
    return {
        "node_type": m_type,
        "node_price": m_price,
        "used": m_used,
        "node_window": m_window,
        "placed": m_placed,
        "n_open": M,
        "dropped": dropped,
        "cost_lanes": cost_lanes,
        "cost_merged": cost_merged,
    }
