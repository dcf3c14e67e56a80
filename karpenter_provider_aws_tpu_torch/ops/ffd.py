"""First-fit-decreasing over pod groups: the plain PyTorch version.

The counterpart of the JAX package's ``ops/ffd.py``. Each step places a whole
group multiplicity at once:

 1. Fill open nodes in index order (first-fit): per node, how many of this
    group fit in the remaining capacity; an exclusive prefix sum turns the
    sequential "place then update" loop into one vector expression.
 2. For the remainder, open new nodes of the type minimizing
    ``price / pods-per-node``; every full node of the winner opens at once,
    the partial tail re-chooses.

Nodes carry a joint (zone x capacity-type) offering window that narrows as
groups land. Here the window is an int32 bitmask per node (bit ``z*C + c``,
``pack_window_bits``): intersection is ``&`` and emptiness is ``== 0``, the
same encoding the CUDA kernel uses, so both versions share one state layout.

This module is the reference the CUDA kernel (``ops/ffd_cuda.py``) is held
against, and it is what a CPU tensor runs. The group loop is a Python loop:
it runs on whatever device its tensors are on, one small op at a time.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

_EPS = 1e-4
_BIG = 1 << 30


class FFDResult(NamedTuple):
    node_type: torch.Tensor    # [N] int32, index into types; valid where < n_open
    node_price: torch.Tensor   # [N] float32 $/hr committed at open
    used: torch.Tensor         # [N, R] float32 resources packed onto each node
    node_cap: torch.Tensor     # [N, R] float32 allocatable of committed type
    node_window: torch.Tensor  # [N] int32 remaining (zone, captype) window bits
    n_open: torch.Tensor       # [] int32 number of nodes opened
    placed: torch.Tensor       # [G, N] int32 pods of group g placed on node n
    unplaced: torch.Tensor     # [G] int32 pods that fit nowhere (or overflowed N)

    def total_cost(self) -> torch.Tensor:
        """$/hr of the opened rows, summed in float64 (one sum per lane
        where the fields carry a leading lane axis)."""
        n = self.node_price.shape[-1]
        live = torch.arange(n, device=self.node_price.device) < self.n_open[..., None]
        return torch.where(live, self.node_price.double(), 0.0).sum(-1)


class _State(NamedTuple):
    node_type: torch.Tensor    # [N] int32
    node_price: torch.Tensor   # [N] float32
    used: torch.Tensor         # [N, R] float32
    node_cap: torch.Tensor     # [N, R] float32
    node_window: torch.Tensor  # [N] int32 window bits
    n_open: torch.Tensor       # [] int32


def pack_window_bits(win: np.ndarray) -> np.ndarray:
    """[*, Z, C] bool -> [*] int32 bitmask (bit z*C + c)."""
    win = np.asarray(win, dtype=bool)
    if win.shape[-2] * win.shape[-1] > 31:
        raise ValueError(f"window bits {win.shape[-2] * win.shape[-1]} exceed int32")
    flat = win.astype(np.int64).reshape(*win.shape[:-2], -1)
    weights = 1 << np.arange(flat.shape[-1], dtype=np.int64)
    return (flat * weights).sum(axis=-1).astype(np.int32)


def unpack_window_bits(bits: np.ndarray, Z: int, C: int) -> np.ndarray:
    """[N] int32 -> [N, Z, C] bool."""
    bits = np.asarray(bits, dtype=np.int64)
    flags = (bits[:, None] >> np.arange(Z * C, dtype=np.int64)[None, :]) & 1
    return (flags == 1).reshape(bits.shape[0], Z, C)


def empty_state(N: int, R: int, device, n_open: int = 0) -> _State:
    """Fresh node state: no rows open (or ``n_open`` rows described later)."""
    return _State(
        node_type=torch.zeros(N, dtype=torch.int32, device=device),
        node_price=torch.zeros(N, dtype=torch.float32, device=device),
        used=torch.zeros((N, R), dtype=torch.float32, device=device),
        node_cap=torch.zeros((N, R), dtype=torch.float32, device=device),
        node_window=torch.zeros(N, dtype=torch.int32, device=device),
        n_open=torch.tensor(n_open, dtype=torch.int32, device=device),
    )


def _fit_counts(cap_rem: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[..., R] remaining capacity x [R] request -> [...] int64 how many fit.

    float32 ``floor((free + 1e-4) / req)`` over the requested axes, min over
    them, clamped to [0, 2^30] (an all-zero request fits "unboundedly")."""
    with_req = req > 0
    safe = torch.where(with_req, req, torch.ones_like(req))
    ratio = torch.floor((cap_rem + _EPS) / safe)
    ratio = torch.where(with_req, ratio, torch.full_like(ratio, float("inf")))
    k = torch.clamp(ratio.amin(dim=-1), 0.0, float(_BIG))
    return k.to(torch.int64)


def _step(capacity, type_window, n_pre: int, state: _State, req, cnt: int,
          compat_g, price_g, gw: int, mpn: int):
    """One group: first-fit onto open rows, then open rows for the rest.

    Returns (placed row [N] int32, unplaced count). The state's tensors are
    updated in place (the caller owns them)."""
    node_type, node_price, used, node_cap, node_window, n_open_t = state
    N = used.shape[0]
    dev = used.device
    n_open = int(n_open_t)
    idx = torch.arange(N, device=dev)

    # -- 1. first-fit fill of open nodes ----------------------------------
    window_ok = (node_window & gw) != 0
    # Pre-opened rows [0, n_pre) are existing cluster nodes; hostname-capped
    # groups stay off them (the per-node cap cannot see pods bound there).
    pre_ok = mpn >= _BIG
    node_ok = (idx < n_open) & compat_g[node_type.long()] & window_ok
    if not pre_ok:
        node_ok &= idx >= n_pre
    k_fit = torch.clamp(_fit_counts(node_cap - used, req), max=mpn)
    k_fit = torch.where(node_ok, k_fit, 0)
    # int64 prefix: k is clamped to 2^30 per row, so an int32 sum can wrap
    cum_before = torch.cumsum(k_fit, 0) - k_fit
    place = torch.minimum(torch.clamp(cnt - cum_before, min=0), k_fit)
    used += place.to(torch.float32)[:, None] * req[None, :]
    node_window[:] = torch.where(place > 0, node_window & gw, node_window)
    placed_row = place.to(torch.int32)
    rem = cnt - int(place.sum())

    # -- 2. open new nodes for the remainder ------------------------------
    # While the remainder >= the chosen type's capacity the choice is
    # stable, so each iteration opens ALL full nodes of the current winner;
    # the partial tail re-chooses.
    k_type = _fit_counts(capacity, req)                      # [T]
    feasible = compat_g & (k_type >= 1) & torch.isfinite(price_g)
    k_cap = torch.clamp(k_type, max=mpn)
    inf = torch.full_like(price_g, float("inf"))
    unplaced = 0
    while rem > 0:
        eff = torch.clamp(torch.clamp(k_cap, max=max(rem, 1)), min=1)
        score = torch.where(feasible, price_g / eff.to(torch.float32), inf)
        t_star = int(torch.argmin(score))
        ok = bool(torch.isfinite(score[t_star]))
        k_star = max(min(int(k_type[t_star]), mpn), 1)
        room = N - n_open
        q = rem // k_star
        q = min(q if q >= 1 else 1, room)
        if not (ok and room > 0):
            unplaced += rem
            break
        rows = slice(n_open, n_open + q)
        take = torch.clamp(
            rem - torch.arange(q, device=dev, dtype=torch.int64) * k_star, 0, k_star
        )
        used[rows] = take.to(torch.float32)[:, None] * req[None, :]
        node_type[rows] = t_star
        node_price[rows] = price_g[t_star]
        node_cap[rows] = capacity[t_star]
        node_window[rows] = gw & int(type_window[t_star])
        placed_row[rows] = take.to(torch.int32)
        rem -= min(rem, q * k_star)
        n_open += q
    n_open_t.fill_(n_open)
    return placed_row, unplaced


def ffd_solve(
    requests: torch.Tensor,      # [G, R] float32 (FFD-sorted by encode)
    counts: torch.Tensor,        # [G] int32
    compat: torch.Tensor,        # [G, T] bool
    capacity: torch.Tensor,      # [T, R] float32 allocatable
    price: torch.Tensor,         # [G, T] float32, inf where unusable
    group_window: torch.Tensor,  # [G] int32 (zone, captype) bits the group allows
    type_window: torch.Tensor,   # [T] int32 live-offering bits per type
    max_per_node: Optional[torch.Tensor] = None,  # [G] int32 hostname cap
    max_nodes: int = 1024,
    init_state: Optional[_State] = None,
    n_pre: int = 0,
) -> FFDResult:
    """The FFD solve over all G groups, on the tensors' device.

    ``init_state`` carries pre-opened rows: when its first ``n_pre`` rows
    describe existing cluster nodes (committed type, current usage, one-hot
    window bits, price 0), the first-fit phase lands pods on their slack
    before any new node opens. It is copied, never modified."""
    G, R = requests.shape
    dev = requests.device
    if max_per_node is None:
        max_per_node = torch.full((G,), _BIG, dtype=torch.int32, device=dev)
    if init_state is None:
        state = empty_state(max_nodes, R, dev)
    else:
        state = _State(*(t.clone() for t in init_state))
    N = state.used.shape[0]
    placed = torch.zeros((G, N), dtype=torch.int32, device=dev)
    unplaced = torch.zeros(G, dtype=torch.int32, device=dev)
    # host copies of the per-group scalars: the loop branches on them
    counts_h = counts.cpu().tolist()
    gw_h = group_window.cpu().tolist()
    mpn_h = [min(int(m), _BIG) for m in max_per_node.cpu().tolist()]
    for g in range(G):
        if counts_h[g] == 0:
            continue  # places nothing and changes no row, as the kernel skips it
        placed[g], u = _step(
            capacity, type_window, int(n_pre), state, requests[g],
            counts_h[g], compat[g], price[g], gw_h[g], mpn_h[g],
        )
        unplaced[g] = u
    return FFDResult(*state[:6], placed=placed, unplaced=unplaced)


def ffd_solve_lanes(
    requests: torch.Tensor,      # [L, G, R] float32
    counts: torch.Tensor,        # [L, G] int32
    compat: torch.Tensor,        # [L, G, T] bool
    capacity: torch.Tensor,      # [L, T, R] float32
    price: torch.Tensor,         # [L, G, T] float32, inf where unusable
    group_window: torch.Tensor,  # [L, G] int32
    type_window: torch.Tensor,   # [L, T] int32
    max_per_node: torch.Tensor,  # [L, G] int32
    max_nodes: int,
    init_state: Optional[_State] = None,  # fields with a leading [L] axis
    n_pre: Optional[torch.Tensor] = None,  # [L] int32 pre-opened rows a lane
) -> FFDResult:
    """L independent solves, one ``ffd_solve`` per lane, each from no open
    rows or, with ``init_state``, from its lane of the stacked state and
    its ``n_pre``; the fields of the result carry the leading lane axis.
    The plain counterpart of ``ops.ffd_cuda.ffd_solve_lanes``' single
    launch."""
    L = requests.shape[0]
    n_pre_h = [0] * L if n_pre is None else [int(v) for v in n_pre.cpu().tolist()]
    outs = [
        ffd_solve(requests[i], counts[i], compat[i], capacity[i], price[i], group_window[i],
                  type_window[i], max_per_node=max_per_node[i], max_nodes=max_nodes,
                  init_state=None if init_state is None else _State(*(f[i] for f in init_state)),
                  n_pre=n_pre_h[i])
        for i in range(L)
    ]
    return FFDResult(*(torch.stack(f) for f in zip(*outs)))


def compact_plan(placed: torch.Tensor, max_entries: int):
    """Sparse (flat-index, count) encoding of the placement matrix.

    Returns ``(flat_idx [E] int32, count [E] int32, total_nonzero [] int32)``
    in row-major order with ``flat_idx = -1`` padding; if ``total_nonzero >
    max_entries`` the caller must fetch the dense matrix. No host sync: the
    nonzeros scatter to their prefix-sum positions."""
    flat = placed.reshape(-1)
    nz_mask = flat > 0
    pos = torch.cumsum(nz_mask, 0) - 1
    E = int(max_entries)
    dest = torch.where(nz_mask & (pos < E), pos, E)
    src = torch.arange(flat.shape[0], device=flat.device, dtype=torch.int64)
    nz = torch.full((E + 1,), -1, dtype=torch.int64, device=flat.device)
    nz.scatter_(0, dest, torch.where(dest < E, src, -1))
    nz = nz[:E]
    cnt = torch.where(nz >= 0, flat[nz.clamp(min=0)], 0)
    return nz.to(torch.int32), cnt.to(torch.int32), nz_mask.sum().to(torch.int32)


def rank_launch_options(
    placed: torch.Tensor,       # [G, N] int32 pods of group g on node n
    price: torch.Tensor,        # [G, T] float32, inf where group can't use type
    used: torch.Tensor,         # [N, R] resources packed per node
    capacity: torch.Tensor,     # [T, R] allocatable per type
    type_window: torch.Tensor,  # [T] int32 live-offering bits
    node_window: torch.Tensor,  # [N] int32 remaining node window bits
    node_type: torch.Tensor,    # [N] committed type
    exotic: torch.Tensor,       # [T] bool bare-metal mask
    k: int = 60,
):
    """Ranked launch alternatives per node.

    Combined group price (max over the node's groups), capacity fit, window
    intersection, the exotic-type filter, then the k cheapest. Returns
    ``(idx [N, k] int16, n_valid [N] int16, best_price [N] float32)``; the
    first n_valid[n] entries of row n are real candidates. Ties keep the
    lowest type index first (a stable sort, as ``lax.top_k`` orders them)."""
    mask = (placed > 0).T                       # [N, G]
    N, T = node_window.shape[0], price.shape[1]
    G_ = price.shape[0]
    # combined[n, t] = max over groups on n of price[g, t] (inf -> a group
    # can't use the type; -inf -> empty node), in node tiles bounded so
    # [TILE, G, T] stays under ~256 MB
    TILE = int(max(8, min(512, (256 << 20) // max(1, G_ * T * 4))))
    neg_inf = torch.tensor(float("-inf"), device=price.device)
    combined = torch.cat([
        torch.where(mask[s:s + TILE, :, None], price[None, :, :], neg_inf).amax(dim=1)
        for s in range(0, N, TILE)
    ], dim=0) if N else torch.empty((0, T), device=price.device)
    fits = (used[:, None, :] <= capacity[None, :, :] + _EPS).all(-1)   # [N, T]
    window = (type_window[None, :] & node_window[:, None]) != 0
    usable = torch.isfinite(combined) & fits & window
    # exotic filter: drop bare-metal when a standard type qualifies and the
    # committed type itself is not bare-metal
    nonexotic_ok = (usable & ~exotic[None, :]).any(-1) & ~exotic[node_type.long()]
    usable &= ~(exotic[None, :] & nonexotic_ok[:, None])
    score = torch.where(usable, combined, torch.tensor(float("inf"), device=price.device))
    sorted_score, order = torch.sort(score, dim=1, stable=True)
    idx = order[:, :k]
    top = sorted_score[:, :k]
    n_valid = torch.isfinite(top).sum(dim=1).to(torch.int16)
    return idx.to(torch.int16), n_valid, top[:, 0]
