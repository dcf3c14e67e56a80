"""The FFD solve as one CUDA kernel launch (``csrc/ffd.cu``).

The counterpart of the JAX package's ``ops/ffd_pallas.py``: the whole group
axis runs inside one kernel, on one thread-block cluster of ``CLUSTER`` CTAs,
with the node state resident in the shared memory of ``active_ctas(N, R)``
of them (or, past ``ffd_smem_bytes``'s budget, in a global scratch).
``ffd_solve`` takes the same arguments as ``ops.ffd.ffd_solve`` and returns
the same ``FFDResult``; ``ffd_solve_lanes`` runs L independent solves (the
optimizer lane's) as one launch of L clusters, as ``ops.ffd.ffd_solve_lanes``
runs them lane by lane.
Tensors on the CPU go through the plain version; tensors on a CUDA device
launch the kernel, or raise. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from . import ffd as _plain
from .ffd import FFDResult, _State

#: kernel launches since the last reset (a run sets it to 0 and reads it)
LAUNCHES = 0
#: lanes (clusters, one solve each) those launches ran: 1 per ``ffd_solve``
#: launch, L per ``ffd_solve_lanes`` launch
LANES = 0

#: CTAs of one problem's cluster, and threads of one CTA (``kCluster``, ``kThreads``)
CLUSTER = 8
_THREADS = 1024
_RESIDENT_PER = 3  # rows a thread owns on the resident branch (``kResPer``)
_GLOBAL_PER = 8    # and on the global branch (``kGlobalPer``)
_MAX_R = 16
_MAX_T = 2048      # two staged table rows of 8 bytes a type in static shared memory (``kMaxT``)
#: rows the kernel takes (on its global branch)
MAX_ROWS = CLUSTER * _THREADS * _GLOBAL_PER
#: shared memory one CTA may use on Hopper (dynamic + static)
SMEM_LIMIT_BYTES = 232_448
#: shared memory the kernel's static scratch may take (``kStaticReserve``)
_STATIC_SMEM_BYTES = 42 * 1024
_BIG = 1 << 30
_OCCUPANCY: dict = {}


def _row_bytes(n_res: int) -> int:
    return 8 * n_res + 8  # used and cap (R floats each), committed type, window bits


def active_ctas(n_rows: int, n_res: int) -> int:
    """CTAs of the cluster that hold rows: 1 where all N rows fit one CTA's
    shared memory at up to ``_RESIDENT_PER`` rows a thread (2,152 rows at
    R = 10), so that a group pays block barriers only, else ``CLUSTER``,
    which exchange their totals once a group. The whole cluster computes
    the prologue's per-type table either way."""
    one = (n_rows <= _THREADS * _RESIDENT_PER
           and n_rows * _row_bytes(n_res) + _STATIC_SMEM_BYTES <= SMEM_LIMIT_BYTES)
    return 1 if one else CLUSTER


def ffd_smem_bytes(n_rows: int, n_res: int) -> int:
    """Dynamic shared memory an active CTA needs to hold its slice of the
    node state: ``ceil(N / active_ctas(N, R))`` rows of ``8 R + 8`` bytes.
    Past ``SMEM_LIMIT_BYTES - _STATIC_SMEM_BYTES`` (17,216 rows at R = 10,
    11,136 at R = 16), or past ``_RESIDENT_PER`` rows a thread (24,576
    rows), the kernel keeps the state in a global scratch."""
    return -(-n_rows // active_ctas(n_rows, n_res)) * _row_bytes(n_res)


def resident(n_rows: int, n_res: int) -> bool:
    """Whether N rows of R resources stay in the cluster's shared memory."""
    return (ffd_smem_bytes(n_rows, n_res) + _STATIC_SMEM_BYTES <= SMEM_LIMIT_BYTES
            and -(-n_rows // active_ctas(n_rows, n_res)) <= _THREADS * _RESIDENT_PER)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ffd")
    lib.ffd_solve_launch.restype = ctypes.c_int
    lib.ffd_solve_launch.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p] * 28
    lib.ffd_max_active_clusters.restype = ctypes.c_int
    lib.ffd_max_active_clusters.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.ffd_record_bytes.restype = ctypes.c_int
    lib.ffd_record_bytes.argtypes = []
    lib.ffd_error_string.restype = ctypes.c_char_p
    lib.ffd_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"FFD kernel {what} failed: {lib.ffd_error_string(err).decode()} ({err})")


def cluster_occupancy(n_rows: int, n_res: int, device=None) -> int:
    """Clusters of the kernel's branch for (N, R) that fit on the card at
    once (``cudaOccupancyMaxActiveClusters``); raises where none fits."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    key = (dev.index, resident(n_rows, n_res), ffd_smem_bytes(n_rows, n_res),
           active_ctas(n_rows, n_res), n_res)
    hit = _OCCUPANCY.get(key)
    if hit is None:
        lib = _lib()
        out = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _raise_on(lib, lib.ffd_max_active_clusters(
                n_rows, n_res, active_ctas(n_rows, n_res), int(resident(n_rows, n_res)),
                ctypes.byref(out)), "occupancy query")
        if out.value < 1:
            raise RuntimeError(f"no cluster of {CLUSTER} CTAs fits the card at N={n_rows}, "
                               f"R={n_res}")
        hit = _OCCUPANCY[key] = out.value
    return hit


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ffd_solve(
    requests: torch.Tensor,      # [G, R] float32
    counts: torch.Tensor,        # [G] int32
    compat: torch.Tensor,        # [G, T] bool
    capacity: torch.Tensor,      # [T, R] float32
    price: torch.Tensor,         # [G, T] float32, inf where unusable
    group_window: torch.Tensor,  # [G] int32 window bits
    type_window: torch.Tensor,   # [T] int32 window bits
    max_per_node: Optional[torch.Tensor] = None,  # [G] int32
    max_nodes: int = 1024,
    init_state: Optional[_State] = None,
    n_pre: int = 0,
) -> FFDResult:
    """FFD over all groups: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if requests.device.type == "cpu":
        return _plain.ffd_solve(
            requests, counts, compat, capacity, price, group_window, type_window,
            max_per_node=max_per_node, max_nodes=max_nodes,
            init_state=init_state, n_pre=n_pre,
        )
    if requests.device.type != "cuda":
        raise ValueError(f"no FFD kernel for device {requests.device}")
    dev = requests.device
    G, R = requests.shape
    if max_per_node is None:
        max_per_node = torch.full((G,), _BIG, dtype=torch.int32, device=dev)
    state = init_state if init_state is not None else _plain.empty_state(max_nodes, R, dev)
    N = state.used.shape[0]
    if not 0 <= int(n_pre) <= N:
        raise ValueError(f"n_pre={n_pre} outside [0, {N}]")
    n_pre_t = torch.full((1,), int(n_pre), dtype=torch.int32, device=dev)
    one = [t.unsqueeze(0) for t in (requests, counts, compat, capacity, price, group_window,
                                    type_window, max_per_node)]
    out = _launch(*one, _State(*(t.unsqueeze(0) for t in state)), n_pre_t)
    return FFDResult(*(t[0] for t in out))


def ffd_solve_lanes(
    requests: torch.Tensor,      # [L, G, R] float32
    counts: torch.Tensor,        # [L, G] int32
    compat: torch.Tensor,        # [L, G, T] bool
    capacity: torch.Tensor,      # [L, T, R] float32
    price: torch.Tensor,         # [L, G, T] float32, inf where unusable
    group_window: torch.Tensor,  # [L, G] int32 window bits
    type_window: torch.Tensor,   # [L, T] int32 window bits
    max_per_node: torch.Tensor,  # [L, G] int32
    max_nodes: int,
) -> FFDResult:
    """L independent FFD solves, each from no open rows: ONE kernel launch of
    L clusters for CUDA tensors, the plain version lane by lane for CPU
    tensors. The result's fields carry the leading lane axis."""
    if requests.device.type == "cpu":
        return _plain.ffd_solve_lanes(requests, counts, compat, capacity, price, group_window,
                                      type_window, max_per_node, max_nodes)
    if requests.device.type != "cuda":
        raise ValueError(f"no FFD kernel for device {requests.device}")
    L, _G, R = requests.shape
    dev = requests.device
    empty = _plain.empty_state(max_nodes, R, dev)
    state = _State(*(t.unsqueeze(0).expand(L, *t.shape).contiguous() for t in empty))
    n_pre_t = torch.zeros(L, dtype=torch.int32, device=dev)
    return _launch(requests, counts, compat, capacity, price, group_window, type_window,
                   max_per_node, state, n_pre_t)


def _launch(requests, counts, compat, capacity, price, group_window, type_window,
            max_per_node, state: _State, n_pre_t) -> FFDResult:
    """One launch of ``L = requests.shape[0]`` clusters, one per lane; every
    argument carries the leading lane axis."""
    global LAUNCHES, LANES
    dev = requests.device
    L, G, R = requests.shape
    T = capacity.shape[1]
    if not 1 <= R <= _MAX_R:
        raise ValueError(f"R={R} resource axes; the kernel takes 1..{_MAX_R}")
    if not 1 <= T <= _MAX_T:
        raise ValueError(f"T={T} types; the kernel takes 1..{_MAX_T}")
    N = state.used.shape[1]
    for name, t, dtype, shape in (
        ("requests", requests, torch.float32, (G, R)),
        ("counts", counts, torch.int32, (G,)),
        ("compat", compat, torch.bool, (G, T)),
        ("capacity", capacity, torch.float32, (T, R)),
        ("price", price, torch.float32, (G, T)),
        ("group_window", group_window, torch.int32, (G,)),
        ("type_window", type_window, torch.int32, (T,)),
        ("max_per_node", max_per_node, torch.int32, (G,)),
        ("node_type", state.node_type, torch.int32, (N,)),
        ("node_price", state.node_price, torch.float32, (N,)),
        ("used", state.used, torch.float32, (N, R)),
        ("node_cap", state.node_cap, torch.float32, (N, R)),
        ("node_window", state.node_window, torch.int32, (N,)),
        ("n_open", state.n_open, torch.int32, ()),
        ("n_pre", n_pre_t, torch.int32, ()),
    ):
        _check(name, t, dtype, (L, *shape), dev)
    if not 1 <= N <= MAX_ROWS:
        raise ValueError(f"N={N} rows; the kernel takes 1..{MAX_ROWS}")
    on_chip = resident(N, R)
    cluster_occupancy(N, R, dev)

    out = FFDResult(
        node_type=torch.empty((L, N), dtype=torch.int32, device=dev),
        node_price=torch.empty((L, N), dtype=torch.float32, device=dev),
        used=torch.empty((L, N, R), dtype=torch.float32, device=dev),
        node_cap=torch.empty((L, N, R), dtype=torch.float32, device=dev),
        node_window=torch.empty((L, N), dtype=torch.int32, device=dev),
        n_open=torch.empty(L, dtype=torch.int32, device=dev),
        # the kernel stores only nonzero placements and unplaced counts
        placed=torch.zeros((L, G, N), dtype=torch.int32, device=dev),
        unplaced=torch.zeros((L, G), dtype=torch.int32, device=dev),
    )
    lib = _lib()
    Tp = -(-T // 4) * 4  # the table's row stride: 16-byte copies
    type_fit = torch.empty((L, G, Tp), dtype=torch.int32, device=dev)
    type_price = torch.empty((L, G, Tp), dtype=torch.float32, device=dev)
    recs = torch.empty((L * (G + 1) * lib.ffd_record_bytes(),), dtype=torch.uint8, device=dev)
    gstate = None if on_chip else torch.empty((L, 2, R, N), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ffd_solve_launch(
            L, active_ctas(N, R), G, T, R, N,
            requests.data_ptr(), counts.data_ptr(), compat.data_ptr(),
            capacity.data_ptr(), price.data_ptr(), group_window.data_ptr(),
            type_window.data_ptr(), max_per_node.data_ptr(), n_pre_t.data_ptr(),
            state.node_type.data_ptr(), state.node_price.data_ptr(),
            state.used.data_ptr(), state.node_cap.data_ptr(),
            state.node_window.data_ptr(), state.n_open.data_ptr(),
            out.node_type.data_ptr(), out.node_price.data_ptr(), out.used.data_ptr(),
            out.node_cap.data_ptr(), out.node_window.data_ptr(), out.placed.data_ptr(),
            out.unplaced.data_ptr(), out.n_open.data_ptr(), type_fit.data_ptr(),
            type_price.data_ptr(), recs.data_ptr(),
            gstate.data_ptr() if gstate is not None else None, stream,
        )
    _raise_on(lib, err, "launch")
    LAUNCHES += 1
    LANES += L
    return out
