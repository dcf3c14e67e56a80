"""The consolidation repack screen as three CUDA kernel launches (``csrc/repack.cu``).

The counterpart of the JAX package's ``ops/repack_pallas.py``. The first
launches build a fit table on the base free capacity, once per screen (per
group and node the fit's int64 prefix, in tiles of 1,024 nodes and a short
pass that carries the tiles' sums and lists each group's rows with room);
the last gives every candidate its verdict from that table, one warp per
candidate. A warp keeps, per earlier slot of its candidate, only the row
where the slot's first fit stopped and what it placed there, and replays a
row's free from those where it needs it, so no bound is put on the rows a
candidate fills. ``repack_check`` takes the same arguments as the plain
``ops.consolidate.repack_check`` and returns the same ``ok[C]``, for
requests and caps that are not negative (as the encoder writes them): the
kernels trap on a negative or NaN request or float cap, and the error
raises at the next synchronisation, as any fault on the device does.
Tensors on the CPU go through the plain version; tensors on a CUDA device
launch the kernels, or raise. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: screens launched on the kernels since the last reset (a run sets it to 0
#: and reads it); a screen is the table's launches and the verdicts'
LAUNCHES = 0

_MAX_R = 16
#: most slots a node's table may have: one warp's slot table (96 bytes a
#: slot, ``sizeof(Slot)``) in one block's shared memory (``kSmemLimit``)
MAX_SLOTS = 232448 // 96
_TABLE_TILE = 1024  # nodes a table block takes (``kTableThreads``)
_CAP_KIND = {torch.bool: 0, torch.uint16: 1, torch.float32: 2}


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("repack")
        lib.repack_launch.restype = ctypes.c_int
        lib.repack_launch.argtypes = (
            [ctypes.c_int] * 5 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4
        )
        lib.repack_error_string.restype = ctypes.c_char_p
        lib.repack_error_string.argtypes = [ctypes.c_int]
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, dtypes: tuple, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def repack_check(
    free: torch.Tensor,          # [N, R] float32
    requests: torch.Tensor,      # [G, R] float32
    group_ids: torch.Tensor,     # [N, S] int32
    group_counts: torch.Tensor,  # [N, S] int32
    cap: torch.Tensor,           # [G, N] bool, uint16 or float32
    candidates: torch.Tensor,    # [C] int32 node indices
    chunk: int = 512,
) -> torch.Tensor:
    """ok[C] (bool): the kernels for CUDA tensors, the plain version for CPU
    tensors (``chunk`` sizes the plain version's candidate batches; the
    kernels take every candidate in one screen). ``requests`` and a float
    ``cap`` must hold no negative or NaN value: the kernels trap on one."""
    if free.device.type == "cpu":
        from .consolidate import repack_check as plain

        return plain(free, requests, group_ids, group_counts, cap, candidates, chunk=chunk)
    if free.device.type != "cuda":
        raise ValueError(f"no repack kernel for device {free.device}")
    return _launch(free, requests, group_ids, group_counts, cap, candidates)


def _launch(free, requests, group_ids, group_counts, cap, candidates) -> torch.Tensor:
    global LAUNCHES
    dev = free.device
    N, R = free.shape
    G = requests.shape[0]
    S = group_ids.shape[1]
    C = candidates.shape[0]
    if not 1 <= R <= _MAX_R:
        raise ValueError(f"R={R} resource axes; the kernel takes 1..{_MAX_R}")
    if N < 1:
        raise ValueError("the screen needs at least one node")
    if S > MAX_SLOTS:
        raise ValueError(f"S={S} slots a node; the kernel takes up to {MAX_SLOTS}")
    for name, t, dtypes, shape in (
        ("free", free, (torch.float32,), (N, R)),
        ("requests", requests, (torch.float32,), (G, R)),
        ("group_ids", group_ids, (torch.int32,), (N, S)),
        ("group_counts", group_counts, (torch.int32,), (N, S)),
        ("cap", cap, tuple(_CAP_KIND), (G, N)),
        ("candidates", candidates, (torch.int32,), (C,)),
    ):
        _check(name, t, dtypes, shape, dev)
    ok = torch.empty(C, dtype=torch.bool, device=dev)
    if C == 0:
        return ok
    # int64 words: the sums of the table's tiles of _TABLE_TILE nodes, each
    # group's rows with room [G, N], their count [G] and the group's total
    # fit [G], then the fit [G, N] of int32
    tiles = -(-N // _TABLE_TILE)
    work = torch.empty(G * (tiles + N + 2) + -(-G * N // 2), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repack_launch(
            C, N, R, S, G,
            free.data_ptr(), requests.data_ptr(), group_ids.data_ptr(),
            group_counts.data_ptr(), cap.data_ptr(), _CAP_KIND[cap.dtype],
            candidates.data_ptr(), ok.data_ptr(), work.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"repack kernel launch failed: {lib.repack_error_string(err).decode()} ({err})"
        )
    LAUNCHES += 1
    return ok
