"""The consolidation repack screen as one CUDA kernel launch (``csrc/repack.cu``).

The counterpart of the JAX package's ``ops/repack_pallas.py``: every
candidate's repack proof in one launch, each block holding its candidate's
private free matrix in shared memory (or, past the budget, in a global
scratch). ``repack_check`` takes the same arguments as the plain
``ops.consolidate.repack_check`` and returns the same ``ok[C]``. Tensors on
the CPU go through the plain version; tensors on a CUDA device launch the
kernel, or raise. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: kernel launches since the last reset (a run sets it to 0 and reads it)
LAUNCHES = 0

_MAX_R = 16
_THREADS = 1024
#: nodes per pass of the kernel's node loop (``kThreads * kPer``); a larger
#: cluster carries the placements' prefix from pass to pass
TILE_NODES = _THREADS * 8
#: shared memory one block may use on Hopper (dynamic + static)
SMEM_LIMIT_BYTES = 232_448
#: shared memory the kernel's static scratch may take (``kStaticReserve``)
_STATIC_SMEM_BYTES = 512
_CAP_KIND = {torch.bool: 0, torch.uint16: 1, torch.float32: 2}


def repack_smem_bytes(n_nodes: int, n_res: int) -> int:
    """Shared memory a block needs to hold a candidate's private free
    matrix plus the kernel's static scratch (the counterpart of the TPU's
    ``repack_vmem_bytes``). Past ``SMEM_LIMIT_BYTES`` the kernel runs on a
    global scratch instead."""
    return n_nodes * n_res * 4 + _STATIC_SMEM_BYTES


def _lib() -> ctypes.CDLL:
    lib = _build.load("repack")
    lib.repack_launch.restype = ctypes.c_int
    lib.repack_launch.argtypes = (
        [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    )
    lib.repack_error_string.restype = ctypes.c_char_p
    lib.repack_error_string.argtypes = [ctypes.c_int]
    return lib


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
    """ok[C] (bool): the kernel for CUDA tensors, the plain version for CPU
    tensors (``chunk`` sizes the plain version's candidate batches; the
    kernel takes every candidate in one launch)."""
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = min(C, 2 * sms)
    scratch = None
    if repack_smem_bytes(N, R) > SMEM_LIMIT_BYTES:
        scratch = torch.empty((grid, N, R), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repack_launch(
            grid, C, N, R, S, G,
            free.data_ptr(), requests.data_ptr(), group_ids.data_ptr(),
            group_counts.data_ptr(), cap.data_ptr(), _CAP_KIND[cap.dtype],
            candidates.data_ptr(), ok.data_ptr(),
            scratch.data_ptr() if scratch is not None else None, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"repack kernel launch failed: {lib.repack_error_string(err).decode()} ({err})"
        )
    LAUNCHES += 1
    return ok
