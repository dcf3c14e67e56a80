"""Device-resident cluster state: the screen's tensors on the card, patched
row by row.

The counterpart of the JAX package's ``ops/device_state.py``. The incremental
encoder (``ops/encode_delta.py``) re-emits ``ClusterTensors`` cheaply, but a
screen that uploads its inputs per ``ct`` still moves the whole free matrix,
slot tables and cap across the link every pass, even when one pod moved.
This module keeps ONE persistent mirror of the screen's inputs per
incremental-encoder chain and device:

 - the first pass uploads the ladder-padded buffers once (node axis on the
   ``{2^k, 1.5*2^k}`` ladder, group and slot axes on power-of-two buckets,
   ratcheted by ``consolidate._screen_bucket_hw``), so node adds have
   headroom without a re-upload;
 - each journal delta is an in-place ``index_copy_`` on the resident tensors
   of exactly the rows the incremental encoder patched (``_patch_positions``
   on the emitted ``ClusterTensors``, chained across passes the screen
   skipped): rows of ``free``, ``gids`` and ``gcounts``, columns of ``cap``.
   Exactly the real rows are written: there is no padding of the row list
   and no out-of-range sentinel (a torch index out of range raises);
 - a membership change, a broken or too-deep patch chain, or axis growth
   re-uploads; ``KARPENTER_TPU_DEVICE_STATE=0`` switches the layer off (the
   screen then uploads per ``ct``);
 - the partitioned encoder (``ops/encode_partition.py``) gives each
   (nodepool, zone) partition its own chain and the merged tensors another,
   so each partition has its own mirror, keyed apart from the merged one's:
   a partition that loses its mirror uploads again alone, and the others
   are patched.

Exactness contract: the mirror holds the same values a fresh upload of the
``ct`` would. ``verify_mirror`` fetches the buffers and compares them
exactly; the tests and ``chip_smoke.py`` call it. Nothing here catches an
error: a failed upload or patch raises to the screen's caller.
``"fallback"`` means only that the layer is off or the ``ct`` has no
encoder chain.

Outcomes (hit / patch / upload / fallback), patched rows and the bytes each
upload and patch moved are counted in ``COUNTS``.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from .encode import _ladder_bucket

_UNCAPPED = 1 << 30
#: wire cap for hostname headroom (shared with consolidate.screen_cap_wire)
_CAP_WIRE_MAX = 60000
#: patch chains longer than this re-upload instead (row sets would approach
#: the full buffer anyway, and each link is one dict walk per pass)
MAX_CHAIN_DEPTH = 16
#: mirrors kept, least recently used dropped first (one per encoder chain
#: and device)
MAX_HOLDERS = 32

#: acquires by outcome, patched rows, and bytes moved host-to-device by
#: uploads and patches, since the last ``reset_counts``; each also counts on
#: the reference's metric series (``_count``), which never reset
COUNTS: dict = {"hit": 0, "patch": 0, "upload": 0, "fallback": 0,
                "patch_rows": 0, "upload_bytes": 0, "patch_bytes": 0}


def _count(key: str, n: int = 1) -> None:
    """Add ``n`` to ``COUNTS[key]`` and to its series:
    ``karpenter_device_state_total{path="screen", outcome}``,
    ``karpenter_device_state_patch_rows_total`` or
    ``karpenter_device_state_bytes_total{kind}``."""
    from ..metrics import DEVICE_STATE, DEVICE_STATE_BYTES, DEVICE_STATE_PATCH_ROWS

    COUNTS[key] += n
    if key == "patch_rows":
        DEVICE_STATE_PATCH_ROWS.inc(n)
    elif key.endswith("_bytes"):
        DEVICE_STATE_BYTES.inc(n, kind=key[:-len("_bytes")])
    else:
        DEVICE_STATE.inc(n, path="screen", outcome=key)


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def enabled() -> bool:
    return os.environ.get("KARPENTER_TPU_DEVICE_STATE", "1") == "1"


def _pow2(n: int, minimum: int = 1) -> int:
    w = minimum
    while w < n:
        w *= 2
    return w


# -- the per-chain mirror ----------------------------------------------------

class DeviceClusterTensors:
    """Mutable holder of the resident screen tensors for ONE incremental-
    encoder chain on one device. Callers re-read ``arrays()`` per pass; the
    patches update the tensors in place."""

    def __init__(self, chain, device: torch.device):
        self.chain = chain          # strong ref: pins the id() key
        self.device = device
        self.lock = threading.RLock()
        self.base_ct = None         # host ClusterTensors this mirrors
        self.free = None            # [NB, R]  float32
        self.gids = None            # [NB, S]  int32
        self.gcounts = None         # [NB, S]  int32
        self.cap = None             # [GB, NB] float32 (wire values)
        self.requests = None        # [GB, R]  float32
        self.candidates = None      # [n_live] int32: every live row
        self.NB = 0
        self.GB = 0
        self.S = 0
        self.n_live = 0
        self.G = 0

    def arrays(self) -> Optional[tuple]:
        """(free, requests, gids, gcounts, cap, candidates, n_live), or None
        before the first upload."""
        with self.lock:
            bufs = (self.free, self.requests, self.gids, self.gcounts,
                    self.cap, self.candidates)
            if any(b is None for b in bufs):
                return None
            return bufs + (self.n_live,)


_HOLDERS: "OrderedDict[tuple, DeviceClusterTensors]" = OrderedDict()
_HOLDERS_LOCK = threading.Lock()


def _key(chain, device: torch.device) -> tuple:
    return (id(chain), str(device))


def _holder_for(chain, device: torch.device) -> DeviceClusterTensors:
    with _HOLDERS_LOCK:
        key = _key(chain, device)
        h = _HOLDERS.get(key)
        if h is not None and h.chain is chain:
            _HOLDERS.move_to_end(key)
            return h
        h = DeviceClusterTensors(chain, device)
        _HOLDERS[key] = h
        while len(_HOLDERS) > MAX_HOLDERS:
            _HOLDERS.popitem(last=False)
        return h


def reset_device_state() -> None:
    """Drop every device mirror (tests)."""
    with _HOLDERS_LOCK:
        _HOLDERS.clear()


# -- host-side tensor prep ---------------------------------------------------

def _cap_wire_f32(ct, cols: Optional[np.ndarray] = None) -> np.ndarray:
    """The screen capability matrix in device form: float32, _UNCAPPED for
    uncapped-compatible, 0 for incompatible, hostname headroom (at most
    60,000) otherwise — value-identical to the screen's uint16/bool wire
    (integers <= 60000 and 2^30 are exact in float32)."""
    src = ct.cap if ct.cap is not None else ct.compat
    if cols is not None:
        src = src[:, cols]
    if src.dtype == bool:
        return np.where(src, np.float32(_UNCAPPED), np.float32(0.0))
    return np.minimum(src, _CAP_WIRE_MAX).astype(np.float32)


def _collect_patch_positions(ct, base) -> Optional[np.ndarray]:
    """Walk the ``_patch_base`` chain from ``ct`` back to ``base``; returns
    the merged dirty positions (sorted, deduped) or None when no bounded
    chain connects them (membership changed / chain broken / too deep)."""
    chunks: list[np.ndarray] = []
    cur = ct
    for _ in range(MAX_CHAIN_DEPTH):
        if cur is base:
            if not chunks:
                return np.zeros(0, dtype=np.int32)
            return np.unique(np.concatenate(chunks)).astype(np.int32)
        nxt = cur.__dict__.get("_patch_base")
        pos = cur.__dict__.get("_patch_positions")
        if nxt is None or pos is None:
            return None
        chunks.append(pos)
        cur = nxt
    return None


def _to(dev: torch.device, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# -- acquire -----------------------------------------------------------------

def acquire_screen_tensors(ct, device):
    """The resident (free, requests, gids, gcounts, cap, candidates, n_live)
    for the repack screen of ``ct`` on ``device``, and the residency:
    ``"resident"`` (hit or patch) or ``"upload"``; ``(None, "fallback")``
    only when the layer is off or ``ct`` has no encoder chain. Any error in
    the upload or the patch raises."""
    if not enabled():
        _count("fallback")
        return None, "fallback"
    chain = ct.__dict__.get("_device_chain")
    if chain is None:
        # full-encode tensors (no persistent encoder): nothing to key a
        # persistent mirror on — the screen uploads this ct's inputs
        _count("fallback")
        return None, "fallback"
    holder = _holder_for(chain, torch.device(device))
    with holder.lock:
        return _acquire_locked(holder, ct)


def _acquire_locked(holder: DeviceClusterTensors, ct):
    from .consolidate import live_slot_width

    N = len(ct.node_names)
    G = ct.requests.shape[0]
    W = live_slot_width(ct.group_counts)
    bufs = holder.arrays()

    if bufs is not None and holder.base_ct is ct:
        _count("hit")
        return bufs, "resident"

    if (
        bufs is not None
        and holder.base_ct is not None
        and N == holder.n_live
        and G == holder.G
        and W <= holder.S
        # the fast-patch emission shares the group-axis arrays outright;
        # identity is the cheap witness that G-axis content is unchanged
        and ct.requests is holder.base_ct.requests
    ):
        rows = _collect_patch_positions(ct, holder.base_ct)
        if rows is not None:
            _apply_patch(holder, ct, rows)
            _count("patch")
            _count("patch_rows", len(rows))
            return holder.arrays(), "resident"

    _upload(holder, ct, N, G, W)
    _count("upload")
    return holder.arrays(), "upload"


def screen_buckets(N: int, G: int, W: int, ratchet=None) -> tuple[int, int, int]:
    """(NB, GB, S): the node axis on the ladder, the group and slot axes on
    powers of two from 8. ``ratchet`` (``consolidate._screen_bucket_hw``)
    keeps each axis at its high-water mark, bounded at 4x the need."""
    hw = ratchet or (lambda _kind, v: v)
    return (hw("NB", _ladder_bucket(N)), hw("GB", _pow2(G, minimum=8)),
            hw("S", _pow2(W, minimum=8)))


def padded_screen_arrays(ct, NB: int, GB: int, S: int) -> dict:
    """The screen's inputs for ``ct`` as the mirror holds them, host side:
    free [NB, R], requests [GB, R], gids and gcounts [NB, S], the float32
    cap [GB, NB] and the candidates (the live rows). Rows past the live
    ``N`` hold zero free and zero cap, groups past ``G`` zero requests,
    slots past the source's width count 0."""
    N = len(ct.node_names)
    G = ct.requests.shape[0]
    R = ct.free.shape[1]
    w = min(S, ct.group_ids.shape[1])
    free_h = np.zeros((NB, R), dtype=np.float32)
    free_h[:N] = ct.free
    gids_h = np.zeros((NB, S), dtype=np.int32)
    gids_h[:N, :w] = ct.group_ids[:, :w]
    gcounts_h = np.zeros((NB, S), dtype=np.int32)
    gcounts_h[:N, :w] = ct.group_counts[:, :w]
    req_h = np.zeros((GB, R), dtype=np.float32)
    req_h[:G] = ct.requests
    cap_h = np.zeros((GB, NB), dtype=np.float32)
    cap_h[:G, :N] = _cap_wire_f32(ct)
    return {"free": free_h, "requests": req_h, "group_ids": gids_h,
            "group_counts": gcounts_h, "cap": cap_h,
            "candidates": np.arange(N, dtype=np.int32)}


def _upload(holder: DeviceClusterTensors, ct, N: int, G: int, W: int) -> None:
    from .consolidate import _screen_bucket_hw

    # the process-wide ratchet, the same shape policy as the reference's
    # mirror; the slot bucket may exceed the source's own slot axis
    NB, GB, S = screen_buckets(N, G, W, ratchet=_screen_bucket_hw)
    h = padded_screen_arrays(ct, NB, GB, S)
    dev = holder.device
    holder.free = _to(dev, h["free"])
    holder.gids = _to(dev, h["group_ids"])
    holder.gcounts = _to(dev, h["group_counts"])
    holder.requests = _to(dev, h["requests"])
    holder.cap = _to(dev, h["cap"])
    # the candidates (every live row) are made on the device: no bytes move
    holder.candidates = torch.arange(N, dtype=torch.int32, device=dev)
    holder.NB, holder.GB, holder.S = NB, GB, S
    holder.n_live, holder.G = N, G
    holder.base_ct = ct
    _count("upload_bytes", sum(h[k].nbytes for k in (
        "free", "group_ids", "group_counts", "requests", "cap")))


def _apply_patch(holder: DeviceClusterTensors, ct, rows: np.ndarray) -> None:
    """Write exactly ``rows`` of ``ct`` into the resident tensors, in place:
    rows of free, gids and gcounts and columns of cap. ``rows`` may be
    empty — a patch that moved only group pod lists — and the buffers are
    then already exact."""
    if not len(rows):
        holder.base_ct = ct
        return
    dev = holder.device
    k = len(rows)
    S, GB = holder.S, holder.GB
    w = min(S, ct.group_ids.shape[1])
    free_v = np.ascontiguousarray(ct.free[rows], dtype=np.float32)
    gids_v = np.zeros((k, S), dtype=np.int32)
    gids_v[:, :w] = ct.group_ids[rows, :w]
    gcounts_v = np.zeros((k, S), dtype=np.int32)
    gcounts_v[:, :w] = ct.group_counts[rows, :w]
    cap_v = np.zeros((GB, k), dtype=np.float32)
    cap_v[: holder.G] = _cap_wire_f32(ct, cols=rows)
    idx_h = np.asarray(rows, dtype=np.int64)

    idx = _to(dev, idx_h)
    holder.free.index_copy_(0, idx, _to(dev, free_v))
    holder.gids.index_copy_(0, idx, _to(dev, gids_v))
    holder.gcounts.index_copy_(0, idx, _to(dev, gcounts_v))
    holder.cap.index_copy_(1, idx, _to(dev, cap_v))
    holder.base_ct = ct
    _count("patch_bytes", idx_h.nbytes + free_v.nbytes + gids_v.nbytes
           + gcounts_v.nbytes + cap_v.nbytes)


# -- exactness witness -------------------------------------------------------

def verify_mirror(holder: DeviceClusterTensors, ct) -> list[str]:
    """Fetch the resident buffers and compare them EXACTLY against what a
    fresh upload of ``ct`` would contain. Returns the differing field names
    (empty = mirror exact)."""
    bufs = holder.arrays()
    if bufs is None:
        return ["<no-mirror>"]
    free_d, req_d, gids_d, gcounts_d, cap_d, cand_d, n_live = bufs
    N = len(ct.node_names)
    G = ct.requests.shape[0]
    if n_live != N:
        return ["n_live"]
    free, req, gids, gcounts, cap, cand = (
        t.cpu().numpy() for t in (free_d, req_d, gids_d, gcounts_d, cap_d, cand_d)
    )
    S = holder.S
    w = min(S, ct.group_ids.shape[1])
    bad = []
    if not np.array_equal(free[:N], ct.free):
        bad.append("free")
    if not np.array_equal(req[:G], ct.requests) or req[G:].any():
        bad.append("requests")
    # the slot bucket may be wider than the source slot axis; the surplus
    # columns must then be all-zero (inert slots)
    if not np.array_equal(gids[:N, :w], ct.group_ids[:, :w]) or gids[:N, w:].any():
        bad.append("group_ids")
    if (
        not np.array_equal(gcounts[:N, :w], ct.group_counts[:, :w])
        or gcounts[:N, w:].any()
    ):
        bad.append("group_counts")
    if not np.array_equal(cap[:G, :N], _cap_wire_f32(ct)):
        bad.append("cap")
    if not np.array_equal(cand, np.arange(N, dtype=np.int32)):
        bad.append("candidates")
    # padding must stay inert: zero free/cap rows can never absorb pods
    if N < holder.NB and (
        free[N:].any() or cap[:, N:].any() or gcounts[N:].any()
    ):
        bad.append("padding")
    return bad


def mirror_for(ct, device=None) -> Optional[DeviceClusterTensors]:
    """The holder mirroring ``ct``'s encoder chain on ``device`` (None: the
    one used last, on any device), or None when no mirror exists."""
    chain = ct.__dict__.get("_device_chain")
    if chain is None:
        return None
    with _HOLDERS_LOCK:
        if device is not None:
            h = _HOLDERS.get(_key(chain, torch.device(device)))
            return h if h is not None and h.chain is chain else None
        for h in reversed(_HOLDERS.values()):
            if h.chain is chain:
                return h
        return None


def note_hit(ct, device) -> bool:
    """True (and one ``hit`` count) when a mirror on ``device`` is current
    for ``ct`` — the screen's mask memo answered the pass from resident
    state without dispatching."""
    if not enabled():
        return False
    h = mirror_for(ct, device)
    if h is None or h.base_ct is not ct or h.arrays() is None:
        return False
    _count("hit")
    return True


def drop_mirror(ct) -> bool:
    """Tear down every device mirror behind ``ct``'s chain; the next acquire
    re-uploads."""
    chain = ct.__dict__.get("_device_chain")
    if chain is None:
        return False
    with _HOLDERS_LOCK:
        keys = [k for k, h in _HOLDERS.items() if h.chain is chain]
        for k in keys:
            del _HOLDERS[k]
        return bool(keys)
