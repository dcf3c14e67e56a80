"""Per-node agent (DaemonSet) overhead registry.

Every real node runs per-node agents — log shippers, CNI, monitoring —
that consume capacity before the first workload pod lands. Taking a
node's allocatable at face value therefore over-binds exactly at the
margin (a fleet of 1-slot-margin nodes binds one pod too many per node).

The registry holds ONE process-wide reservation vector that every encode
path subtracts from per-node capacity:

- ``ops/consolidate._encode_cluster`` and ``ops/encode_delta._fill_row``
  subtract it from each live node's allocatable (both read the same
  registration, so the incremental/full exactness contract holds);
- ``ops/encode.encode_problem`` subtracts it from every candidate
  instance type's effective capacity (fresh nodes pay the agents too);
- ``scheduling/solver.snapshot_existing_capacity`` subtracts it from
  every existing node offered to the provisioning solve.

An empty registration (the default) is byte-identical to the pre-overhead
encoders. ``seq()`` bumps on every ``set_node_overhead`` call so encoded-
problem caches and the persistent incremental encoder state invalidate
instead of serving pre-registration tensors.
"""

from __future__ import annotations

import threading
from typing import Mapping, Optional

import numpy as np

_LOCK = threading.Lock()
_OVERHEAD: Optional[np.ndarray] = None  # [R] float32, or None = no agents
_SEQ = 0


def set_node_overhead(requests: Optional[Mapping[str, object]]) -> None:
    """Install (or clear, with ``None``/empty) the per-node agent
    reservation, e.g. ``{"cpu": "200m", "memory": "512Mi"}``. The vector
    never reserves pod SLOTS — agents are invisible to the pods column
    (kubelet reports allocatable pods net of static agents already)."""
    global _OVERHEAD, _SEQ
    from ..models.resources import PODS, ResourceVector

    vec = None
    if requests:
        v = ResourceVector.from_map(requests).v.astype(np.float32).copy()
        v[PODS] = 0.0
        if float(v.sum()) > 0.0:
            vec = v
    with _LOCK:
        _OVERHEAD = vec
        _SEQ += 1


def node_overhead() -> Optional[np.ndarray]:
    """The registered [R] reservation vector, or None. Callers must not
    mutate the returned array."""
    return _OVERHEAD


def seq() -> int:
    """Registration sequence number (cache-key ingredient)."""
    return _SEQ


def apply(capacity: np.ndarray) -> np.ndarray:
    """``capacity - overhead`` clipped at zero (last-axis = resources);
    returns ``capacity`` itself when nothing is registered."""
    ov = _OVERHEAD
    if ov is None:
        return capacity
    return np.maximum(capacity - ov, 0.0).astype(capacity.dtype, copy=False)
