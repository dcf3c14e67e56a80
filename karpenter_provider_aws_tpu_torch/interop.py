"""Build this package's solve and screen inputs from the JAX package's plain
numpy fields.

Tests feed both packages the very same tensors through these functions; they
take numpy arrays only, so this package never imports the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .ops.consolidate import ClusterTensors, ZoneConstraint
from .ops.encode import EncodedProblem
from .ops.ffd import _State, pack_window_bits

#: the numpy fields of ``EncodedProblem``, in both packages
ARRAY_FIELDS = (
    "requests", "counts", "compat", "capacity", "price", "group_window",
    "type_window", "group_zone_allowed", "group_captype_allowed",
    "max_per_node", "atomic", "type_exotic",
)


def problem_from_reference(
    arrays: Mapping[str, np.ndarray],
    group_pods: Sequence[list] = (),
    type_names: Sequence[str] = (),
    zones: Sequence[str] = (),
    nodepool=None,
) -> EncodedProblem:
    """This package's ``EncodedProblem`` from the JAX package's array fields
    (``ARRAY_FIELDS``, each copied)."""
    missing = [f for f in ARRAY_FIELDS if f not in arrays]
    if missing:
        raise KeyError(f"missing problem fields: {missing}")
    fields = {
        f: None if arrays[f] is None else np.array(arrays[f], copy=True)
        for f in ARRAY_FIELDS
    }
    return EncodedProblem(
        group_pods=[list(p) for p in group_pods],
        type_names=tuple(type_names),
        zones=tuple(zones),
        nodepool=nodepool,
        **fields,
    )


def state_from_reference(
    node_type: np.ndarray,     # [N] int
    node_price: np.ndarray,    # [N] float
    used: np.ndarray,          # [N, R] float
    node_cap: np.ndarray,      # [N, R] float
    node_window: np.ndarray,   # [N, Z, C] bool
    n_open: int,
    device="cpu",
) -> _State:
    """An ``ops.ffd._State`` of pre-opened rows from the JAX package's
    ``_State`` fields; the window becomes this package's bitmask."""
    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype), device=device)

    return _State(
        node_type=t(node_type, np.int32),
        node_price=t(node_price, np.float32),
        used=t(used, np.float32),
        node_cap=t(node_cap, np.float32),
        node_window=t(pack_window_bits(node_window), np.int32),
        n_open=torch.tensor(int(n_open), dtype=torch.int32, device=device),
    )


#: the numpy fields of ``ClusterTensors``, in both packages
CLUSTER_ARRAY_FIELDS = (
    "free", "price", "requests", "group_ids", "group_counts", "compat",
    "disruption_cost", "blocked", "used_total", "group_node_count", "mpn",
    "hn_match", "cap", "node_zone_idx", "node_gang",
)
#: the list fields of ``ClusterTensors`` (plain strings), in both packages
CLUSTER_LIST_FIELDS = ("node_names", "nodepool_names", "node_zone", "zones", "node_captype")


def cluster_tensors_from_reference(fields: Mapping[str, object]) -> ClusterTensors:
    """This package's ``ClusterTensors`` from the JAX package's fields: the
    arrays of ``CLUSTER_ARRAY_FIELDS`` (each copied), the string lists of
    ``CLUSTER_LIST_FIELDS``, and ``zone_constraints`` as one list per group
    of ``(kind, skew, match, selector)`` tuples. ``group_pods`` stays empty:
    the screen and the validator never read it."""
    missing = [f for f in CLUSTER_ARRAY_FIELDS + CLUSTER_LIST_FIELDS + ("zone_constraints",)
               if f not in fields]
    if missing:
        raise KeyError(f"missing cluster fields: {missing}")
    arrays = {f: np.array(fields[f], copy=True) for f in CLUSTER_ARRAY_FIELDS}
    lists = {f: list(fields[f]) for f in CLUSTER_LIST_FIELDS}
    zone_constraints = [
        [ZoneConstraint(kind=str(kind), skew=int(skew), match=np.array(match, dtype=bool),
                        selector=None if selector is None else dict(selector))
         for kind, skew, match, selector in cons]
        for cons in fields["zone_constraints"]
    ]
    return ClusterTensors(group_pods=[], zone_constraints=zone_constraints, **arrays, **lists)
