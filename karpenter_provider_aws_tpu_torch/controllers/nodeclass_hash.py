"""NodeClass hash controller: stamp static-drift hash annotations.

Parity: ``pkg/controllers/nodeclass/hash/controller.go:47-120`` — stamp the
spec hash + hash-version on the class; on a hash-version bump, migrate
existing NodeClaims' stamped hashes so they are not falsely drift-flagged.
"""

from __future__ import annotations

from ..models import labels as lbl
from ..state.cluster import Cluster


class NodeClassHashController:
    name = "nodeclass-hash"
    interval_s = 10.0

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self) -> None:
        from ..operator import sharding

        if not sharding.owns_global():
            return  # global scope: one hash writer for the shared store
        for nc in list(self.cluster.nodeclasses.values()):
            if nc.deleted:
                continue
            prev_version = nc.status.conditions.get("hash-version")
            if prev_version is not None and prev_version.reason != lbl.NODECLASS_HASH_VERSION:
                # Hash-version bump: re-stamp claims with the new-version hash
                # instead of flagging them all drifted (controller.go:83-120).
                for claim in self.cluster.claims_for_nodeclass(nc.name):
                    claim.annotations[lbl.ANNOTATION_NODECLASS_HASH] = nc.hash()
                    claim.annotations[lbl.ANNOTATION_NODECLASS_HASH_VERSION] = (
                        lbl.NODECLASS_HASH_VERSION
                    )
            nc.status.set_condition("hash-version", True, reason=lbl.NODECLASS_HASH_VERSION)
            nc.status.set_condition("hash", True, reason=nc.hash())
