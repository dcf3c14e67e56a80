"""NodeClass termination controller: finalizer-gated teardown.

Parity: ``pkg/controllers/nodeclass/termination/controller.go:68-129`` —
block until no NodeClaims reference the class, then delete the managed
instance profile and every managed launch template, and remove the
finalizer.
"""

from __future__ import annotations

from ..cloudprovider.cloudprovider import CloudProvider
from ..state.cluster import Cluster


class NodeClassTerminationController:
    name = "nodeclass-termination"
    interval_s = 5.0

    def __init__(self, cluster: Cluster, cloudprovider: CloudProvider):
        self.cluster = cluster
        self.cloudprovider = cloudprovider

    def reconcile(self) -> None:
        from ..operator import sharding

        if not sharding.owns_global():
            return  # global scope, like nodeclass-status
        for nc in list(self.cluster.nodeclasses.values()):
            if not nc.deleted:
                continue
            if self.cluster.claims_for_nodeclass(nc.name):
                continue  # blocked until claims drain (controller.go:80-86)
            self.cloudprovider.instance_profiles.delete(nc)
            self.cloudprovider.launch_templates.delete_all(nc)
            self.cluster.finalize(nc)
