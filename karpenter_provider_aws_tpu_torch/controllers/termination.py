"""NodeClaim termination controller: finalizer-gated drain + terminate.

Owns what the reference consumes from the core termination controller
(SURVEY.md section 2.2 lifecycle): when a claim is deleted — by disruption,
interruption, or the user — cordon its node, evict its pods so they
re-enter the scheduling pipeline, terminate the cloud instance, then remove
the node and the finalizer.

Eviction goes through PodDisruptionBudget accounting (the core drains via
the eviction API, which enforces PDBs): a pod whose eviction would push a
covered workload below its budget stays bound, the claim keeps its
finalizer, and the drain retries next pass — by then replacements evicted
earlier have typically rescheduled and gone Running elsewhere, freeing more
budget (a rolling drain).
"""

from __future__ import annotations

from ..cloudprovider.cloudprovider import CloudProvider
from ..state.cluster import Cluster
from ..utils import errors


class TerminationController:
    name = "termination"
    interval_s = 2.0

    def __init__(self, cluster: Cluster, cloudprovider: CloudProvider, clock=None):
        from ..utils.clock import RealClock

        self.cluster = cluster
        self.cloudprovider = cloudprovider
        self.clock = clock or RealClock()

    def _past_grace(self, claim) -> bool:
        """terminationGracePeriod (core): once a claim has been Deleting
        longer than its grace period, the drain force-completes — PDBs and
        do-not-disrupt stop holding the node. The period was snapshotted
        onto the claim at launch (a pool edit/delete mid-drain must not
        move or disable the deadline); pre-snapshot claims fall back to
        the live pool."""
        grace = claim.termination_grace_period_s
        if grace is None:
            pool = self.cluster.nodepools.get(claim.nodepool_name)
            grace = pool.termination_grace_period_s if pool is not None else None
        if grace is None:
            return False
        return self.clock.now() - claim.deleted_at >= grace

    def _evict(self, node, force: bool = False) -> bool:
        """Evict what the PDBs allow; True when the node is fully drained.
        Budget headroom is computed once per pass and decremented per
        eviction, so one pass can never overshoot a budget even when
        several of its pods share the node."""
        # the incrementally-maintained bound-pod index: O(pods on THIS
        # node). The full-store scan (pods_on_node) made termination the
        # dominant controller of a consolidating 10k-node fleet — an
        # O(draining claims x all pods) pass the fleet simulator's
        # attribution profile flagged. Drains only ever follow sanctioned
        # binds, which is exactly what the index sees.
        pods = self.cluster.pods_on_nodes([node.name]).get(node.name, [])
        if not pods:
            return True
        pdbs = list(self.cluster.pdbs.values())
        # the full-store pod list exists only to compute PDB headroom —
        # don't pay the O(pods) materialization per drained node when no
        # budgets are declared
        all_pods = list(self.cluster.pods.values()) if pdbs else []
        headroom = {p.name: p.disruptions_allowed(all_pods) for p in pdbs}
        drained = True
        for pod in pods:
            if not force and pod.do_not_disrupt():
                # do-not-disrupt holds the drain too (interruption/user
                # deletes bypass the disruption controller's filter), until
                # the grace deadline force-completes it
                drained = False
                continue
            covering = [] if force else [p for p in pdbs if p.matches(pod)]
            if any(headroom[p.name] <= 0 for p in covering):
                drained = False  # blocked by a budget; retry next pass
                continue
            for p in covering:
                headroom[p.name] -= 1
            # through the store so the change journal sees the unbind (the
            # incremental encoders patch from it)
            self.cluster.unbind_pod(pod.uid)
        return drained

    def reconcile(self) -> None:
        from ..operator import sharding

        for claim in self.cluster.snapshot_claims():
            if not claim.deleted:
                continue
            if not sharding.owns_claim(self.cluster, claim):
                continue  # the partition's owner drains + terminates
            node = self.cluster.nodes.get(claim.status.node_name)
            if node is not None:
                node.cordoned = True
                if not self._evict(node, force=self._past_grace(claim)):
                    continue  # drain incomplete: keep claim + instance
            if claim.status.provider_id:
                try:
                    self.cloudprovider.delete(claim)
                except Exception as e:
                    if errors.is_stale_fence(e):
                        # deposed mid-pass: the partition's new owner
                        # carries this drain forward — stand down quietly
                        continue
                    if not errors.is_not_found(e):
                        raise
            if node is not None:
                self.cluster.delete(node)
            self.cluster.finalize(claim)
            from ..metrics import NODES_TERMINATED

            NODES_TERMINATED.inc(nodepool=claim.nodepool_name)
