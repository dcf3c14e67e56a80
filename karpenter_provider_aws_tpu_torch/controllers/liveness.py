"""Liveness controller: reap NodeClaims that never become nodes.

Parity: the core NodeClaim liveness controller (SURVEY.md section 2.2
"NodePool/NodeClaim lifecycle ... registration, liveness, termination") —
a claim whose instance launched but whose node never registered within the
registration TTL (15 minutes upstream) is deleted, terminating the instance
and returning its pods to the provisioner. Without this, a node that boots
into a broken kubelet/CNI pins its capacity (and its nominated pods)
forever.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..state.cluster import Cluster
from ..utils.clock import Clock, RealClock

log = logging.getLogger("karpenter.tpu.liveness")

REGISTRATION_TTL_S = 15 * 60.0  # upstream registration TTL


class LivenessController:
    name = "liveness"
    interval_s = 30.0

    def __init__(self, cluster: Cluster, clock: Optional[Clock] = None,
                 ttl_s: float = REGISTRATION_TTL_S, recorder=None, obs=None):
        from ..events import default_recorder

        self.cluster = cluster
        self.clock = clock or RealClock()
        self.ttl_s = ttl_s
        self.recorder = recorder or default_recorder()
        # obs bundle: this loop doubles as the SLO engine's heartbeat
        # (budget gauges, fast-burn events, idle event-recorder sweep)
        self.obs = obs
        self.reaped: list[str] = []
        # dirty-set walk state (change-journal pattern, like the
        # encoders): claim names that might still need liveness reaping —
        # anything not yet registered. The launch path re-applies a claim
        # when its provider id lands, so every state flip this controller
        # cares about is journaled.
        self._watch: dict[str, None] = {}
        self._cursor = None

    def _watched_claims(self) -> list:
        """Claims a pass must condition-check, fed by the change journal
        instead of an O(claims) walk per pass: a claim leaves the watch
        set once registered (or gone) and re-enters whenever the store
        journals it. The simulator's attribution profile named this
        per-claim tail; the registration controller uses the same
        pattern (the PR's pattern-setter pair)."""
        cluster = self.cluster
        epoch = getattr(cluster, "epoch", None)
        rev = getattr(cluster, "rev", None)
        if epoch is None or rev is None:
            return list(cluster.snapshot_claims())
        changes = None
        if self._cursor is not None and self._cursor[0] is epoch:
            changes = cluster.changes_since(self._cursor[1])
        if changes is None:
            self._watch = {
                c.name: None
                for c in cluster.snapshot_claims()
                if not c.is_registered()
            }
        else:
            for name in changes.get("claim", ()):
                self._watch[name] = None
        self._cursor = (epoch, rev)
        out = []
        for name in list(self._watch):
            claim = cluster.nodeclaims.get(name)
            if claim is None or claim.is_registered():
                del self._watch[name]
                continue
            out.append(claim)
        return out

    def _obs(self):
        if self.obs is None:
            from ..obs import default_obs

            self.obs = default_obs()
        return self.obs

    def reconcile(self) -> None:
        from ..operator import sharding

        now = self.clock.now()
        obs = self._obs()
        for claim in self._watched_claims():
            if claim.deleted or claim.is_registered():
                continue
            if not claim.is_launched():
                continue  # launch path owns pre-launch failures
            if now - claim.created_at < self.ttl_s:
                continue
            if not sharding.owns_claim(self.cluster, claim):
                continue  # the partition's owner reaps
            log.warning(
                "claim %s launched but never registered within %.0fs; reaping",
                claim.name, self.ttl_s,
            )
            from ..events import WARNING

            self.recorder.publish(
                "NodeClaim", claim.name, "FailedRegistration",
                f"instance never joined within {self.ttl_s:.0f}s; terminating",
                type=WARNING,
            )
            self.reaped.append(claim.name)
            # a reap is an SLO miss (the claim never became a node) and a
            # decision the audit plane retains
            obs.sli.claim_reaped(claim.name, now=now)
            obs.audit.record(
                "lifecycle", "NodeClaim", claim.name, "reap:registration",
                {"ttl_s": self.ttl_s, "age_s": round(now - claim.created_at, 1)},
                at=now, rev=getattr(self.cluster, "rev", None),
            )
            # termination controller drains (no-op: no node) + terminates
            self.cluster.delete(claim)
        # the judgment pass: SLO evaluation (budget gauges + fast-burn
        # Warning events) and idle housekeeping ride the liveness cadence
        obs.tick(now=now)
