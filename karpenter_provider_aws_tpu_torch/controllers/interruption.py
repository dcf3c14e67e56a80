"""Interruption controller: queue events -> cordon & drain + ICE feedback.

Parity: ``pkg/controllers/interruption`` — drain the queue of
EventBridge-style messages; typed parsers keyed on (source, detail-type)
(parser.go:52-91); actions (controller.go:180-226):
 - spot interruption warning  -> mark spot offering unavailable + drain
 - scheduled change / health  -> drain
 - instance stopping/terminating state change -> drain
 - rebalance recommendation   -> no action (default)
Messages are deleted after handling, including unparseable ones; handling
fans out over a small worker pool (controller.go:104 ParallelizeUntil(10)).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Optional

from ..cloudprovider.cloudprovider import CloudProvider
from ..models import labels as lbl
from ..state.cluster import Cluster

log = logging.getLogger("karpenter.tpu.interruption")

PARALLELISM = 10


@dataclass(frozen=True)
class InterruptionEvent:
    kind: str               # SpotInterruption | Rebalance | ScheduledChange | StateChange | Unknown
    instance_ids: tuple[str, ...]
    action_drain: bool
    # typed recorder reason + severity (parity: the per-kind events in
    # interruption/events/events.go — SpotInterrupted,
    # SpotRebalanceRecommendation, InstanceStopping, InstanceTerminating,
    # InstanceUnhealthy); published for EVERY matched claim, drain or not
    reason: str = "Interrupted"
    severity: str = "Warning"


def _parse_spot(detail) -> InterruptionEvent:
    return InterruptionEvent(
        "SpotInterruption", (detail.get("instance-id", ""),), True,
        reason="SpotInterrupted",
    )


def _parse_rebalance(detail) -> InterruptionEvent:
    return InterruptionEvent(
        "Rebalance", (detail.get("instance-id", ""),), False,
        reason="SpotRebalanceRecommendation", severity="Normal",
    )


def _parse_state_change(detail) -> InterruptionEvent:
    state = detail.get("state", "")
    drain = state in ("stopping", "stopped", "shutting-down", "terminated")
    reason = (
        "InstanceStopping" if state in ("stopping", "stopped")
        else "InstanceTerminating" if state in ("shutting-down", "terminated")
        else "Interrupted"
    )
    return InterruptionEvent(
        "StateChange", (detail.get("instance-id", ""),), drain, reason=reason
    )


def _parse_scheduled_change(detail) -> InterruptionEvent:
    ids = tuple(
        e.get("entityValue", "") for e in detail.get("affectedEntities", [])
    ) or (detail.get("instance-id", ""),)
    return InterruptionEvent(
        "ScheduledChange", ids, True, reason="InstanceUnhealthy"
    )


# (source, detail-type) -> parser (parity: parser.go DefaultParsers)
DEFAULT_PARSERS: dict[tuple[str, str], Callable[[dict], InterruptionEvent]] = {
    ("aws.ec2", "EC2 Spot Instance Interruption Warning"): _parse_spot,
    ("aws.ec2", "EC2 Instance Rebalance Recommendation"): _parse_rebalance,
    ("aws.ec2", "EC2 Instance State-change Notification"): _parse_state_change,
    ("aws.health", "AWS Health Event"): _parse_scheduled_change,
}


def parse_message(body: dict) -> InterruptionEvent:
    parser = DEFAULT_PARSERS.get((body.get("source", ""), body.get("detail-type", "")))
    if parser is None:
        return InterruptionEvent("Unknown", (), False)
    return parser(body.get("detail", {}))


class InterruptionController:
    """Enabled only when a queue is configured (parity:
    controllers.go:67-71 gating on --interruption-queue)."""

    name = "interruption"
    interval_s = 2.0

    def __init__(self, cluster: Cluster, cloudprovider: CloudProvider, queue,
                 recorder=None, obs=None):
        from ..events import default_recorder
        from ..providers.queue import QueueProvider

        if not isinstance(queue, QueueProvider):
            # explicit raise, not assert: the seam check must survive -O
            raise TypeError(
                "queue must satisfy providers.queue.QueueProvider (the "
                "declared adapter seam; parity: sqs.go:53-73)"
            )
        self.cluster = cluster
        self.cloudprovider = cloudprovider
        self.queue = queue
        self.recorder = recorder or default_recorder()
        self.obs = obs
        self.handled: list[InterruptionEvent] = []
        # one persistent worker pool (parity: a fixed ParallelizeUntil width,
        # controller.go:104) — a pool per batch costs more than the work.
        # Only blocking providers get it: fan-out exists to overlap queue/
        # network round-trips, and for an in-memory queue the dispatch
        # overhead dominates the (GIL-bound) handler work.
        self._pool = (
            ThreadPoolExecutor(
                max_workers=PARALLELISM, thread_name_prefix="interruption"
            )
            if getattr(queue, "blocking_io", True)
            else None
        )

    def reconcile(self) -> None:
        from ..operator import sharding

        # one queue, one consumer: the interruption queue's receive/delete
        # protocol cannot be partitioned safely (a message's claim is only
        # known after receipt), so it rides the GLOBAL lease
        if not sharding.owns_global():
            return
        messages = self.queue.receive()
        if not messages:
            return
        # instance-id -> claim resolution is the cluster's incrementally
        # maintained O(1) index (parity: the per-batch map of
        # controller.go:254-292, without the re-LIST per 10-message batch)
        if self._pool is None or len(messages) == 1:
            for m in messages:
                self._handle(m)
        else:
            list(self._pool.map(self._handle, messages))

    def _handle(self, message) -> None:
        """Per-message isolation: a raising handler (recorder, cluster
        write) must not abort the rest of the ``pool.map`` batch, and the
        message is deleted REGARDLESS of handler outcome — the documented
        at-least-once semantics. Without this, one poison message aborts
        its batch undeleted and is redelivered forever."""
        try:
            event = parse_message(message.parsed())
        except Exception:
            event = InterruptionEvent("Unknown", (), False)
        from ..metrics import INTERRUPTION_MESSAGE_ERRORS, INTERRUPTION_MESSAGES

        INTERRUPTION_MESSAGES.inc(kind=event.kind)
        self.handled.append(event)
        try:
            self._act(event)
        except Exception:
            INTERRUPTION_MESSAGE_ERRORS.inc(kind=event.kind)
            log.exception(
                "interruption handler failed for %s; deleting message anyway "
                "(at-least-once)", event.kind,
            )
        finally:
            try:
                self.queue.delete(message.receipt)
            except Exception:
                # delete failure = redelivery later; that IS at-least-once
                log.exception("interruption message delete failed")

    def _act(self, event: InterruptionEvent) -> None:
        for iid in event.instance_ids:
            claim = self.cluster.claim_by_instance_id(iid)
            if claim is None:
                continue
            if event.kind == "SpotInterruption":
                # the interrupted offering is effectively dry: mask it for
                # the next solves (controller.go:197-203)
                itype = claim.labels.get(lbl.INSTANCE_TYPE_LABEL, "")
                zone = claim.labels.get(lbl.TOPOLOGY_ZONE, "")
                if itype and zone:
                    self.cloudprovider.catalog.unavailable.mark_unavailable(
                        itype, zone, lbl.CAPACITY_TYPE_SPOT, reason="SpotInterruption"
                    )
            if claim.deleted:
                # at-least-once queue redelivery of an already-handled
                # interruption: the ICE mark above refreshed its TTL; a
                # duplicate event per redelivery would just be noise
                continue
            if not event.action_drain and event.reason == "Interrupted":
                # non-actionable state change (e.g. 'running'/'pending'):
                # the reference's parser drops these outright — no event
                continue
            # typed event for every actionable kind — informational kinds
            # with their own reason (rebalance) publish too, exactly like
            # the reference
            self.recorder.publish(
                "NodeClaim", claim.name, event.reason,
                f"{event.kind} for instance {iid}"
                + (": cordon and drain" if event.action_drain else ""),
                type=event.severity,
            )
            if event.action_drain:
                log.info("interruption %s: draining %s", event.kind, claim.name)
                self._audit().record(
                    "interruption", "NodeClaim", claim.name,
                    f"drain:{event.kind}",
                    {"instance_id": iid, "reason": event.reason},
                    rev=getattr(self.cluster, "rev", None),
                )
                self.cluster.delete(claim)  # cordon & drain via termination

    def _audit(self):
        if self.obs is None:
            from ..obs import default_obs

            self.obs = default_obs()
        return self.obs.audit
