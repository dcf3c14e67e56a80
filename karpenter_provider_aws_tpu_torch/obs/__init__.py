"""obs/: the judgment layer — SLIs, SLOs, decision audit, solver quality
(the host side of the JAX package's ``obs/``).

``trace/`` answers "what ran and how long"; this subsystem answers
"are we meeting our promises" and "why did the controller decide X":

 - :mod:`.sli`     — lifecycle SLIs (pod pending->bound, claim
   created->ready) via the cluster observer
 - :mod:`.slo`     — declarative SLO specs + multi-window burn-rate engine
 - :mod:`.audit`   — bounded JSONL ring of structured decision records
 - :mod:`.quality` — packing efficiency + FFD-oracle price-gap telemetry
 - :mod:`.why`     — the why board (empty: the why plane is not carried)

``install()`` wires one ``Obs`` bundle to a cluster + recorder and
registers ``/debug/slo``, ``/debug/decisions``, ``/debug/cluster`` and
``/debug/why`` on the metrics HTTP server. ``Obs.tick`` evaluates the SLOs
and runs idle housekeeping (event-recorder dedupe sweep).

Not carried yet: the steady-state and retrace sentinels, ``explain``, and
the ``/debug/sentinel``, ``/debug/device`` and ``/debug/flight`` pages.
"""

from __future__ import annotations

from typing import Optional

from ..trace.correlate import CorrelationLedger
from .audit import AuditLog, AuditRecord, default_audit
from .quality import OracleSampler, cluster_packing, solve_quality
from .sli import LifecycleSLI, percentile
from .slo import BurnRule, SLOEngine, SLOSpec, default_slos
from .why import WhyBoard
from .why import board as why_board
from .why import enabled as why_enabled

__all__ = [
    "AuditLog", "AuditRecord", "BurnRule", "CorrelationLedger",
    "LifecycleSLI", "Obs", "OracleSampler", "SLOEngine", "SLOSpec",
    "WhyBoard", "cluster_packing", "default_audit", "default_obs",
    "default_slos", "install", "percentile", "solve_quality", "why_board",
    "why_enabled",
]


class Obs:
    """One observability bundle: audit ring + SLO engine + lifecycle SLI
    + oracle sampler + correlation ledger, sharing a clock and recorder."""

    def __init__(self, clock=None, recorder=None, audit: Optional[AuditLog] = None,
                 specs=None):
        self.clock = clock
        self.recorder = recorder
        # an empty AuditLog is falsy (it has __len__): test for None
        self.audit = audit if audit is not None else AuditLog(clock=clock)
        self.slo = SLOEngine(clock=clock, recorder=recorder, specs=specs)
        # cross-replica correlation ledger (trace/correlate.py): the SLI
        # observer mints ids at first sight and controllers thread hops
        # through it (designs/fleet-flight-recorder.md)
        self.ledger = CorrelationLedger(clock=clock)
        self.sli = LifecycleSLI(clock=clock, engine=self.slo, audit=self.audit,
                                ledger=self.ledger)
        self.oracle = OracleSampler()
        self.cluster = None  # set by install()

    def tick(self, now: Optional[float] = None) -> dict:
        """One judgment pass (liveness cadence): evaluate every SLO
        (budget gauges, fast-burn Warning events) and run idle
        housekeeping — the event recorder's dedupe sweep happens here
        even when no new events arrive."""
        snapshot = self.slo.evaluate(now=now)
        if self.recorder is not None:
            try:
                self.recorder.sweep(now=now)
            except Exception:
                pass
        return snapshot

    def cluster_summary(self) -> dict:
        """The /debug/cluster payload: store shape + live SLI readings."""
        c = self.cluster
        if c is None:
            return {"error": "no cluster installed"}
        pending = self.sli.pending_ages()
        binds = self.sli.bind_durations()
        readies = self.sli.ready_durations()
        # store reads under the cluster lock: this runs on the metrics
        # HTTP thread while controllers mutate — an unlocked iteration
        # would intermittently die mid-apply, exactly when operators look
        with c._lock:
            shape = {
                "rev": getattr(c, "rev", None),
                "nodes": len(c.nodes),
                "nodes_ready": sum(1 for n in c.nodes.values() if n.ready),
                "nodeclaims": len(c.nodeclaims),
                "nodeclaims_draining": sum(
                    1 for cl in c.nodeclaims.values() if cl.deleted
                ),
                "pods": len(c.pods),
                "nodepools": len(c.nodepools),
            }
        shape.update({
            "pods_pending": len(pending),
            "oldest_pending_s": (
                round(max(pending.values()), 3) if pending else 0.0
            ),
            "time_to_bind_s": {
                "samples": len(binds), "p50": percentile(binds, 0.50),
                "p99": percentile(binds, 0.99),
            },
            "time_to_ready_s": {
                "samples": len(readies), "p50": percentile(readies, 0.50),
                "p99": percentile(readies, 0.99),
            },
        })
        return shape

    def reset(self) -> None:
        self.audit.reset()
        self.slo.reset()
        self.sli.reset()
        self.ledger.reset()
        self.oracle = OracleSampler()
        # the why board is process-global (the stamp sites have no bundle
        # handle); a bundle reset is the "fresh run" boundary, so clear it
        why_board().reset()


def install(cluster=None, recorder=None, clock=None, specs=None,
            register_debug: bool = True, audit: Optional[AuditLog] = None) -> Obs:
    """Build an Obs bundle, attach its lifecycle observer to ``cluster``
    (as ``cluster.observer`` — the sanctioned mutation surface calls its
    hooks), and register the /debug pages on the default metrics
    registry. Safe to call per hermetic environment: pages re-bind to the
    newest bundle."""
    bundle = Obs(clock=clock, recorder=recorder, specs=specs, audit=audit)
    if cluster is not None:
        cluster.observer = bundle.sli
        bundle.cluster = cluster
    if register_debug:
        from ..metrics import REGISTRY

        REGISTRY.register_debug_page("/debug/slo", bundle.tick)
        REGISTRY.register_debug_page(
            "/debug/decisions",
            lambda: [r.as_dict() for r in bundle.audit.tail(200)],
        )
        REGISTRY.register_debug_page("/debug/cluster", bundle.cluster_summary)
        from .why import debug_why_page

        REGISTRY.register_debug_page("/debug/why", debug_why_page)
    return bundle


_default: Optional[Obs] = None


def default_obs() -> Obs:
    """Process-default bundle (the operator's; tests build their own via
    ``install``). Lazy: importing obs never constructs state."""
    global _default
    if _default is None:
        from ..events import default_recorder

        _default = Obs(recorder=default_recorder(), audit=default_audit())
    return _default
