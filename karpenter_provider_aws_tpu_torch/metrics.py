"""Prometheus-compatible metrics registry (text exposition format).

Parity surface: the reference's prometheus instrumentation — instance-type
gauges (pkg/providers/instancetype/metrics.go), batcher histograms
(pkg/batcher/metrics.go), interruption counters
(pkg/controllers/interruption/metrics.go), and the CloudProvider method
decorator (cmd/controller/main.go:44 metrics.Decorate).
"""

from __future__ import annotations

import threading
import time
from http.server import ThreadingHTTPServer
from typing import Optional


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        # read under the lock: a concurrent inc() resizing the dict must
        # not race this lookup (CPython dicts don't tear, but the
        # lock-free read was still an unordered peek at a mid-update map)
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """Sum across every label set (e.g. all-services retry volume)."""
        with self._lock:
            return float(sum(self._values.values()))

    def sum(self, **labels) -> float:
        """Sum across label sets MATCHING the given subset — e.g.
        ``ENCODE_CACHE.sum(path="cluster", outcome="full")`` totals every
        ``cause`` series of the full outcome. ``value()`` stays an exact
        label-set lookup."""
        want = set(labels.items())
        with self._lock:
            return float(sum(
                v for key, v in self._values.items() if want <= set(key)
            ))

    def _snapshot(self) -> list[tuple]:
        with self._lock:
            return sorted(self._values.items())

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, v in self._snapshot():
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


class Gauge(Counter):
    def set(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = value

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for key, v in self._snapshot():
            out.append(f"{self.name}{_fmt_labels(dict(key))} {v}")
        return out


class Histogram:
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0)

    def __init__(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(buckets)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            self._sums[key] = self._sums.get(key, 0.0) + value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            counts[-1] += 1  # +Inf (total observations)

    def time(self, **labels):
        hist = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                hist.observe(time.perf_counter() - self.t0, **labels)

        return _Timer()

    def expose(self) -> list[str]:
        # snapshot under the lock: a concurrent observe() appends bucket
        # rows and mutates count lists in place — expose must render a
        # coherent point-in-time view, not a mid-update one
        with self._lock:
            snap = sorted(
                (key, list(counts), self._sums[key])
                for key, counts in self._counts.items()
            )
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        for key, counts, total in snap:
            labels = dict(key)
            for i, b in enumerate(self.buckets):
                lab = dict(labels, le=str(b))
                out.append(f"{self.name}_bucket{_fmt_labels(lab)} {sum(counts[: i + 1])}")
            lab = dict(labels, le="+Inf")
            out.append(f"{self.name}_bucket{_fmt_labels(lab)} {counts[-1]}")
            out.append(f"{self.name}_sum{_fmt_labels(labels)} {total}")
            out.append(f"{self.name}_count{_fmt_labels(labels)} {counts[-1]}")
        return out


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()
        self._http: Optional[ThreadingHTTPServer] = None
        # /debug/* page providers: path -> zero-arg callable returning a
        # JSON-serializable object (the obs/ subsystem registers /debug/slo,
        # /debug/decisions, /debug/cluster here)
        self._debug_pages: dict = {}

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def register_debug_page(self, path: str, provider) -> None:
        """Expose ``provider()`` as JSON at ``path`` (must start with
        /debug/) on the metrics HTTP server. Re-registration replaces —
        a fresh hermetic environment owns the pages."""
        if not path.startswith("/debug/"):
            raise ValueError(f"debug pages live under /debug/: {path!r}")
        with self._lock:
            self._debug_pages[path] = provider

    def debug_page(self, path: str):
        """Render one registered page to a JSON-ready object (None when
        unregistered). Provider errors surface as an error payload — an
        introspection endpoint must never take down the scrape server."""
        with self._lock:
            provider = self._debug_pages.get(path)
        if provider is None:
            return None
        try:
            return provider()
        except Exception as e:  # pragma: no cover - defensive
            return {"error": f"{type(e).__name__}: {e}"}

    def metric_names(self) -> set[str]:
        """Registered family names (the docs schema-drift guard's source)."""
        with self._lock:
            return {m.name for m in self._metrics}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self.register(Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self.register(Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", buckets=Histogram.DEFAULT_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_, buckets))

    def expose(self) -> str:
        with self._lock:
            lines: list[str] = []
            for m in self._metrics:
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    # -- /metrics + health endpoints ---------------------------------------
    def serve(self, port: int, readiness=None) -> int:
        """Serve /metrics, /healthz (liveness: the process answers), and
        /readyz (readiness: the shipped deployment.yaml probes it —
        ``readiness`` is an optional callable the operator wires to "the
        manager is running"; a follower replica IS ready: it serves as a
        hot standby and must not be restarted by the kubelet)."""
        registry = self
        from .utils.httpserve import QuietHandler, serve_http

        class Handler(QuietHandler):
            def do_GET(self):  # noqa: N802
                if self.path == "/metrics":
                    self.reply(
                        200, registry.expose().encode(),
                        "text/plain; version=0.0.4",
                    )
                elif self.path == "/healthz":
                    self.reply(200, b"ok\n", "text/plain; version=0.0.4")
                elif self.path.startswith("/debug/"):
                    page = registry.debug_page(self.path)
                    if page is None:
                        self.reply(404, b"unknown debug page\n")
                    else:
                        import json

                        self.reply(
                            200,
                            json.dumps(page, indent=2, default=str).encode()
                            + b"\n",
                            "application/json",
                        )
                elif self.path == "/readyz":
                    ready = True
                    if readiness is not None:
                        try:
                            ready = bool(readiness())
                        except Exception:
                            ready = False
                    self.reply(
                        200 if ready else 503,
                        b"ok\n" if ready else b"not ready\n",
                        "text/plain; version=0.0.4",
                    )
                else:
                    self.reply(404, b"")

        self._http = serve_http(Handler, port)
        return self._http.server_address[1]

    def stop(self) -> None:
        from .utils.httpserve import stop_server

        stop_server(self._http)
        self._http = None


# The default process-wide registry + well-known metrics (created lazily by
# components; names mirror the reference's metric families).
REGISTRY = Registry()

SOLVE_DURATION = REGISTRY.histogram(
    "karpenter_solver_solve_duration_seconds", "End-to-end Solve() latency"
)
# Per-phase solve latency, fed by the trace/ flight recorder's metrics
# bridge (trace/export.py): encode / dispatch / device / decode spans land
# here with a phase label, so /metrics can attribute a slow solve without
# a profiler attach. Buckets skew low: phases are ms-scale where the
# end-to-end solve is tens-to-hundreds of ms.
SOLVE_PHASE_SECONDS = REGISTRY.histogram(
    "karpenter_solver_phase_duration_seconds",
    "Solve latency by phase (encode/dispatch/device/decode), from trace spans",
    buckets=(0.0005, 0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0),
)
RECONCILE_SECONDS = REGISTRY.histogram(
    "karpenter_controller_reconcile_duration_seconds",
    "Controller reconcile latency by controller, from trace spans "
    "(parity: controller-runtime's controller_runtime_reconcile_time_seconds)",
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0),
)
AWS_REQUEST_SECONDS = REGISTRY.histogram(
    "karpenter_aws_request_duration_seconds",
    "Signed AWS API call latency by service, from trace spans (includes "
    "retries; the retry count rides the span and the counter below)",
    buckets=(0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0, 30.0),
)
AWS_REQUEST_RETRIES = REGISTRY.counter(
    "karpenter_aws_request_retries_total",
    "AWS API retry attempts by service (DefaultRetryer parity)",
)
AWS_REQUEST_RETRY_REASONS = REGISTRY.counter(
    "karpenter_aws_request_retry_reason_total",
    "AWS API retry attempts by service and cause class "
    "(throttle / server / connection) — what chaos runs assert on",
)
SOLVE_PODS = REGISTRY.counter("karpenter_solver_pods_total", "Pods passed through Solve()")
NODES_CREATED = REGISTRY.counter("karpenter_nodes_created_total", "Nodes launched")
NODES_TERMINATED = REGISTRY.counter("karpenter_nodes_terminated_total", "Nodes terminated")
DISRUPTION_ACTIONS = REGISTRY.counter(
    "karpenter_disruption_actions_total", "Disruption actions by reason"
)
INTERRUPTION_MESSAGES = REGISTRY.counter(
    "karpenter_interruption_messages_total", "Interruption queue messages by kind"
)
INTERRUPTION_MESSAGE_ERRORS = REGISTRY.counter(
    "karpenter_interruption_message_errors_total",
    "Interruption messages whose handler raised; the message is still "
    "deleted (documented at-least-once semantics) instead of poisoning "
    "the queue with eternal redelivery",
)
CHAOS_FAULTS_INJECTED = REGISTRY.counter(
    "karpenter_chaos_faults_injected_total",
    "Chaos faults injected by kind (chaos/ subsystem)",
)
ICE_CACHE_SIZE = REGISTRY.gauge(
    "karpenter_ice_cache_size",
    "Offerings currently masked by the unavailable-offerings (ICE) cache "
    "— chaos scenarios assert its growth under storms and decay after",
)
ENCODE_CACHE = REGISTRY.counter(
    "karpenter_encode_cache_total",
    "Encode-cache outcomes by path (cluster = consolidation ClusterTensors, "
    "problem = provisioning EncodedProblem, occupancy = bound-pod zone "
    "snapshot) and outcome (hit = served unchanged, patch = delta-patched, "
    "full = rebuilt from scratch)",
)
ENCODE_PATCH_ROWS = REGISTRY.counter(
    "karpenter_encode_patch_rows_total",
    "Node rows rewritten by incremental cluster-encode patches",
)
ENCODE_PARTITIONS = REGISTRY.gauge(
    "karpenter_encode_partitions",
    "Live (nodepool, zone) partitions tracked by the partitioned cluster "
    "encoder (ops/encode_partition.py); 0 while the single-chain encoder "
    "serves the cluster",
)
PARTITION_SOLVE_LANES = REGISTRY.counter(
    "karpenter_partition_solve_lanes_total",
    "FFD partition lanes executed by the mesh-parallel multi-pool solve, "
    "by mode (vmap = single-program vmapped lanes, shard_map = lanes "
    "sharded across the device axis, fallback = per-pool dispatch)",
)
# -- ops/device_state.py: device-resident cluster state ---------------------
DEVICE_STATE = REGISTRY.counter(
    "karpenter_device_state_total",
    "Device-resident cluster-state outcomes by path (screen = the "
    "consolidation repack tensors) and outcome (hit = device buffers "
    "served unchanged, patch = scatter-patched on device from the change "
    "journal delta, upload = full host->device upload, fallback = the "
    "residency layer was off/unusable and the host-buffer path ran)",
)
DEVICE_STATE_PATCH_ROWS = REGISTRY.counter(
    "karpenter_device_state_patch_rows_total",
    "Node rows rewritten on device by scatter patches (the link carries "
    "only these rows' bytes instead of the full ladder-padded buffers)",
)
DEVICE_STATE_BYTES = REGISTRY.counter(
    "karpenter_device_state_bytes_total",
    "Bytes shipped host->device by the residency layer, by kind (upload = "
    "full buffer uploads, patch = scatter-patch row payloads)",
)
BATCH_SIZE = REGISTRY.histogram(
    "karpenter_batcher_batch_size", "Requests per coalesced batch",
    buckets=(1, 2, 5, 10, 50, 100, 500, 1000),
)
ICE_EVENTS = REGISTRY.counter(
    "karpenter_insufficient_capacity_errors_total", "ICE occurrences"
)
EVENTS = REGISTRY.counter(
    "karpenter_events_total",
    "Events published by controllers, by type and reason (parity: the core "
    "event recorder behind interruption controller.go:219-238)",
)
SIDECAR_RPC_SECONDS = REGISTRY.histogram(
    "karpenter_sidecar_rpc_duration_seconds",
    "Solver-sidecar RPC latency by method, server side",
    buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0, 5.0, 30.0),
)
SIDECAR_ERRORS = REGISTRY.counter(
    "karpenter_sidecar_rpc_errors_total", "Solver-sidecar RPC failures by method"
)
BATCH_WINDOW = REGISTRY.histogram(
    "karpenter_batcher_window_seconds",
    "Time from a batch's first request to execution (parity: batcher window histograms, metrics.go:37-47)",
    buckets=(0.001, 0.005, 0.01, 0.035, 0.1, 0.3, 1.0, 3.0),
)
# -- obs/ subsystem: lifecycle SLIs, solver quality, SLOs, audit ----------
POD_SCHEDULING_SECONDS = REGISTRY.histogram(
    "karpenter_pod_scheduling_duration_seconds",
    "Pod lifecycle SLI by phase: nominate = pending->nominated, "
    "bind = pending->bound (parity: the reference's pod-startup "
    "histograms). Fed by the obs/ cluster observer on every sanctioned "
    "bind, in the store clock's time base",
    buckets=(0.5, 1, 5, 15, 30, 60, 120, 300, 600, 1800),
)
NODECLAIM_LIFECYCLE_SECONDS = REGISTRY.histogram(
    "karpenter_nodeclaim_lifecycle_duration_seconds",
    "NodeClaim phase transitions: launch = created->launched, register = "
    "launched->registered, ready = registered->initialized, total = "
    "created->initialized (obs/ lifecycle SLI)",
    buckets=(1, 5, 15, 30, 60, 120, 300, 600, 900, 1800),
)
SLO_BUDGET_REMAINING = REGISTRY.gauge(
    "karpenter_slo_error_budget_remaining",
    "Fraction of the SLO's error budget left over its compliance window "
    "(1 = untouched, 0 = exhausted), per declared SLO (obs/slo.py)",
)
SLO_BURN_RATE = REGISTRY.gauge(
    "karpenter_slo_burn_rate",
    "Error-budget burn rate per SLO and rule window (1.0 = burning "
    "exactly the sustainable rate; fast-burn Warning events fire when "
    "both windows of a rule exceed its factor)",
)
SOLVE_PACKING_EFFICIENCY = REGISTRY.gauge(
    "karpenter_solver_packing_efficiency",
    "Requested/allocatable per resource across the nodes the last solve "
    "committed to launch (1.0 = perfectly packed; solver-quality SLI)",
)
CLUSTER_PACKING_EFFICIENCY = REGISTRY.gauge(
    "karpenter_cluster_packing_efficiency",
    "Bound-pod requests / node allocatable per resource across live "
    "nodes, refreshed by each consolidation screen sweep",
)
SOLVE_COST_VS_ORACLE = REGISTRY.gauge(
    "karpenter_solver_cost_vs_oracle",
    "Committed launch cost / FFD-oracle cost for the sampled solve "
    "(scheduling/oracle.py; sampled off the hot path, pure-launch "
    "passes only — ~1.0 means the device plan matches the oracle)",
)
OPTIMIZER_LANE = REGISTRY.counter(
    "karpenter_optimizer_lane_total",
    "Optimizer-lane outcomes per solve (scheduling/optimizer.py): "
    "adopted, rejected, skipped_tight (FFD within 1% of the LP bound), "
    "skipped_existing (plan binds live slack), skipped_large (group axis "
    "past the dispatch ceiling), breaker_open, error, and "
    "consolidation_adopted (the multi-replace subset chooser)",
)
UNSCHEDULABLE_PODS = REGISTRY.counter(
    "karpenter_solver_unschedulable_pods_total",
    "Pods a solve pass left unschedulable (solver-quality SLI; the "
    "per-pod reasons ride the audit log and FailedScheduling events)",
)
GANG_PLACEMENTS = REGISTRY.counter(
    "karpenter_gang_placements_total",
    "Pod groups committed atomically — every member placed in one solve "
    "(the all-or-nothing gate in scheduling/groups.enforce_gangs)",
)
GANG_WITHHELD = REGISTRY.counter(
    "karpenter_gang_withheld_total",
    "Pod groups stripped WHOLE by the all-or-nothing commit gate because "
    "fewer than min_count members were placeable this solve",
)
UNSCHEDULABLE_REASONS = REGISTRY.counter(
    "karpenter_unschedulable_reason_total",
    "Unschedulable pods by decoded why-engine verdict (obs/why.py: "
    "capacity / shape / requirements / zone / hostname / ice / limits / "
    "market:* / reservation:expired / gang:atomicity-shortfall) — the "
    "aggregated frontier view of WHY pending work is pending",
)
CONSOLIDATION_REJECTED = REGISTRY.counter(
    "karpenter_consolidation_rejected_total",
    "Consolidation / optimizer proposals rejected, by decoded reason "
    "(budget:<class> at the disruption budget gate, lane:validator and "
    "lane:not-cheaper at the optimizer adoption contract) — obs/why.py",
)
LEADER = REGISTRY.gauge(
    "karpenter_leader",
    "1 when this replica holds the leader lease, else 0 (by identity). "
    "docs/troubleshooting.md points operators here for split-brain triage "
    "— the docs referenced it before it existed; the obs/ schema-drift "
    "guard caught that",
)
AUDIT_RECORDS = REGISTRY.counter(
    "karpenter_audit_records_total",
    "Decision audit records appended, by kind (placement / disruption / "
    "interruption / eviction / lifecycle — obs/audit.py)",
)
# -- resilience/ subsystem: circuit breakers, crash-loop supervision ------
CIRCUIT_STATE = REGISTRY.gauge(
    "karpenter_circuit_state",
    "Circuit-breaker state per dependency (0 = closed, 1 = half-open, "
    "2 = open); keyed instances guard each solver backend "
    "(solver.pallas / solver.xla-scan / solver.mesh / solver.sidecar) "
    "and each AWS service (aws.<service>) — resilience/breaker.py",
)
CIRCUIT_TRANSITIONS = REGISTRY.counter(
    "karpenter_circuit_transitions_total",
    "Circuit-breaker state transitions by breaker name and target state "
    "(to = closed / half-open / open)",
)
CONTROLLER_STUCK = REGISTRY.gauge(
    "karpenter_controller_stuck",
    "1 while a controller's in-flight reconcile has exceeded N x its "
    "interval (the Manager watchdog; a Warning event fires on the edge), "
    "else 0",
)
CRASHLOOP_BACKOFFS = REGISTRY.counter(
    "karpenter_controller_crashloop_backoff_total",
    "Crash-loop backoffs armed by consecutive reconcile failures, per "
    "controller (reset on the first successful reconcile)",
)

# -- operator/sharding.py: horizontally sharded control plane ---------------
SHARD_LEASES_HELD = REGISTRY.gauge(
    "karpenter_shard_leases_held",
    "Partition leases this replica currently holds (by replica identity); "
    "the GLOBAL lease counts as one — a healthy N-replica deployment sums "
    "to the partition count + 1 across replicas",
)
SHARD_REBALANCES = REGISTRY.counter(
    "karpenter_shard_rebalances_total",
    "Partition-lease ownership changes by reason (acquired = new tenancy, "
    "rebalance = voluntary hand-off to the rendezvous target, lost = a "
    "definitive foreign holder dropped the lease, renew-failed = an "
    "indeterminate CAS renew error; the lease rides its old renew date "
    "to the renew deadline)",
)
FENCED_WRITES_REJECTED = REGISTRY.counter(
    "karpenter_fenced_writes_rejected_total",
    "Cloud-side writes rejected because their fencing token belonged to a "
    "superseded lease tenancy (a deposed replica's in-flight launch/"
    "terminate bounced instead of racing the successor), by api",
)
PROVISIONING_STEALS = REGISTRY.counter(
    "karpenter_provisioning_steals_total",
    "Work-stealing GLOBAL-queue claim outcomes (sharded provisioning), by "
    "outcome: claimed = the GLOBAL-lease holder's normal batch, stolen = a "
    "partition holder picked up unclaimed/expired global pods, contended = "
    "items lost to another live claimant's CAS, fenced = the whole claim "
    "attempt bounced on a superseded fencing token (deposed replica)",
)
LEASE_OWNERSHIP = REGISTRY.gauge(
    "karpenter_lease_ownership",
    "Partition leases (incl. GLOBAL) held per replica identity as seen on "
    "the lease host — the fleet-wide twin of karpenter_shard_leases_held "
    "(which each replica sets for itself); the rendezvous-imbalance gauge "
    "below is derived from this distribution",
)
RENDEZVOUS_IMBALANCE = REGISTRY.gauge(
    "karpenter_rendezvous_imbalance",
    "max/mean partition leases held across live replicas (1.0 = perfectly "
    "balanced rendezvous hash; the ROADMAP's 16-keys/8-replicas skew made "
    "this measured, not anecdotal)",
)
PROVISIONING_SHARDED_PODS = REGISTRY.counter(
    "karpenter_provisioning_sharded_pods_total",
    "Pending pods routed by the sharded provisioner, by scope: local = "
    "pinned to an owned (nodepool, zone) partition and solved on this "
    "replica's device mirror, global = through the work-stealing GLOBAL "
    "queue, foreign = pinned to a partition another replica owns (skipped "
    "here, solved there)",
)

# -- fleet flight recorder (trace/correlate.py + obs/fleet.py) --------------
POD_QUEUE_WAIT_SECONDS = REGISTRY.histogram(
    "karpenter_pod_queue_wait_seconds",
    "GLOBAL work-queue wait per pod (enqueue -> claim), by outcome "
    "(claimed = the GLOBAL-lease holder's normal batch, stolen = picked "
    "up by a partition holder after the GLOBAL holder died) — the "
    "steal-latency SLI (obs/sli.py)",
    buckets=(0.5, 1, 5, 15, 30, 60, 120, 300, 600, 1800),
)
CORRELATION_HOPS = REGISTRY.counter(
    "karpenter_correlation_hops_total",
    "Lifecycle hops recorded in the correlation ledger, by hop kind: "
    "pod-side pending / route / claim / steal / solve / launch / "
    "nominate / bind / evict, claim-side launched / launch-for / "
    "register / ready / adopt / disrupt (trace/correlate.py; the hop "
    "table in designs/fleet-flight-recorder.md is the vocabulary)",
)

# -- trace/jitwatch.py + obs/device.py: device-plane observatory ------------
JIT_COMPILES = REGISTRY.counter(
    "karpenter_jit_compiles_total",
    "Program (re)traces recorded by the jitwatch ledger, by program family "
    "and kind (compile = a family's first trace, retrace = an additional "
    "signature after it — the ladder discipline demands steady state "
    "retraces ZERO times; the retrace sentinel pages on this edge)",
)
JIT_COMPILE_SECONDS = REGISTRY.histogram(
    "karpenter_jit_compile_seconds",
    "Wall seconds of each jitwatch-recorded trace (first call with a new "
    "signature: trace + compile + one execution), by program family — fed "
    "by the metrics bridge from jit.compile spans",
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 15.0, 60.0),
)
DEVICE_LIVE_BYTES = REGISTRY.gauge(
    "karpenter_device_live_bytes",
    "Estimated device-resident bytes per program family (last dispatch's "
    "abstract input sizes; the device_state.mirror family is the "
    "holder-LRU's actual buffer bytes) — the DeviceAccountant's "
    "HBM-watermark source (obs/device.py)",
)

# -- obs/sentinel.py: live steady-state regression sentinel -----------------
SENTINEL_TICK_WALL = REGISTRY.gauge(
    "karpenter_sentinel_tick_wall_ms",
    "Wall milliseconds of span time attributed to the most recent "
    "sentinel tick (the liveness-cadence delta over the cumulative "
    "span profile)",
)
SENTINEL_SHARE = REGISTRY.gauge(
    "karpenter_sentinel_share",
    "Per-subsystem share of the most recent sentinel tick's wall profile "
    "(controller.* spans keep their name; other spans fold to their "
    "family) — the live twin of the cliff detector's attribution shares",
)
SENTINEL_REGRESSIONS = REGISTRY.counter(
    "karpenter_sentinel_regressions_total",
    "Edge-triggered SteadyStateRegression findings by named subsystem "
    "and kind (attribution-shift = one family's share jumped past the "
    "cliff thresholds, tick-superlinear = the whole tick blew past its "
    "rolling baseline)",
)

# -- sim/ subsystem: deterministic fleet simulator --------------------------
SIM_EVENTS = REGISTRY.counter(
    "karpenter_sim_events_total",
    "Workload-trace events applied by the fleet simulator, by kind "
    "(wave / flood / churn / expire / overlay-activate / overlay-deactivate)",
)
SIM_PASSES = REGISTRY.counter(
    "karpenter_sim_controller_passes_total",
    "Full controller-manager reconcile passes driven by the fleet "
    "simulator (micro-bursts after events + steady heartbeat)",
)
SIM_VIRTUAL_SECONDS = REGISTRY.gauge(
    "karpenter_sim_virtual_seconds",
    "Virtual seconds elapsed in the current (or most recent) fleet-"
    "simulator run; /debug/sim serves the full last-run summary",
)

# Catalog gauges (parity: instancetype metrics.go:32-75 — vCPU/memory per
# type, offering price/availability per (type, zone, capacity type)).
INSTANCE_TYPE_VCPU = REGISTRY.gauge(
    "karpenter_instance_type_cpu_cores", "vCPU cores per instance type"
)
INSTANCE_TYPE_MEMORY = REGISTRY.gauge(
    "karpenter_instance_type_memory_bytes", "Memory per instance type"
)
OFFERING_PRICE = REGISTRY.gauge(
    "karpenter_instance_type_offering_price_estimate", "Offering $/hr"
)
OFFERING_AVAILABLE = REGISTRY.gauge(
    "karpenter_instance_type_offering_available", "Offering availability (0/1)"
)
PRICING_AGE = REGISTRY.gauge(
    "karpenter_pricing_age_seconds",
    "Seconds since the live pricing backend last refreshed, per source "
    "(spot / on-demand); only published once a source has refreshed at "
    "least once — past the TTL a PricingStale Warning event fires "
    "(catalog/pricing.py observe_staleness)",
)


def publish_catalog_metrics(types) -> None:
    """Refresh-time gauge publication (instancetype metrics.go parity)."""
    for it in types:
        INSTANCE_TYPE_VCPU.set(float(it.vcpus), instance_type=it.name)
        INSTANCE_TYPE_MEMORY.set(float(it.memory_mib) * 1024 * 1024, instance_type=it.name)
        for o in it.offerings:
            labels = dict(
                instance_type=it.name, zone=o.zone, capacity_type=o.capacity_type
            )
            OFFERING_PRICE.set(float(o.price), **labels)
            OFFERING_AVAILABLE.set(1.0 if o.available else 0.0, **labels)
