"""Hermetic environment wiring the control plane against fakes.

The JAX package's ``testenv.py``: one call builds the fake cloud, catalog,
cluster store, cloud provider and every controller on an injectable fake
clock with millisecond batch windows; ``reset()`` wipes state between specs;
``step()`` runs one deterministic reconcile pass over every controller.

The ``Manager`` runs the reference's twelve controllers in its order:
nodeclass status, nodeclass hash, interruption, termination, registration,
the host binder (scheduling), the provisioner, tagging, disruption, garbage
collection, liveness and nodeclass termination. The provisioner solves on
``TorchSolver`` and the disruption controller screens on the same device —
the card unless ``device="cpu"`` is asked for. There is no breaker and no
fault gate to configure: a reconcile that raises is isolated into
``manager.errors``, which every harness reads after each step. The
replica set of the JAX package (``ReplicaSetEnv``, ``new_replicaset``) is
not carried: ``new_replicaset`` raises ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .catalog.provider import CatalogProvider
from .cloudprovider.cloudprovider import CloudProvider
from .controllers import (
    DisruptionController,
    GarbageCollectionController,
    InterruptionController,
    LivenessController,
    Manager,
    NodeClassHashController,
    NodeClassStatusController,
    NodeClassTerminationController,
    ProvisioningController,
    RegistrationController,
    SchedulingController,
    TaggingController,
    TerminationController,
)
from .events import EventRecorder
from .fake import FakeCloud, FakeQueue
from .models.nodeclass import NodeClass
from .models.nodepool import NodePool
from .scheduling.solver import Solver, TorchSolver
from .state.cluster import Cluster
from .utils.batcher import BatcherOptions
from .utils.clock import FakeClock

@dataclass
class Environment:
    clock: FakeClock
    cloud: FakeCloud
    queue: FakeQueue
    catalog: CatalogProvider
    cluster: Cluster
    cloudprovider: CloudProvider
    solver: Solver
    provisioning: ProvisioningController
    scheduling: SchedulingController
    registration: RegistrationController
    termination: TerminationController
    disruption: DisruptionController
    interruption: InterruptionController
    garbagecollection: GarbageCollectionController
    liveness: LivenessController
    tagging: TaggingController
    nodeclass_hash: NodeClassHashController
    nodeclass_status: NodeClassStatusController
    nodeclass_termination: NodeClassTerminationController
    manager: Manager
    # env-local event sink on the env's FakeClock
    events: "EventRecorder" = None
    # env-local observability bundle (obs/): audit ring, SLO engine,
    # lifecycle SLI observer — installed on this env's cluster
    obs: "object" = None

    def close(self) -> None:
        """Join the cloud provider's batcher worker pools."""
        self.cloudprovider.close()

    def reset(self) -> None:
        self.cloud.reset()
        self.events.reset()
        self.obs.reset()
        self.queue.reset()
        self.cluster.__init__(clock=self.clock)
        self.catalog.unavailable.flush()
        self.catalog.reservations.flush()
        self.cloudprovider.reset_caches()
        self.provisioning.nominations.clear()
        self.provisioning.last_unschedulable.clear()
        self.disruption.disrupted.clear()
        self.disruption._consol_seen.clear()
        self.disruption._reject_logged.clear()
        self.interruption.handled.clear()
        self.garbagecollection.reaped.clear()
        self.liveness.reaped.clear()

    def step(self, n: int = 1) -> None:
        """n deterministic reconcile passes over every controller."""
        for _ in range(n):
            self.manager.reconcile_all_once()

    def apply_defaults(self, nodepool: Optional[NodePool] = None) -> tuple[NodePool, NodeClass]:
        """Apply a ready default NodeClass + NodePool pair."""
        nodeclass = NodeClass(name="default", role="node-role")
        pool = nodepool or NodePool(name="default")
        self.cluster.apply(nodeclass)
        self.cluster.apply(pool)
        self.nodeclass_status.reconcile()
        self.nodeclass_hash.reconcile()
        return pool, nodeclass


def seed_instance(cloud: FakeCloud, *, instance_id: str, instance_type: str,
                  zone: str, capacity_type: str, image_id: str,
                  tags: Optional[dict] = None, launch_time: float = 0.0):
    """Place a pre-existing running instance directly into the fake cloud.
    testenv is the one production-side importer of ``fake/``: harnesses
    that need synthetic cloud state route through it."""
    from .fake.cloud import Instance

    inst = Instance(
        id=instance_id, instance_type=instance_type, zone=zone,
        capacity_type=capacity_type, image_id=image_id,
        launch_time=launch_time, tags=dict(tags or {}),
        # sentinel fence: a harness-seeded fleet predates the lease layer
        launch_fence=("__seeded__", 0),
    )
    with cloud._lock:
        cloud.instances[inst.id] = inst
    return inst


def new_replicaset(*args, **kwargs):
    """The JAX package's active-active replica set is not carried."""
    raise NotImplementedError(
        "the replica set (ReplicaSetEnv, ShardElector) is not supported by this package yet"
    )


def new_environment(solver: Optional[Solver] = None, device=None, zones=None,
                    cluster_info=None, audit_capacity: Optional[int] = None) -> Environment:
    """The hermetic environment. The solver is ``TorchSolver(device=device)``
    unless one is passed in: ``device=None`` is the CUDA device, and the
    tests pass ``device="cpu"``. The disruption controller screens on the
    solver's device (a solver without one leaves it ``device``).
    ``audit_capacity`` sizes the audit ring (default 8,192 records, the
    newest kept) for a run whose whole trail is read back."""
    clock = FakeClock()
    cloud = FakeCloud(clock=clock, **({"zones": zones} if zones else {}))
    queue = FakeQueue()
    catalog = CatalogProvider(clock=clock, **({"zones": zones} if zones else {}))
    cluster = Cluster(clock=clock)
    cloudprovider = CloudProvider(
        cloud,
        catalog,
        cluster,
        clock=clock,
        batcher_options=BatcherOptions(idle_timeout_s=0.001, max_timeout_s=0.05),
        cluster_info=cluster_info,
    )
    solver = solver or TorchSolver(device=device)
    recorder = EventRecorder(clock=clock)
    from . import obs as obs_mod

    audit = obs_mod.AuditLog(capacity=audit_capacity, clock=clock) if audit_capacity else None
    obs_bundle = obs_mod.install(cluster=cluster, recorder=recorder, clock=clock, audit=audit)
    provisioning = ProvisioningController(cluster, solver, cloudprovider,
                                          recorder=recorder, obs=obs_bundle)
    scheduling = SchedulingController(cluster, provisioning, clock=clock)
    registration = RegistrationController(cluster, provisioning, clock=clock)
    termination = TerminationController(cluster, cloudprovider, clock=clock)
    # validation_period_s=0: specs drive single reconcile passes; the
    # window's own behavior is tested explicitly
    disruption = DisruptionController(cluster, cloudprovider, clock=clock,
                                      provisioning=provisioning, recorder=recorder,
                                      validation_period_s=0.0, obs=obs_bundle,
                                      device=getattr(solver, "device", device))
    interruption = InterruptionController(cluster, cloudprovider, queue,
                                          recorder=recorder, obs=obs_bundle)
    gc = GarbageCollectionController(cluster, cloudprovider, clock=clock)
    liveness = LivenessController(cluster, clock=clock, recorder=recorder,
                                  obs=obs_bundle)
    tagging = TaggingController(cluster, cloudprovider)
    nc_hash = NodeClassHashController(cluster)
    nc_status = NodeClassStatusController(cluster, cloudprovider)
    nc_term = NodeClassTerminationController(cluster, cloudprovider)
    manager = Manager(
        [
            nc_status,
            nc_hash,
            interruption,
            termination,
            registration,
            scheduling,
            provisioning,
            tagging,
            disruption,
            gc,
            liveness,
            nc_term,
        ],
        clock=clock,
        recorder=recorder,
    )
    return Environment(
        clock=clock,
        cloud=cloud,
        queue=queue,
        catalog=catalog,
        cluster=cluster,
        cloudprovider=cloudprovider,
        solver=solver,
        provisioning=provisioning,
        scheduling=scheduling,
        registration=registration,
        termination=termination,
        disruption=disruption,
        interruption=interruption,
        garbagecollection=gc,
        liveness=liveness,
        tagging=tagging,
        nodeclass_hash=nc_hash,
        nodeclass_status=nc_status,
        nodeclass_termination=nc_term,
        manager=manager,
        events=recorder,
        obs=obs_bundle,
    )
