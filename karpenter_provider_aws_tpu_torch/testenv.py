"""Hermetic environment wiring the provisioning control plane against fakes.

The JAX package's ``testenv.py``: one call builds the fake cloud, catalog,
cluster store, cloud provider and controllers on an injectable fake clock
with millisecond batch windows; ``reset()`` wipes state between specs;
``step()`` runs one deterministic reconcile pass over every controller.

This package carries the provisioning half: the ``Manager`` runs, in the
reference's order, nodeclass status, nodeclass hash, registration, the host
binder (scheduling) and the provisioner, which solves on ``TorchSolver`` —
on the card unless ``device="cpu"`` is asked for. The environment's
disruption, interruption, termination, garbage-collection, liveness,
tagging and nodeclass-termination controllers are not carried yet, and
reading one raises ``NotImplementedError``. There is no breaker and no
fault gate to configure: a reconcile that raises is isolated into
``manager.errors``, which every harness reads after each step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from .catalog.provider import CatalogProvider
from .cloudprovider.cloudprovider import CloudProvider
from .controllers import (
    Manager,
    NodeClassHashController,
    NodeClassStatusController,
    ProvisioningController,
    RegistrationController,
    SchedulingController,
)
from .events import EventRecorder
from .fake import FakeCloud, FakeQueue
from .models.nodeclass import NodeClass
from .models.nodepool import NodePool
from .scheduling.solver import Solver, TorchSolver
from .state.cluster import Cluster
from .utils.batcher import BatcherOptions
from .utils.clock import FakeClock

#: the reference environment's controllers this package does not carry yet
NOT_CARRIED = ("disruption", "interruption", "termination", "garbagecollection",
               "liveness", "tagging", "nodeclass_termination")


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
    nodeclass_hash: NodeClassHashController
    nodeclass_status: NodeClassStatusController
    manager: Manager
    # env-local event sink on the env's FakeClock
    events: "EventRecorder" = None
    # env-local observability bundle (obs/): audit ring, SLO engine,
    # lifecycle SLI observer — installed on this env's cluster
    obs: "object" = None

    def __getattr__(self, name: str):
        if name in NOT_CARRIED:
            raise NotImplementedError(
                f"the {name} controller is not supported by this package yet"
            )
        raise AttributeError(name)

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


def new_environment(solver: Optional[Solver] = None, device=None, zones=None,
                    cluster_info=None) -> Environment:
    """The hermetic environment. The solver is ``TorchSolver(device=device)``
    unless one is passed in: ``device=None`` is the CUDA device, and the
    tests pass ``device="cpu"``."""
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

    obs_bundle = obs_mod.install(cluster=cluster, recorder=recorder, clock=clock)
    provisioning = ProvisioningController(cluster, solver, cloudprovider,
                                          recorder=recorder, obs=obs_bundle)
    scheduling = SchedulingController(cluster, provisioning, clock=clock)
    registration = RegistrationController(cluster, provisioning, clock=clock)
    nc_hash = NodeClassHashController(cluster)
    nc_status = NodeClassStatusController(cluster, cloudprovider)
    manager = Manager(
        [nc_status, nc_hash, registration, scheduling, provisioning],
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
        nodeclass_hash=nc_hash,
        nodeclass_status=nc_status,
        manager=manager,
        events=recorder,
        obs=obs_bundle,
    )
