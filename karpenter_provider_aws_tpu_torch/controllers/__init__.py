"""Reconcile loops of the control plane (the JAX package's
``controllers/``): provisioning, registration, the host binder, termination,
disruption, interruption, garbage collection, liveness, tagging and the
nodeclass status, hash and termination controllers, under the supervising
``Manager``.

All controllers are level-triggered ``reconcile()`` callables driven by the
Manager (or called directly in tests). The refresh controllers, which the
JAX package's operator builds, are not carried.
"""

from .base import Controller, Manager  # noqa: F401
from .provisioning import ProvisioningController  # noqa: F401
from .registration import RegistrationController  # noqa: F401
from .garbagecollection import GarbageCollectionController  # noqa: F401
from .liveness import LivenessController  # noqa: F401
from .tagging import TaggingController  # noqa: F401
from .nodeclass_hash import NodeClassHashController  # noqa: F401
from .nodeclass_status import NodeClassStatusController  # noqa: F401
from .nodeclass_termination import NodeClassTerminationController  # noqa: F401
from .termination import TerminationController  # noqa: F401
from .scheduling import SchedulingController  # noqa: F401
from .disruption import DisruptionController  # noqa: F401
from .interruption import InterruptionController  # noqa: F401
