"""Reconcile loops of the provisioning half of the control plane (the JAX
package's ``controllers/``): nodeclass status and hash, registration, the
host binder and the provisioner, under the supervising ``Manager``.

All controllers are level-triggered ``reconcile()`` callables driven by the
Manager (or called directly in tests). The disruption, interruption,
termination, garbage-collection, liveness, tagging and nodeclass
termination controllers are not carried yet.
"""

from .base import Controller, Manager  # noqa: F401
from .provisioning import ProvisioningController  # noqa: F401
from .registration import RegistrationController  # noqa: F401
from .nodeclass_hash import NodeClassHashController  # noqa: F401
from .nodeclass_status import NodeClassStatusController  # noqa: F401
from .scheduling import SchedulingController  # noqa: F401
