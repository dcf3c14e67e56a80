"""Hermetic in-memory cloud + queue backends.

Reference parity: ``pkg/fake`` — stateful API doubles with programmable
outputs, recorded inputs, an instance store, ``InsufficientCapacityPools``
to synthesize ICE, and ``NextError`` fault injection (ec2api.go:40-160).
This is the backend every tier-1 test runs against; no real cloud exists
anywhere in the test pyramid below e2e.
"""

from .cloud import (  # noqa: F401
    CapacityReservation,
    FakeCloud,
    Image,
    Instance,
    LaunchRequest,
    SecurityGroup,
    Subnet,
)
from .queue import FakeQueue, QueueMessage  # noqa: F401
