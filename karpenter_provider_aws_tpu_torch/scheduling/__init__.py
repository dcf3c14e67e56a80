"""The Solver boundary: ``TorchSolver``, ``HostSolver``, the ``Solver``
protocol, the plan types they return and ``snapshot_existing_capacity``."""

from .solver import (  # noqa: F401
    ExistingNode,
    HostSolver,
    NodeSpec,
    SolveResult,
    Solver,
    TorchSolver,
    snapshot_existing_capacity,
)
