"""The Solver boundary: ``TorchSolver``, ``HostSolver`` and the plan types they return."""

from .solver import ExistingNode, HostSolver, NodeSpec, SolveResult, TorchSolver  # noqa: F401
