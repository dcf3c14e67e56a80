"""Cluster state the consolidation screen reads (the JAX package's ``state/``,
as far as this slice needs it)."""

from .cluster import Cluster, Node  # noqa: F401
