"""Cluster state: the journaled store the controllers and the consolidation
pass read (the JAX package's ``state/``, without its partition router)."""

from .cluster import Cluster, Node  # noqa: F401
