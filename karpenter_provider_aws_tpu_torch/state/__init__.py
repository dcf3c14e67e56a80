"""Cluster state: the journaled store the consolidation pass reads (the JAX
package's ``state/``, without its partition router, pending-pod index, gang
counts and PDBs)."""

from .cluster import Cluster, Node  # noqa: F401
