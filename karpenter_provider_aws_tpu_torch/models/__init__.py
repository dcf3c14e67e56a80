"""Data model: the framework's own NodePool/NodeClass/NodeClaim/Pod types
and the label requirements engine (the JAX package's ``models/``)."""

from .requirements import (  # noqa: F401
    Operator,
    Requirement,
    Requirements,
    ValueSet,
)
from .resources import ResourceVector, RESOURCE_AXES  # noqa: F401
from .pod import Pod, Toleration, TopologySpreadConstraint  # noqa: F401
from .nodepool import Budget, Disruption, Limits, NodePool, Taint  # noqa: F401
from .nodeclass import NodeClass, SelectorTerm, BlockDevice, MetadataOptions  # noqa: F401
from .nodeclaim import NodeClaim, NodeClaimStatus, Condition  # noqa: F401
from . import labels  # noqa: F401
