"""The cloud-provider plugin: NodeClaim -> instance lifecycle.

Reference parity: ``pkg/cloudprovider/cloudprovider.go`` (Create / Delete /
Get / List / GetInstanceTypes / IsDrifted) + ``pkg/providers/instance``
(ranked-offering launch, ICE feedback, batched fleet calls).
"""

from .cloudprovider import CloudProvider, DriftReason  # noqa: F401
