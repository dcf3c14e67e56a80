"""Cloud error taxonomy.

Reference parity: ``pkg/errors/errors.go:31-52`` — not-found codes,
already-exists, unfulfillable-capacity (ICE) codes, launch-template-not-found.
The fake backend raises these; providers classify on them.
"""

from __future__ import annotations


class CloudError(Exception):
    code = "InternalError"

    def __init__(self, message: str = "", code: str = ""):
        super().__init__(message or self.__class__.code)
        if code:
            self.code = code


class NotFoundError(CloudError):
    code = "InvalidInstanceID.NotFound"


class AlreadyExistsError(CloudError):
    code = "ResourceAlreadyExists"


class InsufficientCapacityError(CloudError):
    """ICE — the capacity pool (instance type x zone x capacity type) is dry.

    Parity: errors.go:44-52 unfulfillableCapacityErrorCodes
    (InsufficientInstanceCapacity, MaxSpotInstanceCountExceeded, ...).
    """

    code = "InsufficientInstanceCapacity"

    def __init__(self, instance_type: str = "", zone: str = "", capacity_type: str = "", message: str = ""):
        super().__init__(message or f"ICE {capacity_type}:{instance_type}:{zone}")
        self.instance_type = instance_type
        self.zone = zone
        self.capacity_type = capacity_type


class LaunchTemplateNotFoundError(CloudError):
    code = "InvalidLaunchTemplateName.NotFoundException"


class RateLimitedError(CloudError):
    code = "RequestLimitExceeded"


class StaleFencingTokenError(CloudError):
    """A fenced write carried a token older than its lease's current
    tenancy: the writer was deposed (crash, pause past the TTL, netsplit)
    after planning the write, and the control-plane store rejects it
    instead of letting it race the successor replica
    (operator/sharding.py; designs/sharded-control-plane.md)."""

    code = "StaleFencingToken"


def is_stale_fence(err: Exception) -> bool:
    """A deposed replica's sanctioned write bounced off the store. The
    correct response is always "stand down quietly": the partition's new
    owner carries the work forward, so callers log and skip rather than
    crash-loop the reconcile."""
    return isinstance(err, CloudError) and err.code == StaleFencingTokenError.code


_NOT_FOUND_CODES = {
    "InvalidInstanceID.NotFound",
    "InvalidLaunchTemplateName.NotFoundException",
    "NoSuchEntity",
    "QueueDoesNotExist",
}

_UNFULFILLABLE_CODES = {
    "InsufficientFreeAddressesInSubnet",
    "InsufficientInstanceCapacity",
    "MaxSpotInstanceCountExceeded",
    "SpotMaxPriceTooLow",
    "UnfulfillableCapacity",
    "Unsupported",
    "InsufficientVolumeCapacity",
}


def is_not_found(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.code in _NOT_FOUND_CODES


def is_unfulfillable_capacity(err: Exception) -> bool:
    return isinstance(err, CloudError) and err.code in _UNFULFILLABLE_CODES


def is_launch_template_not_found(err: Exception) -> bool:
    """Parity: errors.go IsLaunchTemplateNotFound — triggers the single
    re-ensure retry in the launch path (instance.go:106-110)."""
    return (
        isinstance(err, CloudError)
        and err.code == LaunchTemplateNotFoundError.code
    )
