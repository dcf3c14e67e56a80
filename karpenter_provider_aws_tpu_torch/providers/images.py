"""Image provider: the AMI-family system's analogue.

Parity: ``pkg/providers/amifamily`` — default images resolved by family
alias (SSM-parameter analogue, ami.go:127-165), explicit selector-term
discovery (ami.go:176-199), newest-first ordering (ami.go:67-76), and
image -> compatible-instance-type mapping by architecture/accelerator
(ami.go:79-90 + resolver.go:123-162 grouping).
"""

from __future__ import annotations

from typing import Optional

from ..catalog.instancetypes import InstanceType
from ..models.nodeclass import NodeClass
from ..utils.cache import CacheTTL, TTLCache
from ..utils.clock import Clock


class ImageProvider:
    def __init__(self, cloud, clock: Optional[Clock] = None):
        self.cloud = cloud
        self._cache = TTLCache(default_ttl=CacheTTL.DEFAULT, clock=clock)

    def list(self, nodeclass: NodeClass):
        """Resolved images for a nodeclass, newest first.

        Selector terms win over the family alias (parity: AMISelectorTerms
        override the default SSM alias lookup).
        """
        key = ("images", nodeclass.name, nodeclass.image_family, tuple(nodeclass.image_selector))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if nodeclass.image_selector:
            # selector terms ride into the backend so discovery is scoped
            # at the wire (AWS: per-term DescribeImages filters/ids/owners
            # + pagination) instead of describing the whole account; the
            # host-side matches() pass below stays the enforcement point
            all_images = self.cloud.describe_images(
                selector_terms=list(nodeclass.image_selector)
            )
            images = [
                i for i in all_images
                if any(term.matches(i) for term in nodeclass.image_selector)
            ]
        else:
            all_images = self.cloud.describe_images()
            # family strategy's default-image queries (the SSM-alias
            # analogue, resolver.go DefaultAMIs); custom yields none —
            # selector terms are mandatory there
            from .imagefamily import get_family

            aliases = {q.alias for q in get_family(nodeclass.image_family).default_images()}
            images = [i for i in all_images if i.family in aliases]
        images = sorted(images, key=lambda i: -i.created_seq)
        self._cache.set(key, images)
        return images

    def reset(self) -> None:
        self._cache.flush()


def resolve_image_for(images, instance_type: InstanceType):
    """Pick the newest image compatible with an instance type (arch +
    GPU requirement), or None. Mirrors MapToInstanceTypes: GPU types take a
    GPU image when the family provides one; everything else matches arch."""
    for img in images:
        if img.arch != instance_type.arch:
            continue
        needs_gpu = instance_type.gpu_count > 0
        if needs_gpu and not img.gpu and any(i.gpu for i in images):
            continue
        if img.gpu and not needs_gpu:
            continue
        return img
    return None
