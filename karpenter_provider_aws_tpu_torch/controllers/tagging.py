"""Tagging controller: post-launch instance tags.

Parity: ``pkg/controllers/nodeclaim/tagging/controller.go:56-115`` — tag the
instance with Name + claim identity once registered, mark the claim
annotated so it's done once.
"""

from __future__ import annotations

from ..cloudprovider.cloudprovider import CloudProvider, parse_provider_id
from ..models import labels as lbl
from ..state.cluster import Cluster
from ..utils import errors


class TaggingController:
    name = "tagging"
    interval_s = 10.0

    def __init__(self, cluster: Cluster, cloudprovider: CloudProvider):
        self.cluster = cluster
        self.cloudprovider = cloudprovider

    def reconcile(self) -> None:
        from ..operator import sharding

        for claim in list(self.cluster.nodeclaims.values()):
            if claim.deleted or not claim.is_registered():
                continue
            if not sharding.owns_claim(self.cluster, claim):
                continue  # the partition's owner tags
            if claim.annotations.get(lbl.ANNOTATION_INSTANCE_TAGGED) == "true":
                continue
            instance_id = parse_provider_id(claim.status.provider_id)
            if instance_id is None:
                continue
            try:
                self.cloudprovider.cloud.tag_instance(
                    instance_id,
                    {"Name": claim.status.node_name, "karpenter.tpu/nodeclaim": claim.name},
                )
            except Exception as e:
                if errors.is_not_found(e):
                    continue
                raise
            claim.annotations[lbl.ANNOTATION_INSTANCE_TAGGED] = "true"
