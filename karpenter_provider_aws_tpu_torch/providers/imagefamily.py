"""Image-family strategies: per-family defaults + feature flags.

Parity: the upstream provider's ``pkg/providers/amifamily/resolver.go:80-112`` — the
``AMIFamily`` interface gives every family (al2/al2023/bottlerocket/ubuntu/
windows/custom) its own DefaultAMIs queries, default block-device mappings,
default metadata options, ephemeral device name, bootstrap generator, and
``FeatureFlags``. This module is that strategy layer for this framework's
families; ``providers.bootstrap`` keeps the per-family userdata generators
and ``operator.webhooks`` consults the registry + flags for admission.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..models.nodeclass import BlockDevice, KubeletConfiguration, MetadataOptions
from .bootstrap import (
    CustomBootstrap,
    NodeadmBootstrap,
    PowershellBootstrap,
    ShellBootstrap,
    TomlBootstrap,
)


@dataclass(frozen=True)
class FeatureFlags:
    """What a family's node agent supports (resolver.go:94-112)."""

    uses_eni_limited_memory_overhead: bool = True
    pods_per_core_enabled: bool = True
    eviction_soft_enabled: bool = True
    supports_eni_limited_pod_density: bool = True


@dataclass(frozen=True)
class DefaultImageQuery:
    """One default-image lookup (the SSM-parameter-alias analogue,
    ami.go:127-165): an alias plus the hardware it serves."""

    alias: str
    arch: str = "amd64"
    gpu: bool = False


class ImageFamily:
    """Base strategy: shell bootstrap, gp3 root volume, IMDSv2 defaults,
    all features on (the reference's DefaultFamily + AL2 shape)."""

    name = "standard"
    bootstrap_cls = ShellBootstrap
    ephemeral_device = "/dev/xvda"

    def default_images(self, k8s_version: str = "") -> list[DefaultImageQuery]:
        return [
            DefaultImageQuery(alias=self.name, arch="amd64"),
            DefaultImageQuery(alias=self.name, arch="arm64"),
            DefaultImageQuery(alias=self.name, arch="amd64", gpu=True),
        ]

    def default_block_device_mappings(self) -> list[BlockDevice]:
        return [BlockDevice(device_name=self.ephemeral_device,
                            volume_size_gib=20, volume_type="gp3")]

    def default_metadata_options(self) -> MetadataOptions:
        return MetadataOptions()  # IMDSv2 required, hop limit 2

    def feature_flags(self) -> FeatureFlags:
        return FeatureFlags()

    def bootstrapper(self, cluster, kubelet: Optional[KubeletConfiguration] = None,
                     labels=None, taints=(), custom: str = "",
                     instance_store_policy: Optional[str] = None):
        # feature-flag enforcement (parity: bottlerocket.go rejecting
        # evictionSoft in UserData): a kubelet knob the family's agent
        # cannot honor fails loudly at resolve time, not silently on-node
        flags = self.feature_flags()
        if kubelet is not None:
            if (
                (kubelet.eviction_soft or kubelet.eviction_soft_grace_period)
                and not flags.eviction_soft_enabled
            ):
                raise ValueError(
                    f"family {self.name} does not support evictionSoft"
                )
            if kubelet.pods_per_core is not None and not flags.pods_per_core_enabled:
                raise ValueError(
                    f"family {self.name} does not support podsPerCore"
                )
        return self.bootstrap_cls(
            cluster, kubelet or KubeletConfiguration(), labels or {}, taints,
            custom, instance_store_policy=instance_store_policy,
        )


class MinimalFamily(ImageFamily):
    name = "minimal"


class GpuFamily(ImageFamily):
    name = "gpu"

    def default_images(self, k8s_version: str = "") -> list[DefaultImageQuery]:
        return [DefaultImageQuery(alias="gpu", arch="amd64", gpu=True)]


class NodeadmFamily(ImageFamily):
    """AL2023-style: YAML NodeConfig bootstrap; memory overhead is reported
    by the agent, not ENI-derived (al2023.go FeatureFlags)."""

    name = "nodeadm"
    bootstrap_cls = NodeadmBootstrap

    def feature_flags(self) -> FeatureFlags:
        return FeatureFlags(uses_eni_limited_memory_overhead=False)


class BottlerocketFamily(ImageFamily):
    """TOML settings bootstrap; separate data volume; the agent manages
    eviction/pods-per-core itself (bottlerocket.go FeatureFlags +
    DefaultBlockDeviceMappings: xvda root 4Gi + xvdb data)."""

    name = "bottlerocket"
    bootstrap_cls = TomlBootstrap
    ephemeral_device = "/dev/xvdb"

    def default_block_device_mappings(self) -> list[BlockDevice]:
        return [
            BlockDevice(device_name="/dev/xvda", volume_size_gib=4,
                        volume_type="gp3", root_volume=True),
            BlockDevice(device_name="/dev/xvdb", volume_size_gib=20,
                        volume_type="gp3"),
        ]

    def feature_flags(self) -> FeatureFlags:
        return FeatureFlags(
            pods_per_core_enabled=False,
            eviction_soft_enabled=False,
            supports_eni_limited_pod_density=True,
        )


class UbuntuFamily(ImageFamily):
    """Ubuntu-style: shell bootstrap, /dev/sda1 root (ubuntu.go)."""

    name = "ubuntu"
    ephemeral_device = "/dev/sda1"


class WindowsFamily(ImageFamily):
    """Windows-style: PowerShell bootstrap, big /dev/sda1 root, hop limit 1,
    no ENI-limited pod density (windows.go FeatureFlags +
    DefaultMetadataOptions)."""

    name = "windows"
    bootstrap_cls = PowershellBootstrap
    ephemeral_device = "/dev/sda1"

    def default_images(self, k8s_version: str = "") -> list[DefaultImageQuery]:
        return [DefaultImageQuery(alias="windows", arch="amd64")]

    def default_block_device_mappings(self) -> list[BlockDevice]:
        return [BlockDevice(device_name="/dev/sda1", volume_size_gib=50,
                            volume_type="gp3")]

    def default_metadata_options(self) -> MetadataOptions:
        return MetadataOptions(http_put_response_hop_limit=1)

    def feature_flags(self) -> FeatureFlags:
        return FeatureFlags(
            uses_eni_limited_memory_overhead=False,
            pods_per_core_enabled=True,
            eviction_soft_enabled=True,
            supports_eni_limited_pod_density=False,
        )


class CustomFamily(ImageFamily):
    """User owns everything: no default images, no default devices beyond a
    root volume, verbatim userdata (custom.go)."""

    name = "custom"
    bootstrap_cls = CustomBootstrap

    def default_images(self, k8s_version: str = "") -> list[DefaultImageQuery]:
        return []  # imageSelector terms are mandatory (validated)


FAMILIES: dict[str, ImageFamily] = {
    f.name: f
    for f in (
        ImageFamily(),
        MinimalFamily(),
        GpuFamily(),
        NodeadmFamily(),
        BottlerocketFamily(),
        UbuntuFamily(),
        WindowsFamily(),
        CustomFamily(),
    )
}


def get_family(name: str) -> ImageFamily:
    """Family alias -> strategy; unknown aliases resolve to the standard
    family (the reference's default-to-AL2 behavior)."""
    return FAMILIES.get(name, FAMILIES["standard"])
