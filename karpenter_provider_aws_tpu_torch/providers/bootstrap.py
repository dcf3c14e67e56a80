"""Bootstrap: per-image-family node userdata generation.

Parity: ``pkg/providers/amifamily/bootstrap/`` — the ``Bootstrapper``
strategy interface (bootstrap.go), kubelet args derived from a
KubeletConfiguration (bootstrap.go:36-64 kubeletExtraArgs), MIME-multipart
merge of custom userdata with the generated script (eksbootstrap.go),
TOML settings for the bottlerocket-style family (bottlerocket.go,
bottlerocketsettings.go), YAML node config for the nodeadm-style family
(nodeadm.go), and verbatim passthrough for ``custom`` (custom.go).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

from ..models.nodeclass import KubeletConfiguration  # noqa: F401  (API-layer type)


@dataclass(frozen=True)
class ClusterInfo:
    """What a node needs to join the cluster (parity: the cluster
    name/endpoint/CA/DNS-IP resolved by operator.go:214-260)."""

    name: str
    endpoint: str = ""
    ca_bundle: str = ""
    dns_ip: str = ""
    version: str = ""
    ip_family: str = "ipv4"  # ipv4 | ipv6 (parity: ipv6 suite + KubeDNSIP discovery)
    # service CIDR, discovered from the cloud's cluster description
    # (parity: launchtemplate.go:429-450 ResolveClusterCIDR); consumed by
    # the nodeadm family's NodeConfig
    service_cidr: str = ""




def _node_labels_arg(labels: Mapping[str, str]) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(labels.items()))


def _taints_arg(taints: Sequence) -> str:
    return ",".join(
        f"{t.key}={t.value}:{t.effect}" if t.value else f"{t.key}:{t.effect}"
        for t in taints
    )


class ShellBootstrap:
    """eksbootstrap.sh-style shell script (families: standard/minimal/gpu).

    Custom userdata, when present, is merged ahead of the generated script in
    a MIME multipart document (parity: eksbootstrap.go mime merge — cloud
    init runs parts in order, user parts first)."""

    def __init__(self, cluster: ClusterInfo, kubelet: KubeletConfiguration,
                 labels: Mapping[str, str], taints: Sequence, custom: str = "",
                 instance_store_policy: Optional[str] = None):
        self.cluster = cluster
        self.kubelet = kubelet
        self.labels = labels
        self.taints = taints
        self.custom = custom
        # "RAID0" -> the bootstrap assembles instance-store disks into the
        # node filesystem (families that cannot honor it simply ignore it,
        # like the reference's bottlerocket/windows/custom bootstrappers)
        self.instance_store_policy = instance_store_policy

    def _dns_ip(self) -> str:
        """kubeletConfiguration ClusterDNS wins over the cluster-discovered
        kube-dns IP (parity: the ipv6 suite's kubeletConfig kube-dns case)."""
        if self.kubelet.cluster_dns:
            return self.kubelet.cluster_dns[0]
        return self.cluster.dns_ip

    def script(self) -> str:
        kubelet_args = list(self.kubelet.extra_args())
        if self.labels:
            kubelet_args.append(f"--node-labels={_node_labels_arg(self.labels)}")
        if self.taints:
            kubelet_args.append(f"--register-with-taints={_taints_arg(self.taints)}")
        lines = [
            "#!/bin/bash -xe",
            f"/etc/node/bootstrap.sh '{self.cluster.name}' \\",
            f"  --apiserver-endpoint '{self.cluster.endpoint}' \\",
            f"  --b64-cluster-ca '{self.cluster.ca_bundle}' \\",
        ]
        if self._dns_ip():
            lines.append(f"  --dns-cluster-ip '{self._dns_ip()}' \\")
        if self.cluster.ip_family == "ipv6":
            lines.append("  --ip-family 'ipv6' \\")
        if self.instance_store_policy == "RAID0":
            # parity: eksbootstrap.go:80-82 (--local-disks raid0)
            lines.append("  --local-disks raid0 \\")
        lines.append(f"  --kubelet-extra-args '{' '.join(kubelet_args)}'")
        generated = "\n".join(lines) + "\n"
        if not self.custom:
            return generated
        return mime_merge([self.custom, generated])


class NodeadmBootstrap(ShellBootstrap):
    """YAML NodeConfig (the AL2023/nodeadm-style family, nodeadm.go)."""

    def script(self) -> str:
        cfg = {
            "apiVersion": "node.karpenter.tpu/v1alpha1",
            "kind": "NodeConfig",
            "spec": {
                "cluster": {
                    "name": self.cluster.name,
                    "apiServerEndpoint": self.cluster.endpoint,
                    "certificateAuthority": self.cluster.ca_bundle,
                    "cidr": self.cluster.service_cidr,
                    "ipFamily": self.cluster.ip_family,
                },
                "kubelet": {
                    "flags": (
                        [f"--cluster-dns={self._dns_ip()}"]
                        if self._dns_ip() and not self.kubelet.cluster_dns
                        else []
                    )
                    + self.kubelet.extra_args()
                    + ([f"--node-labels={_node_labels_arg(self.labels)}"] if self.labels else [])
                    + ([f"--register-with-taints={_taints_arg(self.taints)}"] if self.taints else []),
                },
            },
        }
        if self.instance_store_policy == "RAID0":
            # parity: nodeadm.go:86-88 (LocalStorage.Strategy = RAID0)
            cfg["spec"]["instance"] = {"localStorage": {"strategy": "RAID0"}}
        generated = "# node.karpenter.tpu NodeConfig\n" + _yaml_dump(cfg)
        if not self.custom:
            return generated
        return mime_merge([self.custom, generated])


class TomlBootstrap(ShellBootstrap):
    """TOML settings document (the bottlerocket-style family).

    Custom userdata is parsed as TOML and deep-merged with the generated
    settings, generated keys winning (parity: bottlerocket.go merge
    semantics — karpenter-owned cluster settings are authoritative).
    Invalid custom TOML raises, surfacing at launch time."""

    def script(self) -> str:
        settings: dict = {"settings": {"kubernetes": {}}}
        k8s = settings["settings"]["kubernetes"]
        k8s["cluster-name"] = self.cluster.name
        k8s["api-server"] = self.cluster.endpoint
        if self.cluster.ca_bundle:
            k8s["cluster-certificate"] = self.cluster.ca_bundle
        if self._dns_ip():
            k8s["cluster-dns-ip"] = self._dns_ip()
        if self.kubelet.max_pods is not None:
            k8s["max-pods"] = self.kubelet.max_pods
        if self.labels:
            k8s["node-labels"] = dict(sorted(self.labels.items()))
        if self.taints:
            k8s["node-taints"] = {t.key: f"{t.value}:{t.effect}" for t in self.taints}
        if self.custom:
            import tomllib

            try:
                base = tomllib.loads(self.custom)
            except tomllib.TOMLDecodeError as e:
                raise ValueError(f"custom userdata is not valid TOML: {e}") from e
            settings = _deep_merge(base, settings)
        return _toml_dump(settings)


class PowershellBootstrap(ShellBootstrap):
    """PowerShell bootstrap (the windows-style family, windows.go): a
    <powershell> document invoking the bootstrap script with kubelet args;
    custom userdata is prepended inside the same block."""

    def script(self) -> str:
        args = []
        if self._dns_ip() and not self.kubelet.cluster_dns:
            args.append(f"--cluster-dns={self._dns_ip()}")
        args += self.kubelet.extra_args()
        if self.labels:
            args.append(f"--node-labels={_node_labels_arg(self.labels)}")
        if self.taints:
            args.append(f"--register-with-taints={_taints_arg(self.taints)}")
        lines = ["<powershell>"]
        if self.custom:
            lines.append(self.custom.rstrip("\n"))
        lines += [
            "[string]$BootstrapScript = 'C:\\Program Files\\Node\\Start-NodeBootstrap.ps1'",
            "& $BootstrapScript "
            + f"-ClusterName '{self.cluster.name}' "
            + f"-APIServerEndpoint '{self.cluster.endpoint}' "
            + (f"-Base64ClusterCA '{self.cluster.ca_bundle}' " if self.cluster.ca_bundle else "")
            + (
                "-KubeletExtraArgs '" + " ".join(args) + "' " if args else ""
            ).rstrip(),
            "</powershell>",
        ]
        return "\n".join(lines) + "\n"


class CustomBootstrap(ShellBootstrap):
    """Verbatim user data; the user owns the whole bootstrap (custom.go)."""

    def script(self) -> str:
        return self.custom


_MIME_BOUNDARY = "//KARPENTER-TPU-BOUNDARY//"


def mime_merge(parts: Sequence[str]) -> str:
    """Join userdata parts into one multipart/mixed document
    (parity: bootstrap/mime — parts execute in order)."""
    out = [
        "MIME-Version: 1.0",
        f'Content-Type: multipart/mixed; boundary="{_MIME_BOUNDARY}"',
        "",
    ]
    for part in parts:
        ctype = (
            "text/x-shellscript" if part.lstrip().startswith("#!") else "text/plain"
        )
        out += [
            f"--{_MIME_BOUNDARY}",
            f'Content-Type: {ctype}; charset="us-ascii"',
            "",
            part.rstrip("\n"),
        ]
    out.append(f"--{_MIME_BOUNDARY}--")
    return "\n".join(out) + "\n"


def bootstrapper_for(
    family: str,
    cluster: ClusterInfo,
    kubelet: Optional[KubeletConfiguration] = None,
    labels: Optional[Mapping[str, str]] = None,
    taints: Sequence = (),
    custom: str = "",
    instance_store_policy: Optional[str] = None,
) -> ShellBootstrap:
    """Family alias -> bootstrapper (parity: GetAMIFamily resolver.go:80-112).

    Thin delegate to the family strategy registry (providers.imagefamily) —
    ONE family->bootstrapper mapping exists, and every path gets the same
    feature-flag enforcement. Unknown families fall back to the standard
    (shell) family like the reference's default-to-AL2 behavior."""
    from .imagefamily import get_family  # here: imagefamily imports this module

    return get_family(family).bootstrapper(
        cluster, kubelet=kubelet, labels=labels, taints=taints, custom=custom,
        instance_store_policy=instance_store_policy,
    )


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursive dict merge; override wins on scalar conflicts."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _toml_key(k: str) -> str:
    return k if k.replace("-", "").replace("_", "").isalnum() else json.dumps(k)


def _toml_val(v) -> str:
    if isinstance(v, bool):
        return str(v).lower()
    if isinstance(v, str):
        return json.dumps(v)
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_val(x) for x in v) + "]"
    return str(v)


def _toml_dump(obj: dict, path: tuple[str, ...] = ()) -> str:
    """Deterministic TOML emitter for the nested settings dict. A table
    header is emitted only for tables holding scalars (pure-container levels
    like [settings] are implied by their children's dotted headers)."""
    scalars = [(k, v) for k, v in obj.items() if not isinstance(v, dict)]
    tables = [(k, v) for k, v in obj.items() if isinstance(v, dict)]
    lines: list[str] = []
    if scalars and path:
        lines.append("[" + ".".join(_toml_key(p) for p in path) + "]")
    for k, v in scalars:
        lines.append(f"{_toml_key(k)} = {_toml_val(v)}")
    for k, v in tables:
        body = _toml_dump(v, path + (k,))
        if body:
            lines.append(body)
    text = "\n".join(lines)
    if text and not path:
        text += "\n"
    return text


def _yaml_dump(obj, indent: int = 0) -> str:
    """Tiny deterministic YAML emitter (avoids a yaml dependency)."""
    pad = "  " * indent
    if isinstance(obj, Mapping):
        lines = []
        for k, v in obj.items():
            if isinstance(v, (Mapping, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_yaml_dump(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {json.dumps(v) if isinstance(v, str) else v}")
        return "\n".join(lines)
    if isinstance(obj, list):
        return "\n".join(f"{pad}- {json.dumps(v) if isinstance(v, str) else v}" for v in obj)
    return f"{pad}{obj}"
