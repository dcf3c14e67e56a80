"""Version provider: cluster control-plane version discovery + support gate.

Parity: ``pkg/providers/version/version.go:31-89`` — the server version is
fetched once and cached, and a supported range is enforced with a warning
outside it (the reference supports 1.23-1.29; this framework tracks its own
window).
"""

from __future__ import annotations

import logging
from typing import Optional

from ..utils.cache import TTLCache
from ..utils.clock import Clock

log = logging.getLogger("karpenter.tpu.version")

MIN_SUPPORTED_MINOR = 23
MAX_SUPPORTED_MINOR = 33
_VERSION_TTL_S = 15 * 60  # parity: version poll period


class VersionProvider:
    def __init__(self, cluster, clock: Optional[Clock] = None):
        self.cluster = cluster
        self._cache = TTLCache(default_ttl=_VERSION_TTL_S, clock=clock)
        self._warned = False

    def get(self) -> str:
        """Cached "major.minor" of the cluster control plane."""
        hit = self._cache.get("version")
        if hit is not None:
            return hit
        version = getattr(self.cluster, "server_version", "") or "1.29"
        version = version.lstrip("v")
        self._cache.set("version", version)
        self._check_supported(version)
        return version

    def minor(self) -> int:
        try:
            return int(self.get().split(".")[1])
        except (IndexError, ValueError):
            return 0

    def supported(self) -> bool:
        return MIN_SUPPORTED_MINOR <= self.minor() <= MAX_SUPPORTED_MINOR

    def _check_supported(self, version: str) -> None:
        if not self.supported() and not self._warned:
            self._warned = True
            log.warning(
                "cluster version %s outside the supported window 1.%d-1.%d",
                version, MIN_SUPPORTED_MINOR, MAX_SUPPORTED_MINOR,
            )

    def reset(self) -> None:
        self._cache.flush()
        self._warned = False
