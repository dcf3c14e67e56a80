"""Metrics decorator for the CloudProvider plugin boundary.

Parity: ``cmd/controller/main.go:44`` ``metrics.Decorate(cloudProvider)`` —
every plugin method is wrapped with a duration histogram and an error
counter labeled by method, so controller dashboards see provider latency
and failure rates without any provider knowing about metrics.
"""

from __future__ import annotations

import time

from ..metrics import REGISTRY

METHOD_DURATION = REGISTRY.histogram(
    "karpenter_cloudprovider_duration_seconds",
    "CloudProvider method latency",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0),
)
METHOD_ERRORS = REGISTRY.counter(
    "karpenter_cloudprovider_errors_total",
    "CloudProvider method errors",
)

_DECORATED = (
    "create",
    "delete",
    "get",
    "list_instances",
    "get_instance_types",
    "is_drifted",
)


class MetricsCloudProvider:
    """Transparent wrapper: decorated methods observe; everything else
    (providers, catalog, caches) proxies straight through."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in _DECORATED or not callable(attr):
            return attr

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return attr(*args, **kwargs)
            except Exception as e:
                METHOD_ERRORS.inc(method=name, error=type(e).__name__)
                raise
            finally:
                METHOD_DURATION.observe(time.perf_counter() - t0, method=name)

        return timed


def decorate(cloudprovider) -> MetricsCloudProvider:
    return MetricsCloudProvider(cloudprovider)
