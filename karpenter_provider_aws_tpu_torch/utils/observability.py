"""Profiling around the solve path.

The JAX package's ``utils/observability.py`` captures ``jax.profiler`` traces
when ``Profiler(profile_dir=...)`` names a directory; empty, every method is
a no-op. This package carries the empty profiler only, so call sites keep
the reference's shape: a non-empty ``profile_dir`` raises
``NotImplementedError``. The card's device time is read by ``chip_smoke.py``
through ``torch.profiler`` and CUDA events instead.
"""

from __future__ import annotations


class Profiler:
    """``capture(name)`` wraps one region and ``annotate(name)`` names a
    span inside it; both are no-ops."""

    def __init__(self, profile_dir: str = ""):
        if profile_dir:
            raise NotImplementedError(
                "profile captures (Profiler(profile_dir=...)) are not supported by this "
                "package yet"
            )
        self.profile_dir = ""

    @property
    def enabled(self) -> bool:
        return False

    def capture(self, name: str = "solve"):
        return _NullCtx()

    def annotate(self, name: str):
        return _NullCtx()


class _NullCtx:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
