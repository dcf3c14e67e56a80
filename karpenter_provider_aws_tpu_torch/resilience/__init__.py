"""The per-reconcile deadline budget (``budget``) the ``Manager`` scopes
every reconcile in. The JAX package's circuit breakers and fault gate are
not carried: nothing here moves work off the device."""

from . import budget  # noqa: F401
