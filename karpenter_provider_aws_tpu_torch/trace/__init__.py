"""Flight-recorder tracing for the controller loops: the span recorder
(``spans``) and the per-object correlation ledger (``correlate``) of the
JAX package's ``trace/``. Its Chrome-trace export, provenance records,
compile ledger and warmup are not carried yet.
"""

from .spans import TRACER, Span, Tracer, annotate, span, traced  # noqa: F401
