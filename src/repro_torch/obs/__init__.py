"""Unified observability: typed metrics registry, deterministic span
tracing, and the counter-reconciliation checker.

Copied from ``src/repro/obs/__init__.py`` (NumPy and stdlib only): the
port imports nothing of the JAX package, so it keeps its own copy.

Import surface is deliberately dependency-free (numpy + stdlib only) so
every layer of the serving stack can import it without cycles.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Reservoir,
    publish_all,
)
from repro_torch.obs.reconcile import (  # noqa: F401
    check_all,
    check_trace_vs_metrics,
    reconcile,
)
from repro_torch.obs.tracing import (  # noqa: F401
    NullTracer,
    SpanTracer,
    get_tracer,
    install_tracer,
    validate_chrome_trace,
)
