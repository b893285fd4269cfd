"""Observability of the port: tracing, metrics and typed reports, one
import surface (``from repro_torch import obsv``), as in the reference.

* **Tracing** (``obsv.trace``): per-query span trees on the monotonic
  clock, Chrome/Perfetto-exportable, free when no tracer is installed.
* **Metrics** (``obsv.metrics``): counters, gauges and exponential-bucket
  histograms in a ``MetricsRegistry``, rendered in Prometheus exposition
  format and checked by ``parse_prometheus``.
* **Reports** (``obsv.reports``): the typed schema of ``QueryStats.extras``.
"""

from repro_torch.obsv.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
)
from repro_torch.obsv.reports import (
    SCHEMA_VERSION,
    BatchReport,
    EnumLevel,
    EnumReport,
    OocReport,
    PlanReport,
    Report,
    ServiceReport,
    validate_extras,
)
from repro_torch.obsv.trace import (
    NOOP_SPAN,
    Span,
    Tracer,
    activate,
    enabled,
    end,
    get_tracer,
    set_tracer,
    span,
    span_at,
    start_detached,
    tracing,
)

__all__ = [
    "NOOP_SPAN", "SCHEMA_VERSION", "BatchReport", "Counter", "EnumLevel",
    "EnumReport", "Gauge", "Histogram", "MetricsRegistry", "OocReport",
    "PlanReport", "Report", "ServiceReport", "Span", "Tracer", "activate",
    "enabled", "end", "get_tracer", "parse_prometheus", "set_tracer", "span",
    "span_at", "start_detached", "tracing", "validate_extras",
]
