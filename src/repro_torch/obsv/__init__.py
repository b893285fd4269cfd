from repro_torch.obsv.reports import (
    BatchReport,
    EnumLevel,
    EnumReport,
    PlanReport,
    Report,
)
from repro_torch.obsv.trace import Span, Tracer, set_tracer, span, span_at, tracing

__all__ = [
    "BatchReport", "EnumLevel", "EnumReport", "PlanReport", "Report", "Span",
    "Tracer", "set_tracer", "span", "span_at", "tracing",
]
