"""Span arithmetic shared by the metric readers."""

from __future__ import annotations


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name and s.end_ns is not None]


def ms(span) -> float:
    return (span.end_ns - span.start_ns) * 1e-6


def finalizes(readings) -> list:
    """The ``service.finalize`` spans of the queries completed in the window."""
    done = {c.rid for c in readings.completed}
    return [s for s in named(readings.spans, "service.finalize")
            if s.attrs.get("rid") in done]


def children_by_parent(spans, name: str) -> dict:
    """parent span id -> that parent's finished children called ``name``."""
    out: dict = {}
    for s in named(spans, name):
        out.setdefault(s.parent_id, []).append(s)
    return out


def mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None
