"""Descent through the program's span trees below each completed query's
``service.finalize`` (``query.compact``; ``query.enumerate`` -> ``enum.*``),
shared by the readers of the spans inside a query."""

from __future__ import annotations

from cnib.spans import finalizes, mean


def under(spans, roots, names) -> dict:
    """root span id -> the finished spans called one of ``names`` that
    descend from that root, at any depth."""
    parent = {s.span_id: s.parent_id for s in spans}
    out: dict = {r.span_id: [] for r in roots}
    for s in spans:
        if s.name not in names or s.end_ns is None:
            continue
        p = s.parent_id
        while p is not None and p not in out:
            p = parent.get(p)
        if p is not None:
            out[p].append(s)
    return out


def per_query(readings, names, value) -> float | None:
    """The mean, over the queries completed in the window, of ``value(span)``
    summed over each query's spans called one of ``names`` (0 for a query
    that has none); None when no completed query has any."""
    fins = finalizes(readings)
    found = under(readings.spans, fins, set(names))
    if not any(found.values()):
        return None
    return mean(sum(value(s) for s in found[f.span_id]) for f in fins)
