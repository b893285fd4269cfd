"""In-process span tracing, cut to what the port's query path calls.

Instrumented code calls the module-level ``span`` / ``span_at``; with no
tracer installed both do nothing (``span`` returns one shared no-op context
manager, ``span_at`` returns None).  Install a tracer for a scope with::

    with tracing() as tracer:
        engine.query(q)
    names = tracer.names()

Timestamps come from ``time.perf_counter`` (monotonic), the clock the
engine's own phase timings use.
"""

from __future__ import annotations

import contextlib
import time


class Span:
    """One timed node of a trace tree; ``end_ns`` is None while open."""

    __slots__ = ("name", "span_id", "parent_id", "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, span_id: int, parent_id: int | None,
                 start_ns: int, attrs: dict):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns: int | None = None
        self.attrs = attrs

    def set_attrs(self, **attrs) -> None:
        self.attrs.update(attrs)


class _NoopSpan:
    """Shared do-nothing span/context manager for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attrs(self, **attrs):
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Collects finished spans; nesting follows an implicit stack."""

    def __init__(self):
        self.spans: list[Span] = []
        self._stack: list[Span] = []
        self._next_id = 1

    def _new(self, name: str, start_ns: int, attrs: dict) -> Span:
        parent = self._stack[-1].span_id if self._stack else None
        s = Span(name, self._next_id, parent, start_ns, dict(attrs))
        self._next_id += 1
        return s

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        s = self._new(name, time.perf_counter_ns(), attrs)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.end_ns = time.perf_counter_ns()
            self._stack.remove(s)
            self.spans.append(s)

    def span_at(self, name: str, start_s: float, end_s: float, **attrs) -> Span:
        """Record an already-elapsed span from ``perf_counter()`` stamps."""
        s = self._new(name, int(start_s * 1e9), attrs)
        s.end_ns = int(end_s * 1e9)
        self.spans.append(s)
        return s

    def names(self) -> set[str]:
        return {s.name for s in self.spans}


_ACTIVE: Tracer | None = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear) the process-global tracer; returns the previous."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    return prev


def span(name: str, **attrs):
    """Context manager for one span of the active tracer; free when off."""
    if _ACTIVE is None:
        return NOOP_SPAN
    return _ACTIVE.span(name, **attrs)


def span_at(name: str, start_s: float, end_s: float, **attrs) -> Span | None:
    if _ACTIVE is None:
        return None
    return _ACTIVE.span_at(name, start_s, end_s, **attrs)


@contextlib.contextmanager
def tracing():
    """Scope with a fresh active ``Tracer`` (restores the previous on exit)."""
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
