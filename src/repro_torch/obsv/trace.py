"""Lightweight in-process tracing: monotonic-clock span trees per query
(the port's copy of ``repro.obsv.trace``, with the same span taxonomy).

One ``Tracer`` owns a flat list of finished ``Span`` records plus an
implicit *stack* of open spans (the engine, service, and store layers are
single-threaded per process — continuation is lexical, so an explicit
context object would buy nothing).  A span opened while the stack is empty
starts a fresh **trace** (``trace_id``): the service opens one root span
per request, so every query's queue-wait → admit → filter → plan →
enumerate → chunk-fetch breakdown lands in a single trace, exportable as
Chrome/Perfetto ``traceEvents`` JSON (``to_chrome_trace`` /
``write_chrome_trace`` — load the file in https://ui.perfetto.dev or
``chrome://tracing``).

**Disabled tracing is free.**  Instrumented code calls the module-level
``span(...)`` helper, which returns one shared no-op context-manager
singleton whenever no tracer is installed — no allocation, no clock read,
no branch beyond one global check.  Install a tracer for a scope with::

    from repro_torch import obsv
    with obsv.tracing() as tracer:
        engine.query(q)
    tracer.write_chrome_trace("trace.json")

All timestamps come from ``time.perf_counter_ns()`` (monotonic);
``span_at`` backfills *retroactive* spans (e.g. queue wait measured from a
``time.perf_counter()`` submission stamp — same clock, float seconds).

While a tracer is installed, a ``gc.callbacks`` hook records each garbage
collection as a ``runtime.gc`` span under whatever span is open; clearing
the tracer removes the hook.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import time


class Span:
    """One timed node of a trace tree.  ``end_ns`` is None while open."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id",
                 "start_ns", "end_ns", "attrs")

    def __init__(self, name: str, trace_id: int, span_id: int,
                 parent_id: int | None, start_ns: int,
                 attrs: dict | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = start_ns
        self.end_ns: int | None = None
        self.attrs = attrs or {}

    @property
    def closed(self) -> bool:
        return self.end_ns is not None

    @property
    def duration_ns(self) -> int:
        if self.end_ns is None:
            raise ValueError(f"span {self.name!r} is still open")
        return self.end_ns - self.start_ns

    def set_attrs(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __repr__(self) -> str:  # debugging / pytest -l readability
        state = "closed" if self.closed else "OPEN"
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id}, {state})")


class _NoopSpan:
    """Shared do-nothing span/context-manager for disabled tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attrs(self, **attrs):
        pass


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Collects span trees; one instance per tracing scope (not thread-safe)."""

    def __init__(self):
        self.spans: list[Span] = []   # finished, in completion order
        self._stack: list[Span] = []  # open, root → leaf
        self._span_ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self._gc_start: float | None = None  # perf_counter() of a running collection

    # -- span lifecycle ------------------------------------------------------

    def start_span(self, name: str, *, parent: Span | None = None,
                   detached: bool = False, **attrs) -> Span:
        """Open a span under ``parent`` (default: current stack top).

        ``detached=True`` keeps the span *off* the implicit stack: the
        caller holds it open across unrelated work (a service request
        root living across ticks) and re-enters it with ``activate``.
        A span with no parent starts a new trace.
        """
        if parent is None and not detached and self._stack:
            parent = self._stack[-1]
        # the ids are drawn before the allocations below: a collection that
        # one of them triggers records its ``runtime.gc`` span in between
        span_id = next(self._span_ids)
        if parent is None:
            trace_id = next(self._trace_ids)
            parent_id = None
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
        s = Span(name, trace_id, span_id, parent_id, time.perf_counter_ns(),
                 dict(attrs) if attrs else None)
        if not detached:
            self._stack.append(s)
        return s

    def end_span(self, span: Span) -> None:
        if span.closed:
            raise ValueError(f"span {span.name!r} already ended")
        span.end_ns = time.perf_counter_ns()
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        elif span in self._stack:  # tolerate out-of-order ends
            self._stack.remove(span)
        self.spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        s = self.start_span(name, **attrs)
        try:
            yield s
        finally:
            self.end_span(s)

    def span_at(self, name: str, start_s: float, end_s: float, *,
                parent: Span | None = None, **attrs) -> Span:
        """Record an already-elapsed span from ``perf_counter()`` stamps."""
        if parent is None and self._stack:
            parent = self._stack[-1]
        s = self.start_span(name, parent=parent, detached=True, **attrs)
        s.start_ns = int(start_s * 1e9)
        s.end_ns = int(end_s * 1e9)
        self.spans.append(s)
        return s

    @contextlib.contextmanager
    def activate(self, span: Span):
        """Temporarily make a detached open span the nesting parent."""
        self._stack.append(span)
        try:
            yield span
        finally:
            if self._stack and self._stack[-1] is span:
                self._stack.pop()
            elif span in self._stack:
                self._stack.remove(span)

    # -- inspection ----------------------------------------------------------

    @property
    def open_spans(self) -> list[Span]:
        return list(self._stack)

    def trace_ids(self) -> list[int]:
        seen: dict[int, None] = {}
        for s in self.spans:
            seen.setdefault(s.trace_id, None)
        return list(seen)

    def roots(self) -> list[Span]:
        return [s for s in self.spans if s.parent_id is None]

    def children_of(self, span: Span) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def names(self) -> set[str]:
        return {s.name for s in self.spans}

    # -- export --------------------------------------------------------------

    def to_chrome_trace(self) -> dict:
        """Chrome/Perfetto JSON object format: complete ("X") events.

        Each trace becomes a Perfetto *process* (``pid`` = trace id) so
        the viewer groups every query's spans under its own track.
        """
        events = []
        for s in self.spans:
            if not s.closed:
                continue
            args = {"span_id": s.span_id, "parent_id": s.parent_id}
            for k, v in s.attrs.items():
                args[k] = v if isinstance(v, (int, float, bool, str,
                                              type(None))) else repr(v)
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": s.start_ns / 1e3,    # microseconds
                "dur": s.duration_ns / 1e3,
                "pid": s.trace_id,
                "tid": 0,
                "cat": s.name.split(".", 1)[0],
                "args": args,
            })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_chrome_trace(), fh)


# ---------------------------------------------------------------------------
# Module-level active tracer: the hook instrumented code calls.
# ---------------------------------------------------------------------------

_ACTIVE: Tracer | None = None


def _gc_hook(phase: str, info: dict) -> None:
    """``gc.callbacks`` entry: a collection's start and stop become one
    ``runtime.gc`` span of the active tracer."""
    tracer = _ACTIVE
    if tracer is None:
        return
    if phase == "start":
        tracer._gc_start = time.perf_counter()
    elif tracer._gc_start is not None:
        tracer.span_at("runtime.gc", tracer._gc_start, time.perf_counter())
        tracer._gc_start = None


def set_tracer(tracer: Tracer | None) -> Tracer | None:
    """Install (or clear) the process-global tracer; returns the previous.

    The garbage collector's hook is in ``gc.callbacks`` only while a tracer
    is installed."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = tracer
    if tracer is None:
        if _gc_hook in gc.callbacks:
            gc.callbacks.remove(_gc_hook)
    elif _gc_hook not in gc.callbacks:
        gc.callbacks.append(_gc_hook)
    return prev


def get_tracer() -> Tracer | None:
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def span(name: str, **attrs):
    """Context manager for one span of the active tracer; free when off."""
    if _ACTIVE is None:
        return NOOP_SPAN
    return _ACTIVE.span(name, **attrs)


def span_at(name: str, start_s: float, end_s: float, *,
            parent: Span | None = None, **attrs) -> Span | None:
    if _ACTIVE is None:
        return None
    return _ACTIVE.span_at(name, start_s, end_s, parent=parent, **attrs)


def start_detached(name: str, **attrs) -> Span | None:
    if _ACTIVE is None:
        return None
    return _ACTIVE.start_span(name, detached=True, **attrs)


def activate(span_obj: Span | None):
    """Nest subsequent spans under a detached span (no-op when disabled)."""
    if _ACTIVE is None or span_obj is None:
        return contextlib.nullcontext(span_obj)
    return _ACTIVE.activate(span_obj)


def end(span_obj: Span | None) -> None:
    if _ACTIVE is not None and span_obj is not None:
        _ACTIVE.end_span(span_obj)


@contextlib.contextmanager
def tracing():
    """Scope with a fresh active ``Tracer`` (restores the previous on exit)."""
    tracer = Tracer()
    prev = set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)
