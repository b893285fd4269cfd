"""Device activity from ``torch.profiler``, and the arithmetic on it: the
union of busy intervals, the operations that took most time, and the idle
gaps, each labelled by the innermost program span open at that moment.

The profiler's clock is tied to the host's ``perf_counter`` by an anchor:
a ``record_function`` entered at a known host time.  Every device interval
is then in host seconds, the clock of the program's spans.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import NamedTuple

import torch

ANCHOR = "cnibench.anchor"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160


class DeviceEvent(NamedTuple):
    name: str
    start: float  # host perf_counter seconds
    end: float


class Profile(NamedTuple):
    t0: float                   # the traced window, host seconds
    t1: float
    events: list                # DeviceEvent, clipped to the window

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


class Recorder:
    """Starts and stops ``torch.profiler`` around a stretch of a run."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.prof = None
        self.t0 = self.t1 = self.t_anchor = 0.0

    def warm_up(self) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the device tracer, which takes seconds."""
        self.start()
        if self.cuda:
            torch.ones(1, device="cuda").add_(1)
        self.stop()
        self.read()

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        with torch.profiler.record_function(ANCHOR):
            self.t_anchor = time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        """Stop recording; ``read`` turns the record into a ``Profile``
        later, outside the measured window."""
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def read(self) -> Profile:
        fd, path = tempfile.mkstemp(prefix="cnibench-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as fh:
                trace = json.load(fh)
        finally:
            os.unlink(path)
        self.prof = None
        return Profile(self.t0, self.t1, device_events(trace, self.t_anchor,
                                                       self.t0, self.t1))


def device_events(trace: dict, t_anchor: float, t0: float,
                  t1: float) -> list[DeviceEvent]:
    """The trace's device intervals in host seconds, clipped to [t0, t1]."""
    events = trace.get("traceEvents", [])
    anchors = [e for e in events if e.get("name") == ANCHOR and "ts" in e]
    if not anchors:
        raise RuntimeError("the profiler's trace lacks its anchor event")
    offset = t_anchor - min(float(e["ts"]) for e in anchors) * 1e-6
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start = float(e["ts"]) * 1e-6 + offset
        end = start + float(e.get("dur", 0.0)) * 1e-6
        start, end = max(start, t0), min(end, t1)
        if end > start:
            out.append(DeviceEvent(str(e.get("name", "?")), start, end))
    return out


def busy_intervals(events) -> list[tuple[float, float]]:
    """The union of the events' intervals, as sorted disjoint intervals."""
    merged: list[list[float]] = []
    for s, e in sorted((ev.start, ev.end) for ev in events):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(prof: Profile) -> float:
    return sum(e - s for s, e in busy_intervals(prof.events))


def top_ops(prof: Profile, n: int = 10) -> list[list]:
    """[[name, seconds], ...]: device time by operation name, largest first."""
    total: dict[str, float] = {}
    for ev in prof.events:
        total[ev.name] = total.get(ev.name, 0.0) + (ev.end - ev.start)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:NAME_CHARS], sec] for name, sec in ranked]


def idle_gaps(prof: Profile) -> list[tuple[float, float]]:
    """The stretches of the window in which nothing ran on the device."""
    gaps, at = [], prof.t0
    for s, e in busy_intervals(prof.events):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if prof.t1 > at:
        gaps.append((at, prof.t1))
    return gaps


def innermost_span(spans, t: float) -> str:
    """The name of the latest-opened span that covers host time ``t``."""
    best, best_start = "none", None
    for sp in spans:
        if sp.end_ns is None:
            continue
        s, e = sp.start_ns * 1e-9, sp.end_ns * 1e-9
        if s <= t <= e and (best_start is None or s >= best_start):
            best, best_start = sp.name, s
    return best


def labelled_gaps(prof: Profile, spans, n: int = 10) -> list[list]:
    """[[span name, seconds], ...]: the ``n`` longest idle gaps, each named
    by the innermost span open at its middle."""
    longest = sorted(idle_gaps(prof), key=lambda g: -(g[1] - g[0]))[:n]
    return [[innermost_span(spans, 0.5 * (s + e)), e - s] for s, e in longest]
