"""device_idle_pct: the share of the profiled stretch of the window in
which no operation ran on the device (1 - union of busy intervals / wall)."""

from cnib.profiling import busy_seconds


def read(r):
    p = r.profile
    if p is None or not p.events or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_seconds(p) / p.window_s)
