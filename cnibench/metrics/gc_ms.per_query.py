"""gc_ms.per_query: the garbage collector's pauses (``runtime.gc`` spans)
inside the window, summed, over the queries completed in it."""

from cnib.spans import named


def read(r):
    pauses = named(r.spans, "runtime.gc")
    if not pauses or not r.completed:
        return None
    t0, t1 = r.t_open * 1e9, r.t_close * 1e9
    spent = sum(max(0.0, min(s.end_ns, t1) - max(s.start_ns, t0)) for s in pauses)
    return spent * 1e-6 / len(r.completed)
