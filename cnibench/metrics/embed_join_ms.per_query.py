"""embed_join_ms.per_query: device time of the ``embed_join`` count, grid
and emit kernels in the profiled stretch, over the queries returned in it."""

KERNELS = ("embed_join_rows_kernel", "embed_join_emit_kernel")  # in the trace's names


def read(r):
    p = r.profile
    if p is None:
        return None
    spent = sum(ev.end - ev.start for ev in p.events
                if any(k in ev.name for k in KERNELS))
    done = sum(1 for c in r.completed if p.t0 <= c.t_done <= p.t1)
    if spent <= 0 or not done:
        return None
    return spent * 1e3 / done
