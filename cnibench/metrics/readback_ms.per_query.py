"""readback_ms.per_query: the ``service.readback`` span (the alive row and
candidate columns copied to the host) of each query completed in the
window, found by its ``rid``, averaged."""

from cnib.spans import mean, ms, named


def read(r):
    done = {c.rid for c in r.completed}
    return mean(ms(s) for s in named(r.spans, "service.readback")
                if s.attrs.get("rid") in done)
