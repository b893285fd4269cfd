"""ords_ms.per_query: mean ``service.ords`` span (``prepare_padded_query``:
the host ords over all V) over every admission while the tracer is
installed, the window's and those of the queries in flight at its close:
the basis of ``admit_ms.per_query``."""

from cnib.spans import mean, ms, named


def read(r):
    return mean(ms(s) for s in named(r.spans, "service.ords"))
