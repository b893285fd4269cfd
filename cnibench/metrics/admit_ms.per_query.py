"""admit_ms.per_query: mean ``service.admit`` span (host ords over all V,
the slot's rows written) over the queries admitted in the window."""

from cnib.spans import mean, ms, named


def read(r):
    return mean(ms(s) for s in named(r.spans, "service.admit"))
