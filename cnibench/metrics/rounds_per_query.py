"""rounds_per_query: the ``rounds`` attribute of each completed query's
``service.finalize`` span (its own filter rounds), averaged."""

from cnib.spans import finalizes, mean


def read(r):
    return mean(s.attrs["rounds"] for s in finalizes(r) if "rounds" in s.attrs)
