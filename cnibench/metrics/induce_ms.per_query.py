"""induce_ms.per_query: the ``query.compact`` span (``induced_subgraph`` and
the candidate rows of the survivors) of each completed query, averaged."""

from cnib.descent import per_query
from cnib.spans import ms


def read(r):
    return per_query(r, {"query.compact"}, ms)
