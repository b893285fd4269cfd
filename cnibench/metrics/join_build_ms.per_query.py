"""join_build_ms.per_query: the ``enum.build`` span (query adjacency, the
(N, N) edge-label matrix, matching order, seed table upload) under each
completed query's ``service.finalize``, averaged."""

from cnib.descent import per_query
from cnib.spans import ms


def read(r):
    return per_query(r, {"enum.build"}, ms)
