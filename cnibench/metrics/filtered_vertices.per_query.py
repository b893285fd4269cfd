"""filtered_vertices.per_query: ``n_alive`` of each completed query's
``query.compact`` span, the vertex count N left by the filter (0 where the
filter left none), averaged."""

from cnib.descent import per_query


def read(r):
    return per_query(r, {"query.compact"}, lambda s: s.attrs.get("n_alive", 0))
