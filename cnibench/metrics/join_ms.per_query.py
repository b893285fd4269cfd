"""join_ms.per_query: the ``query.enumerate`` span (the device join:
count, scan and emit, level by level) of each completed query, averaged."""

from cnib.spans import children_by_parent, finalizes, mean, ms


def read(r):
    enum = children_by_parent(r.spans, "query.enumerate")
    return mean(sum(ms(c) for c in enum.get(f.span_id, [])) for f in finalizes(r))
