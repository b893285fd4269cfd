"""compact_ms.per_query: self time of ``service.finalize`` outside its
``query.enumerate`` child (``search_filtered``'s compaction and id remap),
averaged over the completed queries."""

from cnib.spans import children_by_parent, finalizes, mean, ms


def read(r):
    enum = children_by_parent(r.spans, "query.enumerate")
    return mean(ms(f) - sum(ms(c) for c in enum.get(f.span_id, []))
                for f in finalizes(r))
