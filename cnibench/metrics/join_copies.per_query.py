"""join_copies.per_query: the ``copies`` counters of each completed query's
join spans (the host<->device copies the join issued inside each), summed,
averaged; None when no span carries the counter, as in a program that does
not count them."""

from cnib.descent import per_query

JOIN_SPANS = {"enum.build", "enum.stage", "enum.count", "enum.scan",
              "enum.emit", "enum.assemble"}


def read(r):
    if not any("copies" in s.attrs for s in r.spans if s.name in JOIN_SPANS):
        return None
    return per_query(r, JOIN_SPANS, lambda s: s.attrs.get("copies", 0))
