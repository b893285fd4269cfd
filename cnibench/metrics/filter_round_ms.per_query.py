"""filter_round_ms.per_query: the window's filter-round dispatches, each
counted once (the service mirrors one ``service.filter_round`` span into
every member request), over the queries returned in the window."""

from cnib.spans import named


def read(r):
    rounds = {(s.start_ns, s.end_ns) for s in named(r.spans, "service.filter_round")}
    if not rounds or not r.completed:
        return None
    return sum(e - s for s, e in rounds) * 1e-6 / len(r.completed)
