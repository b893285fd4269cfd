"""join_stage_ms.per_query: the sum of each completed query's ``enum.stage``
spans (a level's candidate ids, constraints and their uploads, the
edge-label matrix's on the first), averaged."""

from cnib.descent import per_query
from cnib.spans import ms


def read(r):
    return per_query(r, {"enum.stage"}, ms)
