"""join_levels.per_query: ``EnumReport.levels`` of each completed query's
``stats.extras["enum"]``, averaged (a count)."""

from cnib.spans import mean


def read(r):
    return mean(c.levels for c in r.completed if c.levels is not None)
