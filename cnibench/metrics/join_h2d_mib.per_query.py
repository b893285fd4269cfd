"""join_h2d_mib.per_query: the ``h2d_bytes`` counters of each completed
query's ``enum.build`` and ``enum.stage`` spans (every tensor the join
uploads), summed, in MiB, averaged."""

from cnib.descent import per_query


def read(r):
    return per_query(r, {"enum.build", "enum.stage"},
                     lambda s: s.attrs.get("h2d_bytes", 0) / 2**20)
