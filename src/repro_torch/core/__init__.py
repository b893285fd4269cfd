"""CNI encoding, ILGF filtering and search, ported to PyTorch."""

from repro_torch.core.batch_engine import BatchQueryEngine, batched_ilgf_round
from repro_torch.core.cni import (
    SAT64,
    cni_from_counts,
    cni_log_from_counts,
    default_max_p,
)
from repro_torch.core.engine import QueryStats, SubgraphQueryEngine, search_filtered
from repro_torch.core.ilgf import IlgfResult, ilgf, one_shot_filter
from repro_torch.core.search import (
    bfs_join_search,
    device_join_search,
    embeddings_equal,
    empty_enum_report,
    greedy_matching_order,
    host_dfs_search,
)

__all__ = [
    "SAT64", "BatchQueryEngine", "IlgfResult", "QueryStats",
    "SubgraphQueryEngine", "batched_ilgf_round", "bfs_join_search",
    "cni_from_counts", "cni_log_from_counts", "default_max_p",
    "device_join_search", "embeddings_equal", "empty_enum_report",
    "greedy_matching_order", "host_dfs_search", "ilgf", "one_shot_filter",
    "search_filtered",
]
