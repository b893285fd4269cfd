from repro_torch.graphs.convert import graph_from_numpy
from repro_torch.graphs.csr import (
    Graph,
    as_numpy,
    build_graph,
    graph_to,
    induced_subgraph,
    max_degree,
    symmetrize,
    to_host,
)
from repro_torch.graphs.datasets import PAPER_DATASETS, paper_dataset
from repro_torch.graphs.generators import (
    power_law_graph,
    random_labeled_graph,
    random_update_batches,
    random_walk_query,
)
from repro_torch.graphs.store import (
    ApplyResult,
    EdgeBatch,
    GraphSnapshot,
    GraphStore,
    ShardedGraphStore,
    StoreStats,
    as_snapshot,
    make_edge_batch,
)

__all__ = [
    "ApplyResult", "EdgeBatch", "Graph", "GraphSnapshot", "GraphStore",
    "PAPER_DATASETS", "ShardedGraphStore", "StoreStats", "as_numpy",
    "as_snapshot", "build_graph", "graph_from_numpy", "graph_to",
    "induced_subgraph", "make_edge_batch", "max_degree", "paper_dataset",
    "power_law_graph", "random_labeled_graph", "random_update_batches",
    "random_walk_query", "symmetrize", "to_host",
]
