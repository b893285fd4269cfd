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
    random_walk_query,
)

__all__ = [
    "Graph", "PAPER_DATASETS", "as_numpy", "build_graph", "graph_from_numpy",
    "graph_to", "induced_subgraph", "max_degree", "paper_dataset",
    "power_law_graph", "random_labeled_graph", "random_walk_query",
    "symmetrize", "to_host",
]
