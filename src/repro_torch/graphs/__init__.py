from repro_torch.graphs.convert import graph_from_numpy
from repro_torch.graphs.csr import (
    Graph,
    PaddedGraph,
    adjacency_bitmap,
    as_numpy,
    build_graph,
    edge_label_lookup,
    graph_to,
    induced_subgraph,
    max_degree,
    symmetrize,
    to_host,
    to_padded,
)
from repro_torch.graphs.datasets import PAPER_DATASETS, paper_dataset
from repro_torch.graphs.io import (
    ChunkDirWriter,
    ChunkIOError,
    iter_update_batches,
    load_manifest,
    read_chunk,
    read_edge_file,
    stream_edge_chunks,
    write_chunk_dir,
    write_edge_file,
)
from repro_torch.graphs.generators import (
    power_law_graph,
    random_labeled_graph,
    random_update_batches,
    random_walk_query,
)
from repro_torch.graphs.ooc import ChunkCache, OocSnapshot, OutOfCoreGraphStore
from repro_torch.graphs.store import (
    ApplyResult,
    EdgeBatch,
    GraphSnapshot,
    GraphStore,
    ShardedGraphStore,
    ShardStats,
    StoreStats,
    as_snapshot,
    make_edge_batch,
)

__all__ = [
    "ApplyResult", "ChunkCache", "ChunkDirWriter", "ChunkIOError",
    "EdgeBatch", "Graph", "GraphSnapshot", "GraphStore", "OocSnapshot",
    "OutOfCoreGraphStore", "PAPER_DATASETS", "PaddedGraph", "ShardStats",
    "ShardedGraphStore", "StoreStats", "adjacency_bitmap", "as_numpy",
    "as_snapshot", "build_graph", "edge_label_lookup", "graph_from_numpy",
    "graph_to", "induced_subgraph", "iter_update_batches",
    "load_manifest", "make_edge_batch", "max_degree", "paper_dataset",
    "power_law_graph", "random_labeled_graph", "random_update_batches",
    "random_walk_query", "read_chunk", "read_edge_file", "stream_edge_chunks",
    "symmetrize", "to_host", "to_padded", "write_chunk_dir", "write_edge_file",
]
