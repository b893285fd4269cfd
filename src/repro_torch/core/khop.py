"""k-hop CNI extension (the paper's Appendix C, Lemmas 7-8), port of
``repro.core.khop``.

``cni_k(v)`` applies the same bijection to the labels of vertices at
shortest-path distance exactly k from v, found with dense boolean matrix
powers on the small post-filter graph.  The products run in float32: CUDA
has no integer matmul, and float32 is exact here because every count is at
most V <= search_vertex_cap = 8192 < 2^24.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import filters as flt
from repro_torch.core.cni import SAT64, default_max_p
from repro_torch.core.labels import build_label_map, ord_of
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, graph_to


def dense_adjacency(g: Graph) -> torch.Tensor:
    n = g.n_vertices
    a = torch.zeros((n, n), dtype=torch.bool, device=g.src.device)
    a[g.src, g.dst] = True
    return a


def khop_counts(adj: torch.Tensor, ords: torch.Tensor, k: int,
                n_labels: int) -> torch.Tensor:
    """(V, L) int32 label counts of the exactly-k-hop frontier, ∀ vertices."""
    n = adj.shape[0]
    adj_f = adj.to(torch.float32)
    visited = torch.eye(n, dtype=torch.bool, device=adj.device) | adj
    frontier = adj
    for _ in range(k - 1):
        nxt = (frontier.to(torch.float32) @ adj_f) > 0
        frontier = nxt & ~visited
        visited = visited | frontier
    onehot = torch.nn.functional.one_hot(
        (ords.to(torch.int64) - 1).clamp_min(0), n_labels
    ).to(torch.float32)
    onehot = onehot * (ords > 0)[:, None]
    return (frontier.to(torch.float32) @ onehot).to(torch.int32)


def khop_digests(g: Graph, query: Graph, k: int, d_max_k: int):
    """Hop-k digests for data and query sides (shared label map)."""
    label_map = build_label_map(query)
    L = label_map.n_labels
    max_p = default_max_p(d_max_k, L)
    ords_d = ord_of(label_map, g.vlabels)
    ords_q = ord_of(label_map, query.vlabels)
    cnt_d = khop_counts(dense_adjacency(g), ords_d, k, L)
    cnt_q = khop_counts(dense_adjacency(query), ords_q, k, L)
    return (flt.make_digest(cnt_d, ords_d, d_max_k, max_p),
            flt.make_digest(cnt_q, ords_q, d_max_k, max_p))


def khop_match(g: Graph, query: Graph, k: int, *,
               d_max_k: int | None = None) -> torch.Tensor:
    """(V, U) bool — hop-k degree + CNI_k filters (Lemmas 7-8).

    Label equality is the vertex's own label, already checked at 1 hop, so
    only the degree and CNI comparisons apply here.
    """
    if d_max_k is None:
        d_max_k = g.n_vertices  # frontier can touch every vertex
    dig_d, dig_q = khop_digests(g, query, k, d_max_k)
    dv, du = dig_d.deg[:, None], dig_q.deg[None, :]
    cv, cu = dig_d.cni[:, None], dig_q.cni[None, :]
    sat = (cv == SAT64) | (cu == SAT64)
    return ((dv > du) & ((cv >= cu) | sat)) | ((dv == du) & ((cv == cu) | sat))


def refine_candidates_khop(g: Graph, query: Graph, candidates, k_max: int = 2,
                           *, device=None) -> np.ndarray:
    """AND hop-2..k_max filters into an existing (V, U) candidate matrix."""
    dev = resolve_device(device)
    g = graph_to(g, dev)
    query = graph_to(query, dev)
    cand = torch.as_tensor(np.asarray(candidates), dtype=torch.bool, device=dev)
    for k in range(2, k_max + 1):
        cand = cand & khop_match(g, query, k)
    return cand.cpu().numpy()
