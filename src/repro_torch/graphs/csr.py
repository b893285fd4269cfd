"""Edge-list graphs as tensors (port of ``repro.graphs.csr``).

``Graph`` holds both directions of every undirected edge, so each
per-vertex neighbourhood reduction is one scatter over ``src``.  On the
device the fields are tensors: ``vlabels``/``elabels`` int32 and
``src``/``dst`` int64, the index dtype PyTorch's gathers and scatters take.
``to_host`` and ``induced_subgraph`` return numpy-backed graphs for the
host-side search stages, as the reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class Graph(NamedTuple):
    """Undirected vertex- and edge-labelled graph, symmetrized edge list."""

    vlabels: torch.Tensor  # (V,) int32 raw vertex labels
    src: torch.Tensor      # (2E,) int64
    dst: torch.Tensor      # (2E,) int64
    elabels: torch.Tensor  # (2E,) int32 raw edge labels

    @property
    def n_vertices(self) -> int:
        return int(self.vlabels.shape[0])

    @property
    def n_directed_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_edges(self) -> int:
        return self.n_directed_edges // 2


def as_numpy(x) -> np.ndarray:
    """Host numpy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def graph_to(g: Graph, device) -> Graph:
    """The same graph with tensor fields on ``device`` (dtypes as above)."""
    dev = resolve_device(device)

    def put(x, dtype):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dtype)
        return torch.tensor(np.asarray(x), dtype=dtype, device=dev)

    return Graph(
        vlabels=put(g.vlabels, torch.int32),
        src=put(g.src, torch.int64),
        dst=put(g.dst, torch.int64),
        elabels=put(g.elabels, torch.int32),
    )


def symmetrize(edges: np.ndarray, elabels: np.ndarray):
    """(E,2) undirected edges -> both-direction arrays, deduplicated."""
    edges = np.asarray(edges, dtype=np.int64)
    elabels = np.asarray(elabels, dtype=np.int64)
    # canonicalize + dedup undirected edges, drop self loops
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    keep = lo != hi
    lo, hi, elabels = lo[keep], hi[keep], elabels[keep]
    key = lo.astype(np.int64) * (hi.max() + 1 if hi.size else 1) + hi
    _, first = np.unique(key, return_index=True)
    lo, hi, elabels = lo[first], hi[first], elabels[first]
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    elab = np.concatenate([elabels, elabels])
    order = np.argsort(src, kind="stable")
    return src[order], dst[order], elab[order]


def build_graph(n_vertices: int, vlabels, edges, elabels=None, *,
                device=None) -> Graph:
    """Build a ``Graph`` on ``device`` from host arrays; symmetrizes and
    dedups edges exactly as the reference does."""
    vlabels = np.asarray(vlabels, dtype=np.int32)
    if vlabels.shape != (n_vertices,):
        raise ValueError(
            f"vlabels has shape {vlabels.shape}, expected ({n_vertices},)"
        )
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if elabels is None:
        elabels = np.zeros(edges.shape[0], dtype=np.int64)
    src, dst, elab = symmetrize(edges, elabels)
    return graph_to(Graph(vlabels, src, dst, elab), device)


def max_degree(g: Graph) -> int:
    if g.n_directed_edges == 0:
        return 0
    if isinstance(g.src, torch.Tensor):
        return int(torch.bincount(g.src, minlength=g.n_vertices).max())
    return int(np.bincount(np.asarray(g.src), minlength=g.n_vertices).max())


def to_host(g: Graph) -> Graph:
    """Numpy-backed copy of a graph (one device-to-host copy per field)."""
    return Graph(*(as_numpy(x) for x in g))


def induced_subgraph(g: Graph, keep_mask) -> tuple[Graph, np.ndarray]:
    """Induced subgraph on ``keep_mask`` vertices, numpy-backed.

    Returns (subgraph, old_ids) where ``old_ids[new_id] = old vertex id``.
    """
    keep = as_numpy(keep_mask).astype(bool)
    old_ids = np.nonzero(keep)[0]
    remap = -np.ones(g.n_vertices, dtype=np.int64)
    remap[old_ids] = np.arange(old_ids.size)
    src = as_numpy(g.src)
    dst = as_numpy(g.dst)
    elab = as_numpy(g.elabels)
    emask = keep[src] & keep[dst]
    sub = Graph(
        vlabels=as_numpy(g.vlabels)[old_ids].astype(np.int32),
        src=remap[src[emask]].astype(np.int32),
        dst=remap[dst[emask]].astype(np.int32),
        elabels=elab[emask].astype(np.int32),
    )
    return sub, old_ids
