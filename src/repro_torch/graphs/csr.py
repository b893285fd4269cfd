"""Edge-list graphs as tensors (port of ``repro.graphs.csr``).

``Graph`` holds both directions of every undirected edge, so each
per-vertex neighbourhood reduction is one scatter over ``src``.  On the
device the fields are tensors: ``vlabels``/``elabels`` int32 and
``src``/``dst`` int64, the index dtype PyTorch's gathers and scatters take.
``to_host`` and ``induced_subgraph`` return numpy-backed graphs for the
host-side search stages, as the reference does.

``PaddedGraph`` is the dense form of a small graph: (V, D) int32 neighbour
and edge-label tables padded with -1; ``to_padded`` builds it on the host
and ``adjacency_bitmap`` packs the adjacency into (V, ceil(V / 32)) uint32
words.  No path of the port calls them; they are the reference's public
helpers, with its fields and dtypes.
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


class PaddedGraph(NamedTuple):
    """Dense neighbour-table form; pad value -1."""

    vlabels: torch.Tensor      # (V,) int32
    nbr: torch.Tensor          # (V, D) int32, -1 padded
    nbr_elabels: torch.Tensor  # (V, D) int32, -1 padded
    deg: torch.Tensor          # (V,) int32

    @property
    def n_vertices(self) -> int:
        return int(self.vlabels.shape[0])

    @property
    def max_degree(self) -> int:
        return int(self.nbr.shape[1])


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


def _graph_device(g: Graph, device):
    """``device`` if given, else the device of ``g``'s tensors (CUDA for a
    numpy-backed graph)."""
    if device is None and isinstance(g.src, torch.Tensor):
        return g.src.device
    return resolve_device(device)


def to_padded(g: Graph, d_max: int | None = None, *,
              device=None) -> PaddedGraph:
    """(V, D) neighbour tables, built on the host: D is the largest degree
    (1 for a graph without edges), raised to ``d_max`` when that is larger;
    each vertex's neighbours in edge-list order.  The tables go to
    ``device`` (by default the graph's)."""
    dev = _graph_device(g, device)
    n = g.n_vertices
    src, dst, elab = (as_numpy(x) for x in (g.src, g.dst, g.elabels))
    deg = np.bincount(src, minlength=n)
    d = int(deg.max()) if deg.size and deg.max() > 0 else 1
    if d_max is not None:
        d = max(d, d_max)
    nbr = np.full((n, d), -1, dtype=np.int32)
    nbe = np.full((n, d), -1, dtype=np.int32)
    # slot of each directed edge among its source's edges, in table order
    order = np.argsort(src, kind="stable")
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    slot = np.empty(src.size, dtype=np.int64)
    slot[order] = np.arange(src.size) - starts[src[order]]
    nbr[src, slot] = dst
    nbe[src, slot] = elab
    return PaddedGraph(*(torch.as_tensor(a, device=dev) for a in (
        as_numpy(g.vlabels).astype(np.int32), nbr, nbe, deg.astype(np.int32))))


def adjacency_bitmap(g: Graph, *, device=None) -> torch.Tensor:
    """Bit-packed adjacency, (V, ceil(V / 32)) uint32 (at least one word):
    bit ``w % 32`` of word ``w // 32`` of row ``v`` is set iff edge (v, w).
    Built on the host, on ``device`` (by default the graph's)."""
    n = g.n_vertices
    bits = np.zeros((n, max(1, (n + 31) // 32)), dtype=np.uint32)
    src, dst = as_numpy(g.src).astype(np.int64), as_numpy(g.dst).astype(np.int64)
    np.bitwise_or.at(bits, (src, dst // 32),
                     np.uint32(1) << (dst % 32).astype(np.uint32))
    return torch.as_tensor(bits, device=_graph_device(g, device))


def edge_label_lookup(g: Graph) -> dict[tuple[int, int], int]:
    """Host dict (u, v) -> edge label (both directions present)."""
    src, dst, elab = (as_numpy(x) for x in (g.src, g.dst, g.elabels))
    return {(int(s), int(t)): int(e) for s, t, e in zip(src, dst, elab)}
