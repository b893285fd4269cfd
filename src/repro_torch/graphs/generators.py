"""Random labelled graphs and random-walk queries (port of
``repro.graphs.generators``).

The draws are the reference's numpy draws, call for call, so a seed gives
the same graph (and the same update batches) in both packages; only the
final ``Graph`` lives on the requested device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import Graph, as_numpy, build_graph
from repro_torch.graphs.store import EdgeBatch, GraphStore


def _draw_labels(rng: np.random.Generator, n: int, n_labels: int, dist: str):
    if dist == "uniform":
        return rng.integers(0, n_labels, size=n)
    if dist == "gaussian":
        # Normal distribution over the label alphabet, clipped (paper's "ig").
        raw = rng.normal(loc=n_labels / 2.0, scale=max(1.0, n_labels / 6.0), size=n)
        return np.clip(np.round(raw), 0, n_labels - 1).astype(np.int64)
    if dist == "zipf":
        ranks = rng.zipf(1.5, size=n)
        return np.minimum(ranks - 1, n_labels - 1).astype(np.int64)
    raise ValueError(f"unknown label distribution: {dist}")


def random_labeled_graph(
    n_vertices: int,
    n_edges: int,
    n_labels: int,
    *,
    n_edge_labels: int = 1,
    label_dist: str = "uniform",
    seed: int = 0,
    device=None,
) -> Graph:
    """Erdős–Rényi G(n, m) with labeled vertices and edges."""
    rng = np.random.default_rng(seed)
    vlabels = _draw_labels(rng, n_vertices, n_labels, label_dist)
    # sample edges with replacement then dedup inside build_graph
    src = rng.integers(0, n_vertices, size=int(n_edges * 1.15) + 8)
    dst = rng.integers(0, n_vertices, size=src.size)
    keep = src != dst
    edges = np.stack([src[keep], dst[keep]], axis=1)[:n_edges]
    elabels = rng.integers(0, max(1, n_edge_labels), size=edges.shape[0])
    return build_graph(n_vertices, vlabels, edges, elabels, device=device)


def power_law_graph(
    n_vertices: int,
    avg_degree: float,
    n_labels: int,
    *,
    n_edge_labels: int = 1,
    label_dist: str = "uniform",
    seed: int = 0,
    gamma: float = 2.5,
    device=None,
) -> Graph:
    """Configuration-model power-law graph (the paper's big-graph regime)."""
    rng = np.random.default_rng(seed)
    # degree sequence ~ Pareto(gamma-1), scaled to the requested average
    w = (1.0 - rng.random(n_vertices)) ** (-1.0 / (gamma - 1.0))
    w = w / w.mean() * avg_degree
    n_stubs = int(w.sum())
    stubs = rng.choice(n_vertices, size=n_stubs, p=w / w.sum())
    if stubs.size % 2:
        stubs = stubs[:-1]
    half = stubs.size // 2
    edges = np.stack([stubs[:half], stubs[half:]], axis=1)
    keep = edges[:, 0] != edges[:, 1]
    edges = edges[keep]
    vlabels = _draw_labels(rng, n_vertices, n_labels, label_dist)
    elabels = rng.integers(0, max(1, n_edge_labels), size=edges.shape[0])
    return build_graph(n_vertices, vlabels, edges, elabels, device=device)


def random_walk_query(
    g: Graph,
    n_query_vertices: int,
    *,
    sparse: bool = True,
    seed: int = 0,
    device=None,
) -> Graph:
    """Connected query subgraph via random walk on the data graph (§4.1).

    ``sparse=True`` keeps roughly tree-plus-a-few edges (avg degree <= 3);
    ``sparse=False`` takes the full induced subgraph on the walked vertices.
    Vertex/edge labels are inherited, so every query has >= 1 embedding.
    """
    rng = np.random.default_rng(seed)
    n = g.n_vertices
    src = as_numpy(g.src)
    dst = as_numpy(g.dst)
    elab = as_numpy(g.elabels)
    # build host CSR
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted, e_sorted = src[order], dst[order], elab[order]
    indptr = np.searchsorted(s_sorted, np.arange(n + 1))

    deg = np.diff(indptr)
    live = np.nonzero(deg > 0)[0]
    if live.size == 0:
        raise ValueError("graph has no edges")
    current = int(rng.choice(live))
    visited = [current]
    visited_set = {current}
    guard = 0
    while len(visited) < n_query_vertices and guard < 200 * n_query_vertices:
        guard += 1
        lo, hi = indptr[current], indptr[current + 1]
        if hi == lo:
            current = int(rng.choice(visited))
            continue
        nxt = int(d_sorted[rng.integers(lo, hi)])
        if nxt not in visited_set:
            visited.append(nxt)
            visited_set.add(nxt)
        current = nxt
    ids = np.array(visited[:n_query_vertices])
    remap = {int(v): i for i, v in enumerate(ids)}
    # collect induced edges
    q_edges, q_elabels = [], []
    for v in ids:
        for k in range(indptr[v], indptr[v + 1]):
            w = int(d_sorted[k])
            if w in remap and remap[int(v)] < remap[w]:
                q_edges.append((remap[int(v)], remap[w]))
                q_elabels.append(int(e_sorted[k]))
    q_edges = np.array(q_edges, dtype=np.int64).reshape(-1, 2)
    q_elabels = np.array(q_elabels, dtype=np.int64)
    if sparse and q_edges.shape[0] > 0:
        # keep a connected sparse skeleton: BFS tree edges + a few extras
        target = int(1.5 * len(ids))
        if q_edges.shape[0] > target:
            adj = {i: [] for i in range(len(ids))}
            for idx, (a, b) in enumerate(q_edges):
                adj[a].append((b, idx))
                adj[b].append((a, idx))
            seen = {0}
            keep_idx = []
            frontier = [0]
            while frontier:
                v = frontier.pop()
                for w, idx in adj[v]:
                    if w not in seen:
                        seen.add(w)
                        keep_idx.append(idx)
                        frontier.append(w)
            extra = [i for i in range(q_edges.shape[0]) if i not in set(keep_idx)]
            rng.shuffle(extra)
            keep_idx = keep_idx + extra[: max(0, target - len(keep_idx))]
            q_edges = q_edges[np.array(sorted(keep_idx), dtype=np.int64)]
            q_elabels = q_elabels[np.array(sorted(keep_idx), dtype=np.int64)]
    vlab = as_numpy(g.vlabels)[ids]
    return build_graph(len(ids), vlab, q_edges, q_elabels, device=device)


def random_update_batches(
    store_or_graph,
    n_batches: int,
    batch_edges: int,
    *,
    delete_frac: float = 0.3,
    n_edge_labels: int = 1,
    seed: int = 0,
) -> list[EdgeBatch]:
    """Random insert/delete batches against an existing edge set.

    Deletes are drawn from the edge set as the sequence is generated (each
    targets an edge alive at its point in the sequence), inserts are fresh
    random non-edges.  Every edge sits in a Python set, as in the
    reference, so this serves tests and small stores; a store's edges are
    read in table order, which the port keeps equal to the reference's.
    """
    rng = np.random.default_rng(seed)
    if isinstance(store_or_graph, GraphStore):
        n = store_or_graph.n_vertices
        src, dst, _ = store_or_graph.alive_edges()
    else:
        g = store_or_graph
        n = g.n_vertices
        s = as_numpy(g.src)
        d = as_numpy(g.dst)
        keep = s < d
        src, dst = s[keep].astype(np.int64), d[keep].astype(np.int64)
    present = {(int(a), int(b)) for a, b in zip(src, dst)}
    batches = []
    for _ in range(n_batches):
        n_del = int(round(batch_edges * delete_frac))
        n_ins = batch_edges - n_del
        recs: list[tuple[int, int, int, bool]] = []
        pool = list(present)
        rng.shuffle(pool)
        for lo, hi in pool[: min(n_del, len(pool))]:
            recs.append((lo, hi, 0, False))
            present.discard((lo, hi))
        guard = 0
        while n_ins > 0 and guard < 50 * batch_edges:
            guard += 1
            a, b = int(rng.integers(0, n)), int(rng.integers(0, n))
            lo, hi = min(a, b), max(a, b)
            if lo == hi or (lo, hi) in present:
                continue
            recs.append((lo, hi, int(rng.integers(0, max(1, n_edge_labels))),
                         True))
            present.add((lo, hi))
            n_ins -= 1
        rng.shuffle(recs)
        arr = np.asarray([r[:3] for r in recs], dtype=np.int64).reshape(-1, 3)
        batches.append(EdgeBatch(
            src=arr[:, 0],
            dst=arr[:, 1],
            elabels=arr[:, 2],
            insert=np.asarray([r[3] for r in recs], dtype=bool),
            valid=np.ones(len(recs), dtype=bool),
        ))
    return batches
