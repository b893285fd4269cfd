"""Random-walk queries (the paper's section 4.1), drawn for a whole pool at
once from a CSR built once on the device.

The rules follow ``graphs/generators.py::random_walk_query`` of the port,
rewritten here so that a change to the program cannot move the traffic:

* a walk starts at a vertex of positive degree, steps to a uniform
  neighbour and records each vertex the first time it reaches it, until the
  query has its size (or ``200 * size`` steps have passed);
* ``dense``: every data edge among the walked vertices;
* ``sparse``: the same, cut down to ``int(1.5 * n)`` edges when it has more:
  the spanning tree that a depth-first walk from query vertex 0 finds over
  the edges in order, then extra edges in an order shuffled from the seed;
* labels are the data vertices' and edges' own, so the walk itself is an
  embedding (``Query.planted``) and every query has at least one.

All walks of the pool step together on the device, one small host read a
step; only the per-query trimming runs on the host.  The pool's sizes are
the traffic's ``sizes`` repeated in equal numbers and shuffled from the
seed, so every seed draws the same amount of each size.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Query(NamedTuple):
    vlabels: np.ndarray   # (n,) int32
    edges: np.ndarray     # (k, 2) int64, i < j, in (i, j) order
    elabels: np.ndarray   # (k,) int32
    planted: np.ndarray   # (n,) int64: data vertex of each query vertex


def pool_sizes(sizes, n_queries: int, rng: np.random.Generator) -> np.ndarray:
    """``n_queries`` sizes, each of ``sizes`` as often as the others (up to
    one), in an order drawn from ``rng``."""
    sizes = np.asarray(sizes, dtype=np.int64)
    out = np.resize(sizes, n_queries)
    rng.shuffle(out)
    return out


def csr(src: torch.Tensor, n_vertices: int) -> torch.Tensor:
    """(V + 1,) int64 row offsets of a graph whose edges are sorted by src."""
    deg = torch.bincount(src, minlength=n_vertices)
    indptr = torch.zeros(n_vertices + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(deg, 0)
    return indptr


def draw_pool(graph: dict, shape: str, sizes, n_queries: int,
              seed: int) -> list[Query]:
    """``n_queries`` random-walk queries of ``shape`` ("dense" or "sparse")
    over ``graph`` (the generator's dict of tensors)."""
    if shape not in ("dense", "sparse"):
        raise ValueError(f"query shape must be 'dense' or 'sparse', got {shape!r}")
    rng = np.random.default_rng(seed)
    target_np = pool_sizes(sizes, n_queries, rng)
    src, dst = graph["src"], graph["dst"]
    dev = src.device
    n = int(graph["vlabels"].shape[0])
    indptr = csr(src, n)
    deg = indptr[1:] - indptr[:-1]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(0, 2**62)))

    live = torch.nonzero(deg > 0).flatten()
    if live.numel() == 0:
        raise ValueError("graph has no edges")
    n_max = int(target_np.max())
    target = torch.as_tensor(target_np, device=dev)
    cur = live[torch.randint(0, live.numel(), (n_queries,), generator=gen,
                             device=dev)]
    visited = torch.full((n_queries, n_max), -1, dtype=torch.int64, device=dev)
    visited[:, 0] = cur
    count = torch.ones(n_queries, dtype=torch.int64, device=dev)
    rows = torch.arange(n_queries, device=dev)
    for _ in range(200 * n_max):
        active = count < target
        if not bool(active.any()):
            break
        d = deg[cur]
        off = (torch.rand(n_queries, generator=gen, device=dev) * d).long()
        nxt = dst[indptr[cur] + torch.minimum(off, d - 1)]
        new = active & ~(visited == nxt[:, None]).any(1)
        visited[rows[new], count[new]] = nxt[new]
        count += new.long()
        cur = torch.where(active, nxt, cur)

    # every pair of walked vertices, looked up among the sorted edge keys
    keys = src * n + dst
    i_idx, j_idx = torch.triu_indices(n_max, n_max, 1, device=dev)
    a, b = visited[:, i_idx], visited[:, j_idx]
    valid = (a >= 0) & (b >= 0)
    probe = a.clamp_min(0) * n + b.clamp_min(0)
    pos = torch.searchsorted(keys, probe).clamp_max(keys.numel() - 1)
    is_edge = valid & (keys[pos] == probe)
    elab = graph["elabels"][pos]
    del keys, probe, pos

    vis = visited.cpu().numpy()
    cnt = count.cpu().numpy()
    is_edge = is_edge.cpu().numpy()
    elab = elab.cpu().numpy()
    vlab = graph["vlabels"][visited.clamp_min(0)].cpu().numpy()
    pairs = np.stack([i_idx.cpu().numpy(), j_idx.cpu().numpy()], 1)
    out = []
    for q in range(n_queries):
        k = int(cnt[q])
        sel = is_edge[q]
        edges, el = pairs[sel], elab[q][sel].astype(np.int32)
        if shape == "sparse":
            edges, el = _sparse_skeleton(edges, el, k, rng)
        out.append(Query(vlabels=vlab[q, :k].astype(np.int32), edges=edges,
                         elabels=el, planted=vis[q, :k].astype(np.int64)))
    return out


def _sparse_skeleton(edges: np.ndarray, elabels: np.ndarray, n: int,
                     rng: np.random.Generator):
    """Keep a spanning tree (depth-first from vertex 0 over the edges in
    order) plus shuffled extras, up to ``int(1.5 * n)`` edges."""
    target = int(1.5 * n)
    if edges.shape[0] <= target:
        return edges, elabels
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for idx, (a, b) in enumerate(edges):
        adj[a].append((int(b), idx))
        adj[b].append((int(a), idx))
    seen, tree, stack = {0}, [], [0]
    while stack:
        v = stack.pop()
        for w, idx in adj[v]:
            if w not in seen:
                seen.add(w)
                tree.append(idx)
                stack.append(w)
    in_tree = set(tree)
    extra = [i for i in range(edges.shape[0]) if i not in in_tree]
    rng.shuffle(extra)
    keep = np.array(sorted(tree + extra[: max(0, target - len(tree))]),
                    dtype=np.int64)
    return edges[keep], elabels[keep]
