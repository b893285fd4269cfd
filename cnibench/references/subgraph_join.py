"""Plain reference for subgraph queries: every embedding of a query, by a
level-by-level join over label candidates, with edge lookups among the
sorted edge keys.  No CNI, no filter rounds, no compaction.

An embedding maps query vertices injectively onto data vertices of the
same label so that every query edge lands on a data edge of the same edge
label (subgraph isomorphism, not induced).  ``embeddings`` returns them all,
rows in the query's vertex order over the data graph's own ids, sorted.

It works in plain ``torch`` on whatever device the index lives on and
imports nothing of the program: it builds its own keys and offsets from the
benchmark's tensors and takes nothing the program made.

``drop_last_edges=True`` is the control: the last query vertex of the
order is matched to every vertex of its label without checking its edges,
which breaks the guarantee that query edges land on data edges.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

EXPAND_BLOCK = 1 << 23  # candidate cells expanded at once


class DataIndex(NamedTuple):
    n: int
    vlabels: torch.Tensor  # (V,) int32
    keys: torch.Tensor     # (2E,) int64 sorted src * n + dst
    dst: torch.Tensor      # (2E,) int64, in key order
    elabels: torch.Tensor  # (2E,) int32, in key order
    indptr: torch.Tensor   # (V + 1,) int64


def build_index(graph: dict, device) -> DataIndex:
    """The reference's own view of the generated graph, on ``device``."""
    vlabels = graph["vlabels"].to(device)
    src = graph["src"].to(device)
    dst = graph["dst"].to(device)
    n = int(vlabels.shape[0])
    keys, order = torch.sort(src * n + dst)
    src, dst = src[order], dst[order]
    elabels = graph["elabels"].to(device)[order]
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return DataIndex(n, vlabels, keys, dst, elabels, indptr)


def matching_order(q_labels: np.ndarray, adj: list[dict], label_count) -> list[int]:
    """Start at the query vertex whose label is rarest, then always take the
    unmatched neighbour of the matched set with the rarest label (ties: the
    lower index), so every vertex after the first has a matched neighbour."""
    n_q = len(q_labels)
    rarity = [label_count(int(q_labels[u])) for u in range(n_q)]
    order = [min(range(n_q), key=lambda u: (rarity[u], u))]
    while len(order) < n_q:
        done = set(order)
        front = {w for u in order for w in adj[u] if w not in done}
        if not front:  # a disconnected query: start its next part
            front = set(range(n_q)) - done
        order.append(min(front, key=lambda u: (rarity[u], u)))
    return order


def _has_edge(idx: DataIndex, a: torch.Tensor, b: torch.Tensor,
              elabel: int) -> torch.Tensor:
    probe = a * idx.n + b
    pos = torch.searchsorted(idx.keys, probe).clamp_max(idx.keys.numel() - 1)
    return (idx.keys[pos] == probe) & (idx.elabels[pos] == elabel)


def embeddings(idx: DataIndex, q_labels: np.ndarray, q_edges: np.ndarray,
               q_elabels: np.ndarray, *, drop_last_edges: bool = False) -> np.ndarray:
    """(M, n_q) int64 array of every embedding, rows sorted."""
    n_q = int(len(q_labels))
    adj: list[dict] = [dict() for _ in range(n_q)]
    for (a, b), e in zip(np.asarray(q_edges).reshape(-1, 2), q_elabels):
        adj[int(a)][int(b)] = int(e)
        adj[int(b)][int(a)] = int(e)
    counts = torch.bincount(idx.vlabels.long(),
                            minlength=int(q_labels.max()) + 1).cpu().numpy()
    order = matching_order(q_labels, adj,
                           lambda lab: int(counts[lab]) if lab < counts.size else 0)
    dev = idx.keys.device
    table = torch.nonzero(idx.vlabels == int(q_labels[order[0]])).flatten()[:, None]
    for t in range(1, n_q):
        u = order[t]
        lab = int(q_labels[u])
        back = [(order.index(w), e) for w, e in adj[u].items() if order.index(w) < t]
        last = drop_last_edges and t == n_q - 1
        if last or not back:
            cand = torch.nonzero(idx.vlabels == lab).flatten()
            size = torch.full((table.shape[0],), cand.numel(), device=dev)
            checks = []
        else:
            # expand from the matched neighbour whose rows fan out least
            sizes = [idx.indptr[table[:, w] + 1] - idx.indptr[table[:, w]]
                     for w, _ in back]
            a = min(range(len(back)), key=lambda i: (int(sizes[i].sum()), i))
            (p, e0), size = back[a], sizes[a]
            checks = back[:a] + back[a + 1:]
        parts = []
        for r0, r1 in _row_blocks(size):
            rows = table[r0:r1]
            rep = torch.arange(rows.shape[0], device=dev).repeat_interleave(size[r0:r1])
            if last or not back:
                new = cand.repeat(rows.shape[0])
                ok = torch.ones_like(new, dtype=torch.bool)
            else:
                start = idx.indptr[rows[:, p]]
                first = torch.cumsum(size[r0:r1], 0) - size[r0:r1]
                at = start[rep] + torch.arange(rep.numel(), device=dev) - first[rep]
                new = idx.dst[at]
                ok = (idx.vlabels[new] == lab) & (idx.elabels[at] == e0)
            for c in range(t):  # injective
                ok &= rows[rep, c] != new
            for c, e in checks:
                ok &= _has_edge(idx, rows[rep, c], new, e)
            parts.append(torch.cat([rows[rep[ok]], new[ok, None]], 1))
        table = torch.cat(parts) if parts else table[:0]
        if table.shape[0] == 0:
            return np.zeros((0, n_q), np.int64)
    out = np.empty((table.shape[0], n_q), np.int64)
    out[:, order] = table.cpu().numpy()
    return sort_rows(out)


def _row_blocks(size: torch.Tensor):
    """(start, stop) blocks of table rows whose expansions (``size`` cells
    a row) add up to at most ``EXPAND_BLOCK`` cells, or one row each."""
    cum = torch.cumsum(size, 0).cpu().numpy()
    r0 = 0
    while r0 < cum.size:
        base = cum[r0 - 1] if r0 else 0
        r1 = max(r0 + 1, int(np.searchsorted(cum, base + EXPAND_BLOCK, side="right")))
        yield r0, r1
        r0 = r1


def sort_rows(rows: np.ndarray) -> np.ndarray:
    """Rows in lexicographic order (duplicates kept)."""
    rows = np.asarray(rows, dtype=np.int64)
    if rows.shape[0] == 0:
        return rows
    return rows[np.lexsort(rows.T[::-1])]
