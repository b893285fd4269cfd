"""Query-label ordinal mapping (the paper's ``ord()``), port of
``repro.core.labels``.

``ord(l) ∈ 1..L`` for ``l ∈ 𝓛(Q)`` and ``ord(l) = 0`` otherwise, so vertices
labelled outside the query alphabet contribute nothing to degrees or CNIs.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.graphs.csr import Graph, as_numpy


class LabelMap(NamedTuple):
    """Sorted unique query labels; ord(raw) = index+1 (0 = not in 𝓛(Q))."""

    sorted_labels: torch.Tensor  # (L,) int32, ascending raw labels

    @property
    def n_labels(self) -> int:
        return int(self.sorted_labels.shape[0])


def build_label_map(query: Graph, device=None) -> LabelMap:
    """Label map of ``query``, on ``device`` (default: the query's own)."""
    if device is None:
        device = query.vlabels.device
    uniq = np.unique(as_numpy(query.vlabels)).astype(np.int32)
    return LabelMap(torch.as_tensor(uniq, device=device))


def ord_of(label_map: LabelMap, raw_labels: torch.Tensor) -> torch.Tensor:
    """Vectorized ord(): (…,) raw labels -> (…,) int32 in [0, L]."""
    labels = label_map.sorted_labels
    raw = raw_labels.to(labels.dtype)
    pos = torch.searchsorted(labels, raw).clamp(0, label_map.n_labels - 1)
    hit = labels[pos] == raw
    return torch.where(hit, pos.to(torch.int32) + 1, 0).to(torch.int32)


def counts_matrix(g: Graph, label_map: LabelMap,
                  alive: torch.Tensor | None = None) -> torch.Tensor:
    """Neighborhood label-count matrix K[v, l] (l = ord-1), int32.

    Only neighbors with in-query labels (and, if ``alive`` is given, only
    edges with both endpoints alive) are counted.
    """
    ord_v = ord_of(label_map, g.vlabels)
    return counts_matrix_from_ords(g, ord_v, label_map.n_labels, alive)


def counts_matrix_from_ords(g: Graph, ords: torch.Tensor, n_labels: int,
                            alive: torch.Tensor | None = None) -> torch.Tensor:
    """K[..., v, l] from precomputed ord values.

    ``ords`` (and ``alive``) may carry a leading batch of queries over the
    one shared data graph: (..., V) in → (..., V, L) out.  The scatter-add
    runs along the last axis of a (b, n·L) buffer with a separate batch row,
    so no flat index exceeds n·L.
    """
    n = g.n_vertices
    L = n_labels
    batch_shape = ords.shape[:-1]
    ords2 = ords.reshape(-1, n)
    b = ords2.shape[0]
    ord_dst = ords2[:, g.dst]  # (b, E)
    valid = ord_dst > 0
    if alive is not None:
        alive2 = alive.reshape(-1, n)
        valid = valid & alive2[:, g.dst] & alive2[:, g.src]
    flat_idx = g.src[None, :] * L + (ord_dst.to(torch.int64) - 1).clamp_min(0)
    k = torch.zeros((b, n * L), dtype=torch.int32, device=ords.device)
    k.scatter_add_(1, flat_idx, valid.to(torch.int32))
    return k.reshape(batch_shape + (n, L))
