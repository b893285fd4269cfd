"""Graph-database CNI index (the paper's §5 future work), port of
``repro.core.graph_index``.

For one global label universe, every graph keeps its vertices'
(label-inclusive) log-space CNI digests per label class, sorted
descending.  A query Q can embed into a data graph G only if, within each
label class, G's i-th largest digest dominates Q's i-th largest for every
i: an embedding maps each u to a distinct v with ℓ(v) = ℓ(u) and
digest(v) ≥ digest(u), so sorting both sides descending keeps the
dominance.  The index prunes whole graphs without touching their edges;
the survivors go through the full engine.

``d_max`` and ``max_p`` are global to the database and a row's digest
depends on its own counts alone, so the build digests every graph's count
rows in one ``cni_encode`` call over their disjoint union, where the
reference encodes one graph at a time: the values are the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cni import default_max_p
from repro_torch.core.labels import LabelMap, counts_matrix, ord_of
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, as_numpy, graph_to, max_degree
from repro_torch.kernels.cni_encode import ops as encode_ops


@dataclasses.dataclass
class GraphEntry:
    graph: Graph
    # per label class: descending digest list of that class's vertices
    digests: dict[int, np.ndarray]


def _per_label(digs: np.ndarray, ords: np.ndarray) -> dict[int, np.ndarray]:
    digs = np.where(np.isfinite(digs), digs, -1e30)
    return {int(lab): np.sort(digs[ords == lab])[::-1]
            for lab in np.unique(ords)}


class GraphDatabaseIndex:
    """CNI-digest index over a database of labelled graphs, built and
    queried on ``device`` (``None`` means ``"cuda"``)."""

    def __init__(self, graphs: list[Graph], *, device=None):
        self.device = resolve_device(device)
        self.graphs = [graph_to(g, self.device) for g in graphs]
        labels = np.unique(np.concatenate(
            [as_numpy(g.vlabels) for g in self.graphs]))
        self.label_map = LabelMap(torch.as_tensor(labels.astype(np.int32),
                                                  device=self.device))
        self.d_max = max(max(1, max_degree(g)) for g in self.graphs)
        self.max_p = default_max_p(self.d_max, len(labels))
        # the disjoint union of every graph: one scatter, one encode
        offsets = np.cumsum([0] + [g.n_vertices for g in self.graphs])
        union = Graph(
            vlabels=torch.cat([g.vlabels for g in self.graphs]),
            src=torch.cat([g.src + int(o) for g, o in zip(self.graphs, offsets)]),
            dst=torch.cat([g.dst + int(o) for g, o in zip(self.graphs, offsets)]),
            elabels=torch.cat([g.elabels for g in self.graphs]),
        )
        ords = ord_of(self.label_map, union.vlabels).cpu().numpy()
        digs = self._log_digests(counts_matrix(union, self.label_map))
        self.entries = [
            GraphEntry(graph=g, digests=_per_label(digs[a:b], ords[a:b]))
            for g, a, b in zip(self.graphs, offsets[:-1], offsets[1:])
        ]

    def _log_digests(self, counts: torch.Tensor) -> np.ndarray:
        return encode_ops.cni_encode(counts, self.d_max,
                                     self.max_p)[2].cpu().numpy()

    def candidates(self, query: Graph, eps: float = 1e-4) -> list[int]:
        """Indices of the graphs that MAY contain the query (sound)."""
        query = graph_to(query, self.device)
        q_ords = ord_of(self.label_map, query.vlabels).cpu().numpy()
        if (q_ords == 0).any():
            return []  # a label absent from the whole database
        per_label_q = _per_label(
            self._log_digests(counts_matrix(query, self.label_map)), q_ords)
        out = []
        for i, entry in enumerate(self.entries):
            for lab, q_vals in per_label_q.items():
                g_vals = entry.digests.get(lab)
                if g_vals is None or g_vals.size < q_vals.size:
                    break
                tol = eps * np.maximum(1.0, np.abs(q_vals))
                if not (g_vals[:q_vals.size] >= q_vals - tol).all():
                    break
            else:
                out.append(i)
        return out

    def query(self, query: Graph, **engine_kw):
        """Index prune, then the port's engine on each candidate graph, on
        the index's device: ``{graph index: embeddings}`` for the graphs
        with at least one embedding."""
        from repro_torch.core.engine import SubgraphQueryEngine

        results = {}
        for i in self.candidates(query):
            eng = SubgraphQueryEngine(self.graphs[i], device=self.device,
                                      **engine_kw)
            emb, _ = eng.query(query)
            if emb.shape[0]:
                results[i] = emb
        return results
