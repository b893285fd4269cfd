"""Carry a reference graph's arrays into the port."""

from __future__ import annotations

from repro_torch.graphs.csr import Graph, graph_to


def graph_from_numpy(vlabels, src, dst, elabels, device=None) -> Graph:
    """A port ``Graph`` on ``device`` from the four fields of a reference
    ``Graph`` given as numpy arrays (already symmetrized; copied as is)."""
    return graph_to(Graph(vlabels, src, dst, elabels), device)
