"""Single-pass stream filtering (the paper's §3.4, Algorithm 6), port of
``repro.core.stream``.

The counts matrix is order-insensitive (a neighbourhood multiset is its
count vector), so degrees and CNIs accumulate over any edge-arrival order
in one sequential pass:

* ``scan_filter`` — a loop over chunk views of a graph's device arrays,
  one ``index_add_`` each (the equivalence oracle for the file pass);
* ``stream_filter_file`` — one pass over an edge file or any source
  ``iter_update_batches`` takes: each chunk updates the counts on the
  device; an edge is retained only if both endpoints pass the label
  filter; on a src-sorted stream, vertices whose run of edges has ended
  are finalized early (their completed rows digested by ``cni_encode`` and
  matched by ``candidate_filter``), so their edges can be dropped.  The
  peak retained-edge count is the memory metric.

Stream-time CNIs count every in-𝓛(Q) neighbour (no aliveness yet), an
upper bound on the post-ILGF digest and hence a sound prefilter; the full
ILGF fixed point then runs on the small retained subgraph.

The counts' flat indices are int64 (the reference forms them in int32,
which agrees while V·L < 2^31).  The peak retained count is computed from
the chunk at which each vertex was pruned, in one pass at the end, where
the reference recounts every retained chunk after every chunk; the number
is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import filters as flt
from repro_torch.core.cni import default_max_p
from repro_torch.core.ilgf import IlgfResult, QueryDigest, ilgf, prepare_query
from repro_torch.core.labels import ord_of
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, as_numpy, build_graph, graph_to, max_degree
from repro_torch.graphs.io import iter_update_batches


class StreamStats(NamedTuple):
    n_chunks: int
    peak_retained_edges: int
    final_retained_edges: int
    pruned_during_stream: int
    total_edges_seen: int


class StreamResult(NamedTuple):
    prefilter_alive: np.ndarray  # (V,) bool after the single pass
    retained: Graph              # filtered subgraph G_Q (Alg. 6 output)
    ilgf_result: IlgfResult      # full fixed point on the retained graph
    stats: StreamStats


def _chunk_update(counts: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                  valid: torch.Tensor, ords: torch.Tensor, n_labels: int) -> None:
    """Accumulate one chunk of directed records into the flat (V·L,) counts:
    one ``index_add_`` with int64 flat indices."""
    ord_dst = ords[dst]
    ok = valid & (ords[src] > 0) & (ord_dst > 0)
    idx = src * n_labels + (ord_dst.to(torch.int64) - 1).clamp_min(0)
    counts.index_add_(0, idx, ok.to(torch.int32))


def _match_any(counts: torch.Tensor, ords: torch.Tensor, q: QueryDigest,
               d_max: int, max_p: int) -> torch.Tensor:
    """(N,) bool: the row matches some query vertex (``cni_encode`` then
    ``candidate_filter`` on a CUDA tensor)."""
    digest = flt.make_digest(counts, ords, d_max, max_p)
    return flt.cni_match(digest, q.digest).any(1)


def build_n_labels(query: Graph) -> int:
    return int(np.unique(as_numpy(query.vlabels)).shape[0])


def _prepare(query: Graph, vlabels: torch.Tensor, d_max: int):
    q = prepare_query(query, d_max, default_max_p(d_max, build_n_labels(query)))
    n_labels = q.label_map.n_labels
    return q, n_labels, default_max_p(d_max, n_labels), ord_of(q.label_map, vlabels)


def scan_filter(data: Graph, query: Graph, *, chunk_edges: int = 4096,
                d_max: int | None = None, device=None) -> np.ndarray:
    """The single-pass prefilter mask (V,) bool of an in-memory graph,
    accumulated chunk by chunk on ``device`` (``None`` means ``"cuda"``).

    Equal to the one-shot filter on the whole graph (the order
    insensitivity that makes Algorithm 6 valid).  The chunks are views of
    the graph's device arrays in ``iter_update_batches``' boundaries; the
    tail's padding rows would add zero, so the last view is short instead.
    """
    dev = resolve_device(device)
    data = graph_to(data, dev)
    if d_max is None:
        d_max = max(1, max_degree(data))
    n = data.n_vertices
    q, n_labels, max_p, ords = _prepare(graph_to(query, dev), data.vlabels,
                                        d_max)
    counts = torch.zeros(n * n_labels, dtype=torch.int32, device=dev)
    valid = torch.ones(min(chunk_edges, data.src.shape[0]), dtype=torch.bool,
                       device=dev)
    for start in range(0, data.src.shape[0], chunk_edges):
        s = data.src[start:start + chunk_edges]
        _chunk_update(counts, s, data.dst[start:start + chunk_edges],
                      valid[:s.shape[0]], ords, n_labels)
    alive = _match_any(counts.view(n, n_labels), ords, q, d_max, max_p)
    return (alive & (ords > 0)).cpu().numpy()


def stream_filter_file(path_or_chunks, vlabels, query: Graph, *,
                       chunk_edges: int = 65536, d_max: int,
                       sorted_stream: bool = True, run_ilgf: bool = True,
                       device=None) -> StreamResult:
    """Algorithm 6 over an edge file (or any ``iter_update_batches``
    source: a path, a port ``Graph``, legacy ``(src, dst, elabel, valid)``
    tuples or ``EdgeBatch``es), counting on ``device`` (``None`` means
    ``"cuda"``).  The retained graph and the ILGF result lie there too."""
    dev = resolve_device(device)
    vlabels = as_numpy(vlabels)
    n = int(vlabels.shape[0])
    q, n_labels, max_p, ords = _prepare(
        graph_to(query, dev), torch.tensor(vlabels, device=dev), d_max)
    ords_np = ords.cpu().numpy()
    counts = torch.zeros(n * n_labels, dtype=torch.int32, device=dev)
    pruned = np.zeros(n, dtype=bool)      # finalized and rejected
    finalized = np.zeros(n, dtype=bool)
    never = np.iinfo(np.int64).max
    pruned_at = np.full(n, never, dtype=np.int64)  # chunk of the pruning
    retained: list[np.ndarray] = []  # (k, 3) records passing the label filter
    total_edges = 0
    last_src_prev = -1

    for t, batch in enumerate(iter_update_batches(path_or_chunks, chunk_edges)):
        s_np, d_np, e_np, valid_np = (batch.src, batch.dst, batch.elabels,
                                      batch.valid)
        total_edges += int(valid_np.sum())
        _chunk_update(counts, torch.as_tensor(s_np, device=dev).long(),
                      torch.as_tensor(d_np, device=dev).long(),
                      torch.as_tensor(valid_np, device=dev), ords, n_labels)
        # label-filter retention (Alg. 6 lines 15-18)
        keep = valid_np & (ords_np[s_np] > 0) & (ords_np[d_np] > 0)
        keep &= ~pruned[s_np] & ~pruned[d_np]
        retained.append(np.stack([s_np[keep], d_np[keep], e_np[keep]], axis=1))
        if sorted_stream and valid_np.any():
            # vertices with id < this chunk's max src have complete rows
            chunk_max_src = int(s_np[valid_np].max())
            lo, hi = last_src_prev + 1, chunk_max_src
            if hi > lo:
                complete = np.arange(lo, hi)
                fresh = complete[~finalized[complete]]
                if fresh.size:
                    at = torch.as_tensor(fresh, device=dev)
                    ok = _match_any(counts.view(n, n_labels)[at], ords[at], q,
                                    d_max, max_p).cpu().numpy()
                    ok &= ords_np[fresh] > 0
                    pruned[fresh[~ok]] = True
                    pruned_at[fresh[~ok]] = t
                    finalized[fresh] = True
            last_src_prev = chunk_max_src - 1
    n_chunks = len(retained)

    # finalize everyone: the single-pass prefilter mask
    alive = _match_any(counts.view(n, n_labels), ords, q, d_max,
                       max_p).cpu().numpy() & (ords_np > 0)
    alive &= ~pruned
    rec = (np.concatenate(retained, axis=0) if retained
           else np.zeros((0, 3), dtype=np.int64))
    # a record is retained from its chunk until the chunk that prunes its
    # first endpoint (never before its own: both ends were unpruned then)
    gone = np.minimum(pruned_at[rec[:, 0]], pruned_at[rec[:, 1]])
    held = (np.cumsum([r.shape[0] for r in retained])
            - np.cumsum(np.bincount(gone[gone < n_chunks], minlength=n_chunks)))
    peak_retained = max(0, int(held.max())) if n_chunks else 0

    rec = rec[alive[rec[:, 0]] & alive[rec[:, 1]]]
    retained_graph = build_graph(n, vlabels, rec[:, :2], rec[:, 2], device=dev)
    if run_ilgf:
        res = ilgf(retained_graph, query, d_max=d_max)
    else:
        res = IlgfResult(
            alive=torch.as_tensor(alive, device=dev),
            candidates=torch.zeros((n, query.n_vertices), dtype=torch.bool,
                                   device=dev),
            iterations=0)
    stats = StreamStats(
        n_chunks=n_chunks,
        peak_retained_edges=peak_retained,
        final_retained_edges=int(rec.shape[0]) // 2,
        pruned_during_stream=int(pruned.sum()),
        total_edges_seen=total_edges,
    )
    return StreamResult(prefilter_alive=alive, retained=retained_graph,
                        ilgf_result=res, stats=stats)
