"""Batched multi-query engine: one ILGF peeling loop for N queries over one
data graph, port of ``repro.core.batch_engine``.

N query digests are stacked into padded ``(B, …)`` tensors and every ILGF
round runs over the whole stack at once:

* **Bucketing.**  Queries are grouped by ``(d_max, |𝓛(Q)|↑, |V(Q)|↑)``
  (``↑`` = next power of two).  Padded label columns hold zero counts and
  padded query vertices hold ord 0, both exact no-ops for the CNI encoding
  and the match grid (label 0 never matches).  Every query of a bucket
  shares ``max_p = default_max_p(d_max, l_pad)``.
* **Host query digests.**  The query side is tiny, so its digests are built
  in numpy (``cni_from_counts_np``) with the device's exact semantics.
* **Per-round retirement.**  Each round retires the queries whose alive
  mask is stable (their fixed point), gathers the survivors to the front
  and shrinks the pad to the next power of two, so the filter work tracks
  the sum of per-query rounds.
* **Store seeding.**  On a store or snapshot with an incremental index,
  each row's alive mask starts from ``store_prefilter`` (the data-side
  digest memoized per query alphabet across a chunk).
* **Per-query search** through ``search_filtered``, as the sequential
  engine does (with the engine's planner, if any), so embeddings equal it
  up to row order (the bucket's ``max_p`` may differ from the sequential
  engine's, which changes the filtered graph but never the embeddings).

``batched_ilgf_round`` is one peeling round over the batch, the unit the
reference's serving front-end calls once per tick.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import obsv
from repro_torch.configs.cni_engine import CONFIG as ENGINE_CONFIG
from repro_torch.core import filters as flt
from repro_torch.core.cni import cni_from_counts_np, default_max_p
from repro_torch.core.distributed import (
    prepare_sharded_edges,
    sharded_batched_ilgf_round,
)
from repro_torch.core.engine import QueryStats, check_engine_args, search_filtered
from repro_torch.core.ilgf import match_matrix
from repro_torch.core.labels import counts_matrix_from_ords
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, as_numpy, graph_to, max_degree, to_host


class BatchedQueries(NamedTuple):
    """Padded (B, …) stack of query digests sharing one bucket.

    Field names mirror ``ilgf.QueryDigest`` (``counts``/``digest``/``mnd``)
    so ``match_matrix`` accepts either; ``ords`` is each query's ord() view
    of the data vertices.
    """

    ords: torch.Tensor         # (B, V) int32
    counts: torch.Tensor       # (B, U, L) int32 — query NLF counts
    digest: flt.VertexDigest   # all fields (B, U); cni int64
    mnd: torch.Tensor          # (B, U) int32


def ceil_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def bucket_key(query: Graph, d_max: int) -> tuple[int, int, int]:
    """Shape bucket: queries with equal keys stack into one batch."""
    n_labels = int(np.unique(as_numpy(query.vlabels)).size)
    return (d_max, ceil_pow2(n_labels), ceil_pow2(query.n_vertices))


def prepare_padded_query(query: Graph, data_vlabels, d_max: int, max_p: int,
                         u_pad: int, l_pad: int):
    """One query's digest, padded to the bucket's (u_pad, l_pad) shape, in
    numpy on the host.

    Padding label columns come after the real alphabet (zero counts never
    alter the descending expansion) and padding query vertices carry ord 0
    (never matched).  Returns numpy rows (ords_data, counts, VertexDigest,
    mnd).
    """
    vlab_q = as_numpy(query.vlabels)
    u_q = query.n_vertices
    uniq = np.unique(vlab_q)
    l_q = int(uniq.size)
    if u_q > u_pad:
        raise ValueError(f"query has {u_q} vertices > pad {u_pad}")
    if l_q > l_pad:
        raise ValueError(f"query has {l_q} labels > pad {l_pad}")

    data_vlabels = as_numpy(data_vlabels)
    pos = np.clip(np.searchsorted(uniq, data_vlabels), 0, l_q - 1)
    ords_data = np.where(uniq[pos] == data_vlabels, pos + 1, 0).astype(np.int32)

    q_ord = np.zeros(u_pad, np.int32)
    q_ord[:u_q] = np.searchsorted(uniq, vlab_q) + 1
    counts = np.zeros((u_pad, l_pad), np.int32)
    src = as_numpy(query.src)
    dst = as_numpy(query.dst)
    if src.size:
        np.add.at(counts, (src, q_ord[dst] - 1), 1)
    deg = counts.sum(axis=1).astype(np.int32)

    cni, cni_log, _ = cni_from_counts_np(counts, d_max, max_p)

    mnd = np.zeros(u_pad, np.int32)
    if src.size:
        np.maximum.at(mnd, src, deg[dst])

    digest = flt.VertexDigest(ord_label=q_ord, deg=deg, cni=cni,
                              cni_log=cni_log)
    return ords_data, counts, digest, mnd


def stack_queries(queries: Sequence[Graph], data: Graph, d_max: int,
                  max_p: int, u_pad: int, l_pad: int, b_pad: int,
                  device=None) -> BatchedQueries:
    """Stack <= b_pad queries into one padded batch on ``device`` (None
    means ``"cuda"``); spare slots are inert (all-zero ords, so an empty
    initial alive set and no work per round)."""
    if len(queries) > b_pad:
        raise ValueError(f"{len(queries)} queries > batch pad {b_pad}")
    dev = resolve_device(device)
    data_vlabels = as_numpy(data.vlabels)
    rows = [prepare_padded_query(q, data_vlabels, d_max, max_p, u_pad, l_pad)
            for q in queries]
    n_spare = b_pad - len(rows)

    def stk(items, pad_row):
        return torch.as_tensor(np.stack(list(items) + [pad_row] * n_spare),
                               device=dev)

    zeros_u = np.zeros(u_pad, np.int32)
    digest = flt.VertexDigest(
        ord_label=stk((r[2].ord_label for r in rows), zeros_u),
        deg=stk((r[2].deg for r in rows), zeros_u),
        cni=stk((r[2].cni for r in rows), np.zeros(u_pad, np.int64)),
        cni_log=stk((r[2].cni_log for r in rows),
                    np.full(u_pad, -np.inf, np.float32)),
    )
    return BatchedQueries(
        ords=stk((r[0] for r in rows), np.zeros(data.n_vertices, np.int32)),
        counts=stk((r[1] for r in rows), np.zeros((u_pad, l_pad), np.int32)),
        digest=digest,
        mnd=stk((r[3] for r in rows), zeros_u),
    )


def batched_queries_from_numpy(qb, device=None) -> BatchedQueries:
    """A ``BatchedQueries`` on ``device`` from a reference stack's arrays.

    ``qb`` has the reference's fields (``ords``, ``counts``, ``digest``
    with ``cni.hi``/``cni.lo`` uint32 limbs, ``mnd``), as anything
    ``np.asarray`` reads; the limbs join into the port's int64 digest.
    """
    dev = resolve_device(device)

    def put(x):
        return torch.as_tensor(np.array(x), device=dev)

    hi = np.asarray(qb.digest.cni.hi).astype(np.uint64)
    lo = np.asarray(qb.digest.cni.lo).astype(np.uint64)
    digest = flt.VertexDigest(
        ord_label=put(qb.digest.ord_label),
        deg=put(qb.digest.deg),
        cni=put(((hi << np.uint64(32)) | lo).astype(np.int64)),
        cni_log=put(qb.digest.cni_log),
    )
    return BatchedQueries(ords=put(qb.ords), counts=put(qb.counts),
                          digest=digest, mnd=put(qb.mnd))


def batched_ilgf_round(g: Graph, qb: BatchedQueries, alive: torch.Tensor, *,
                       n_labels: int, d_max: int, max_p: int, variant: str):
    """One peeling round over the batch.

    Returns (new_alive (B, V), candidates (B, V, U), changed (B,)), all on
    the graph's device.  A row with ``changed == False`` has reached its
    fixed point, and its candidate columns are final.
    """
    counts = counts_matrix_from_ords(g, qb.ords, n_labels, alive)
    match = match_matrix(variant, counts, qb.ords, qb, g, alive, d_max, max_p)
    new_alive = alive & match.any(-1)
    changed = (new_alive != alive).any(-1)
    return new_alive, match & new_alive[..., None], changed


def batched_ilgf_fixed_point(g: Graph, qb: BatchedQueries, *, n_labels: int,
                             d_max: int, max_p: int, variant: str,
                             max_iters: int):
    """Lockstep ILGF to the per-query fixed points.

    Returns (alive (B, V), candidates (B, V, U), rounds).  The loop runs
    until the whole batch is stable; stable rows re-apply an idempotent
    round, so each row's result is its own fixed point.
    """
    alive = qb.ords > 0  # Lemma 1 applied up front, per query
    rounds = 0
    changed = True
    while changed and rounds < max_iters:
        alive, _, row_changed = batched_ilgf_round(
            g, qb, alive, n_labels=n_labels, d_max=d_max, max_p=max_p,
            variant=variant)
        changed = bool(row_changed.any())  # the round's one sync
        rounds += 1
    counts = counts_matrix_from_ords(g, qb.ords, n_labels, alive)
    match = match_matrix(variant, counts, qb.ords, qb, g, alive, d_max, max_p)
    return alive, match & alive[..., None], rounds


def _compact_batch(qb: BatchedQueries, alive: torch.Tensor,
                   idx: torch.Tensor, n_keep: int):
    """Gather the batch rows ``idx`` (tail entries repeat a survivor) into a
    smaller pad; rows at position >= n_keep become inert (ords 0, alive
    False)."""
    qb2 = BatchedQueries(
        ords=qb.ords[idx], counts=qb.counts[idx],
        digest=flt.VertexDigest(*(x[idx] for x in qb.digest)),
        mnd=qb.mnd[idx],
    )
    inert = (torch.arange(idx.shape[0], device=idx.device) >= n_keep)[:, None]
    return (qb2._replace(ords=qb2.ords.masked_fill(inert, 0)),
            alive[idx].masked_fill(inert, False))


class BatchQueryEngine:
    """Multi-query CNI engine: one batched filter loop per query bucket.

    Batched counterpart of ``SubgraphQueryEngine``: ``query_batch`` returns
    one (embeddings, stats) pair per input query, in input order, with
    embeddings equal (up to row order) to the sequential engine's.
    ``stats.extras["batch"]`` holds the query's ``BatchReport``; with
    ``enumerator="device"`` the join's telemetry lands in
    ``stats.extras["enum"]``.

    ``data``: a ``repro_torch`` ``Graph``, a store or a ``GraphSnapshot``,
    whose graph moves to ``device`` once (``None`` means ``"cuda"``); with
    an incremental index each query's rounds start from its
    ``store_prefilter`` mask.  Over an out-of-core snapshot one chunk fetch
    covers the union of the batch's prefilter masks, and ``d_max`` is the
    store's resident bound.  ``planner``: an optional ``QueryPlanner``
    shared by every query's search.  ``mesh``: a
    ``core.distributed.ShardMesh``; every peeling round then runs
    vertex-partitioned (``sharded_batched_ilgf_round``) and, with
    ``enumerator="device"``, each query's join row-partitioned, with
    results equal to the unmeshed engine's.
    """

    def __init__(self, data, *, filter_variant: str = ENGINE_CONFIG.filter_variant,
                 khop: int = ENGINE_CONFIG.khop,
                 searcher: str = ENGINE_CONFIG.searcher,
                 search_vertex_cap: int = 8192, max_batch: int | None = None,
                 max_iters: int = 1_000, mesh=None,
                 shard_axis: str = ENGINE_CONFIG.distributed_axis,
                 planner=None, enumerator: str = ENGINE_CONFIG.enumerator,
                 d_max: int | None = None, device=None):
        snap = check_engine_args(
            data, mesh, shard_axis, enumerator, ooc_mesh_error=(
                "out-of-core stores run single-host; build the batch engine "
                "without mesh="))
        self.device = resolve_device(device)
        self.data = graph_to(snap.graph, self.device)
        self.epoch = snap.epoch
        self._index = snap.index
        self._ooc = snap.ooc
        self._host_data = to_host(self.data)  # search re-reads fields often
        self.filter_variant = filter_variant
        self.khop = khop
        self.searcher = searcher
        self.search_vertex_cap = search_vertex_cap
        self.max_batch = ENGINE_CONFIG.max_batch if max_batch is None else max_batch
        self.max_iters = max_iters
        # an out-of-core engine only sees restricted edge sets, so its
        # digest bound is the full graph's resident one
        if d_max is not None:
            self.d_max = int(d_max)
        elif self._ooc is not None:
            self.d_max = self._ooc.d_max
        else:
            self.d_max = max(1, max_degree(self.data))
        # one planner (one plan cache) across every chunk and batch
        self.planner = planner
        self.enumerator = enumerator
        self.mesh = mesh
        self.shard_axis = shard_axis
        self._sharded = None
        if mesh is not None:
            # vertex-partition the graph once; every round reuses it
            self._sharded = prepare_sharded_edges(
                snap._replace(graph=self.data), mesh, shard_axis)[:2]

    def query_batch(self, queries: Sequence[Graph], *,
                    max_embeddings: int | None = None
                    ) -> list[tuple[np.ndarray, QueryStats]]:
        # one host copy per query up front: bucketing, digest prep and
        # search all read its fields on the host
        queries = [to_host(q) for q in queries]
        if self._ooc is not None:
            return self._query_batch_ooc(queries,
                                         max_embeddings=max_embeddings)
        results: list = [None] * len(queries)
        buckets: dict[tuple[int, int, int], list[int]] = defaultdict(list)
        for i, q in enumerate(queries):
            buckets[bucket_key(q, self.d_max)].append(i)
        for (d_max, l_pad, u_pad), idxs in sorted(buckets.items()):
            max_p = default_max_p(d_max, l_pad)
            # descending power-of-two chunks (each <= max_batch): every
            # chunk is exactly full, so no inert pad rows ride along
            pos = 0
            while pos < len(idxs):
                remaining = len(idxs) - pos
                size = min(self.max_batch, 1 << (remaining.bit_length() - 1))
                chunk = idxs[pos:pos + size]
                pos += size
                with obsv.span("batch.bucket", d_max=d_max, l_pad=l_pad,
                               u_pad=u_pad, batch_size=len(chunk)):
                    self._run_chunk(queries, chunk, results, d_max=d_max,
                                    l_pad=l_pad, u_pad=u_pad, max_p=max_p,
                                    max_embeddings=max_embeddings)
        return results

    def _query_batch_ooc(self, queries, *, max_embeddings):
        """One chunk fetch for the whole batch, then the in-memory path.

        Each row's fixed point stays inside its own sound prefilter mask,
        so the fetch over the union covers the batch; an inner engine over
        the restricted graph, pinned to the full graph's ``d_max``, gives
        the in-memory results.  Every result carries the fetch's report.
        """
        # imported here: incremental imports this module
        from repro_torch.core.incremental import store_prefilter
        from repro_torch.graphs.store import GraphSnapshot

        union = torch.zeros(self.data.n_vertices, dtype=torch.bool,
                            device=self._index.counts.device)
        digest_cache: dict = {}
        for q in queries:
            union |= store_prefilter(self._index, q,
                                     variant=self.filter_variant,
                                     digest_cache=digest_cache)
        restricted, tel = self._ooc.fetch_restricted(union.cpu().numpy())
        inner = BatchQueryEngine(
            GraphSnapshot(self.epoch, restricted, self._index),
            filter_variant=self.filter_variant, khop=self.khop,
            searcher=self.searcher, search_vertex_cap=self.search_vertex_cap,
            max_batch=self.max_batch, max_iters=self.max_iters,
            planner=self.planner, enumerator=self.enumerator,
            d_max=self.d_max, device=self.device)
        results = inner.query_batch(queries, max_embeddings=max_embeddings)
        for _emb, stats in results:
            stats.extras["ooc"] = tel
        return results

    def _round(self, qb, alive, *, l_pad, d_max, max_p):
        """One peeling round, single-device or sharded (same contract)."""
        if self._sharded is not None:
            se, plan = self._sharded
            return sharded_batched_ilgf_round(
                se, plan, qb, alive, mesh=self.mesh, axis=self.shard_axis,
                n_labels=l_pad, d_max=d_max, max_p=max_p,
                variant=self.filter_variant)
        return batched_ilgf_round(self.data, qb, alive, n_labels=l_pad,
                                  d_max=d_max, max_p=max_p,
                                  variant=self.filter_variant)

    def _run_chunk(self, queries, chunk, results, *, d_max, l_pad, u_pad,
                   max_p, max_embeddings):
        """Filter one bucket chunk with round-level retirement, then search
        each query.

        Each round retires the rows whose alive mask is stable (their
        candidates are final) and compacts the survivors into a smaller
        power-of-two pad, so the filter work tracks the sum of per-query
        rounds rather than the batch's deepest query.  A query's
        ``stats.filter_seconds`` is the wall time of the rounds in which its
        row was live (each round's dispatch and its one sync).
        """
        b_pad = min(self.max_batch, ceil_pow2(len(chunk)))
        qb = stack_queries([queries[i] for i in chunk], self._host_data,
                           d_max, max_p, u_pad, l_pad, b_pad,
                           device=self.device)
        alive = qb.ords > 0
        if self._index is not None:
            # imported here: incremental imports this module
            from repro_torch.core.incremental import store_prefilter

            digest_cache: dict = {}
            seed = torch.zeros_like(alive)
            for r, i in enumerate(chunk):
                seed[r] = store_prefilter(
                    self._index, queries[i], variant=self.filter_variant,
                    digest_cache=digest_cache).to(self.device)
            alive &= seed
        row_query = list(range(len(chunk)))  # batch row -> chunk position
        done: dict[int, tuple[np.ndarray, np.ndarray, int]] = {}

        def retire(rows, alive, cand, rounds):
            sel = torch.as_tensor(rows, device=self.device)
            alive_np = alive[sel].cpu().numpy()
            cand_np = cand[sel].cpu().numpy()
            for k, r in enumerate(rows):
                done[row_query[r]] = (alive_np[k], cand_np[k], rounds)

        live_s = np.zeros(len(chunk))  # chunk position -> its rounds' time
        rounds = 0
        while row_query and rounds < self.max_iters:
            t_round = time.perf_counter()
            with obsv.span("batch.round", round=rounds, live=len(row_query)):
                alive, cand, changed = self._round(
                    qb, alive, l_pad=l_pad, d_max=d_max, max_p=max_p)
                conv = ~changed.cpu().numpy()  # the round's one sync
            live_s[row_query] += time.perf_counter() - t_round
            rounds += 1
            if not conv[:len(row_query)].any():
                continue
            with obsv.span("batch.retire") as retire_span:
                keep = [r for r in range(len(row_query)) if not conv[r]]
                retire([r for r in range(len(row_query)) if conv[r]],
                       alive, cand, rounds)
                retire_span.set_attrs(retired=len(row_query) - len(keep),
                                      live=len(keep))
                row_query = [row_query[r] for r in keep]
                if not row_query:
                    break
                # always gather survivors to the front: batch row j stays
                # in lockstep with row_query[j]
                new_pad = min(b_pad, ceil_pow2(len(keep)))
                idx = torch.as_tensor(keep + [keep[0]] * (new_pad - len(keep)),
                                      device=self.device)
                qb, alive = _compact_batch(qb, alive, idx, len(keep))

        if row_query:
            # max_iters hit: degrade soundly — the current masks are
            # supersets of the fixed point, so search still returns exactly
            # the true embeddings.  One more round gives candidates aligned
            # with the current (compacted) rows.
            t_round = time.perf_counter()
            alive, cand, _ = self._round(qb, alive, l_pad=l_pad, d_max=d_max,
                                         max_p=max_p)
            live_s[row_query] += time.perf_counter() - t_round
            rounds += 1
            retire(list(range(len(row_query))), alive, cand, rounds)
        for pos, i in enumerate(chunk):
            q = queries[i]
            alive_row, cand_row, q_rounds = done[pos]
            stats = QueryStats(vertices_before=self.data.n_vertices,
                               filter_seconds=float(live_s[pos]),
                               ilgf_iterations=q_rounds)
            stats.extras["batch"] = obsv.BatchReport(
                bucket=(d_max, l_pad, u_pad), batch_size=len(chunk),
            ).validate()
            emb = search_filtered(
                self._host_data, q, alive_row, cand_row[:, :q.n_vertices],
                stats, khop=self.khop, searcher=self.searcher,
                search_vertex_cap=self.search_vertex_cap,
                max_embeddings=max_embeddings, planner=self.planner,
                enumerator=self.enumerator, mesh=self.mesh,
                shard_axis=self.shard_axis, device=self.device,
            )
            results[i] = (emb, stats)
