"""Public API: the end-to-end CNI subgraph-query engine, port of
``repro.core.engine`` for a ``Graph``, a ``GraphStore`` or a
``GraphSnapshot``.

Pipeline = (store prefilter) → (out-of-core chunk fetch) → ILGF fixed
point (on the device, or vertex-partitioned over a mesh) → compaction
(host) → optional k-hop refinement → (planner) → join enumeration.
``search_filtered`` is the post-filter stage on its own.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Literal

import numpy as np

from repro_torch import obsv
from repro_torch.core.distributed import (
    distributed_ilgf,
    mesh_shards,
    prepare_sharded_edges,
)
from repro_torch.core.ilgf import ilgf
from repro_torch.core.khop import refine_candidates_khop
from repro_torch.core.search import (
    bfs_join_search,
    device_join_search,
    host_dfs_search,
    sharded_device_join_search,
)
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, graph_to, induced_subgraph, to_host
from repro_torch.graphs.store import GraphSnapshot, as_snapshot


@dataclass
class QueryStats:
    filter_seconds: float = 0.0
    search_seconds: float = 0.0
    ilgf_iterations: int = 0
    vertices_before: int = 0
    vertices_after: int = 0
    candidate_pairs: int = 0
    n_embeddings: int = 0
    extras: dict = field(default_factory=dict)


def search_filtered(
    data: Graph,
    query: Graph,
    alive: np.ndarray,
    candidates: np.ndarray,
    stats: QueryStats,
    *,
    khop: int = 1,
    searcher: str = "join",
    search_vertex_cap: int = 8192,
    max_embeddings: int | None = None,
    planner=None,
    enumerator: str = "host",
    mesh=None,
    shard_axis: str = "data",
    device=None,
) -> np.ndarray:
    """Compaction → optional k-hop refinement → enumeration on one query.

    ``alive``: (V,) bool fixed-point mask; ``candidates``: (V, U) bool C(u)
    columns over original vertex ids.  Returns embeddings over original ids
    and fills the search-side fields of ``stats`` in place.  With an active
    tracer the compaction is a ``query.compact`` span (``n_alive``: the
    filtered vertex count N).

    ``planner``: an optional ``core.planner.QueryPlanner``; the matching
    order then comes from its cost model, fed the post-filter candidate
    counts, and the plan lands in ``stats.extras["plan"]`` (a ``skipped``
    entry when the filter left nothing).  Embedding sets are the same
    under any order.

    ``enumerator``: ``"host"`` (``bfs_join_search``) or ``"device"``
    (``device_join_search``, whose telemetry lands in
    ``stats.extras["enum"]`` on every exit path, filter-killed queries
    included).  Embeddings are bit-identical either way.

    ``mesh`` / ``shard_axis``: with ``enumerator="device"`` and a
    ``ShardMesh``, enumeration runs partitioned across it
    (``sharded_device_join_search``), still bit-identical, with the shard
    fields of the telemetry filled in.  The host enumerator ignores it.
    """
    if enumerator not in ("host", "device"):
        raise ValueError(
            f"enumerator must be 'host' or 'device', got {enumerator!r}"
        )
    dev = resolve_device(device)
    stats.vertices_after = int(alive.sum())
    if stats.vertices_after == 0:
        if planner is not None:
            stats.extras["plan"] = obsv.PlanReport.skipped()
        if enumerator == "device" and searcher != "dfs":
            stats.extras["enum"] = obsv.EnumReport.empty()
        return np.zeros((0, query.n_vertices), np.int64)

    with obsv.span("query.compact") as compact_span:
        sub, old_ids = induced_subgraph(data, alive)
        cand = np.asarray(candidates)[alive]
        if obsv.enabled():
            compact_span.set_attrs(n_alive=stats.vertices_after)
    if khop > 1 and sub.n_vertices <= search_vertex_cap:
        with obsv.span("query.refine", khop=khop):
            t_ref = time.perf_counter()
            cand = refine_candidates_khop(sub, query, cand, k_max=khop,
                                          device=dev)
            stats.filter_seconds += time.perf_counter() - t_ref
    stats.candidate_pairs = int(cand.sum())

    order = None
    if planner is not None:
        with obsv.span("query.plan") as plan_span:
            t_plan = time.perf_counter()
            plan = planner.plan(query, candidate_counts=cand.sum(axis=0))
            order = plan.order
            stats.extras["plan"] = obsv.PlanReport(
                order=tuple(plan.order),
                source=plan.source,
                est_cost=float(plan.est_cost),
                fingerprint=plan.fingerprint,
                plan_seconds=time.perf_counter() - t_plan,
            ).validate()
            plan_span.set_attrs(source=plan.source)

    t1 = time.perf_counter()
    if sub.n_vertices > search_vertex_cap:
        raise ValueError(
            f"filtered graph has {sub.n_vertices} vertices > cap "
            f"{search_vertex_cap}; raise search_vertex_cap"
        )
    with obsv.span("query.enumerate", searcher=searcher,
                   enumerator=enumerator) as enum_span:
        if searcher == "dfs":
            emb = host_dfs_search(sub, query, cand, order=order,
                                  max_embeddings=max_embeddings)
        elif enumerator == "device":
            enum_report: dict = {}
            if mesh is not None:
                emb = sharded_device_join_search(
                    sub, query, cand, mesh=mesh, axis=shard_axis, order=order,
                    max_embeddings=max_embeddings, report=enum_report)
            else:
                emb = device_join_search(sub, query, cand, order=order,
                                         max_embeddings=max_embeddings,
                                         report=enum_report, device=dev)
            # from_dict is the schema checkpoint of every exit path
            stats.extras["enum"] = obsv.EnumReport.from_dict(enum_report)
        else:
            emb = bfs_join_search(sub, query, cand, order=order,
                                  max_embeddings=max_embeddings, device=dev)
        enum_span.set_attrs(n_embeddings=int(emb.shape[0]))
    stats.search_seconds = time.perf_counter() - t1
    stats.n_embeddings = int(emb.shape[0])
    return old_ids[emb] if emb.size else emb


def check_engine_args(data, mesh, shard_axis: str, enumerator: str, *,
                      ooc_mesh_error: str) -> GraphSnapshot:
    """The engines' shared argument checks; returns ``data`` as a snapshot.

    A ``Graph``, a store or a ``GraphSnapshot`` is accepted; ``mesh`` is a
    ``ShardMesh`` over ``shard_axis``; an out-of-core snapshot runs on one
    device (``ooc_mesh_error`` names the engine) and needs its store's
    incremental index; the enumerator must be known.
    """
    snap = as_snapshot(data)
    if mesh is not None:
        mesh_shards(mesh, shard_axis)
    if snap.ooc is not None and mesh is not None:
        raise ValueError(ooc_mesh_error)
    if snap.ooc is not None and snap.index is None:
        raise ValueError(
            "OutOfCoreGraphStore needs an attached incremental index — its "
            "digests drive the chunk prefilter (construct the store with "
            "index='auto')")
    if enumerator not in ("host", "device"):
        raise ValueError(
            f"enumerator must be 'host' or 'device', got {enumerator!r}"
        )
    return snap


class SubgraphQueryEngine:
    """CNI-filter + join-search engine over one data graph.

    ``data``: a ``repro_torch`` ``Graph``, a ``GraphStore`` (its snapshot
    at construction) or a pinned ``GraphSnapshot``; the graph moves to
    ``device`` once.  When the snapshot carries an incremental index, each
    query's ILGF starts from ``store_prefilter``'s mask, computed from the
    maintained digests (``stats.extras["store_prefilter_alive"]`` counts
    it).  ``device``: ``None`` means ``"cuda"`` (raises without a card);
    pass ``"cpu"`` to run on the host.  ``planner``: an optional
    ``core.planner.QueryPlanner`` for the matching order.
    ``enumerator``: ``"host"`` (default) or ``"device"`` — the two-phase
    count → scan → emit join, with its telemetry in
    ``stats.extras["enum"]``.

    An out-of-core store or snapshot (``graphs/ooc.py``) prefilters from
    the index first, fetches only the edge chunks the mask touches, and
    runs ILGF and the search on that restricted graph with the store's
    resident ``d_max``; the chunk-IO telemetry lands in
    ``stats.extras["ooc"]``.

    ``mesh``: a ``core.distributed.ShardMesh``; the filter then runs
    vertex-partitioned across it (``distributed_ilgf``, consuming a
    ``ShardedGraphStore``'s per-shard tables when the snapshot carries
    them, prepared once here), with ``stats.extras["shards"]``, and with
    ``enumerator="device"`` the join runs row-partitioned too
    (``sharded_device_join_search``).  Results equal the unmeshed engine's
    bit for bit.  An out-of-core store runs without a mesh.
    """

    def __init__(
        self,
        data,
        *,
        filter_variant: Literal["cni", "cni_log", "nlf", "label_degree",
                                "mnd_nlf"] = "cni",
        khop: int = 1,
        searcher: Literal["join", "dfs"] = "join",
        search_vertex_cap: int = 8192,
        mesh=None,
        shard_axis: str = "data",
        planner=None,
        enumerator: Literal["host", "device"] = "host",
        device=None,
    ):
        snap = check_engine_args(
            data, mesh, shard_axis, enumerator, ooc_mesh_error=(
                "out-of-core stores run single-host (resident digests + "
                "chunk fetch); build the engine without mesh="))
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
        self.planner = planner
        self.enumerator = enumerator
        self.mesh = mesh
        self.shard_axis = shard_axis
        self._prepared = None
        if mesh is not None:
            # bucket the vertex partition once (from a sharded store's own
            # tables when the snapshot has them); every query reuses it
            self._prepared = prepare_sharded_edges(
                snap._replace(graph=self.data), mesh, shard_axis)

    def query(self, q: Graph, *, max_embeddings: int | None = None):
        """Returns (embeddings (M, |V(Q)|) int64 over original ids, stats).

        With an active tracer each call opens one ``query`` span with
        ``query.filter`` / ``query.enumerate`` children.
        """
        with obsv.span("query", n_vertices=self.data.n_vertices,
                       ooc=self._ooc is not None):
            stats = QueryStats(vertices_before=self.data.n_vertices)
            t0 = time.perf_counter()
            alive0 = None
            if self._index is not None:
                # imported here: incremental imports the batch engine,
                # which imports this module
                from repro_torch.core.incremental import store_prefilter

                alive0 = store_prefilter(self._index, q,
                                         variant=self.filter_variant)
                stats.extras["store_prefilter_alive"] = int(alive0.sum())
            data, host_data = self.data, self._host_data
            if self._ooc is not None:
                # the digests prefilter first; only the chunks the mask
                # touches are read (one copy of the mask to the host, C5)
                restricted, stats.extras["ooc"] = self._ooc.fetch_restricted(
                    alive0.cpu().numpy())
                data = graph_to(restricted, self.device)
                host_data = to_host(data)
            if self.mesh is not None:
                res = distributed_ilgf(
                    data, q, self.mesh, axis=self.shard_axis,
                    variant=self.filter_variant, alive0=alive0,
                    prepared=self._prepared)
                stats.extras["shards"] = self.mesh.n_shards
            else:
                res = ilgf(data, q, variant=self.filter_variant,
                           alive0=alive0, d_max=(self._ooc.d_max if self._ooc
                                                 is not None else None))
            alive = res.alive.cpu().numpy()
            candidates = res.candidates.cpu().numpy()
            stats.ilgf_iterations = res.iterations
            stats.filter_seconds = time.perf_counter() - t0
            obsv.span_at("query.filter", t0, t0 + stats.filter_seconds,
                         iterations=stats.ilgf_iterations,
                         alive=int(alive.sum()))
            emb = search_filtered(
                host_data, q, alive, candidates, stats,
                khop=self.khop,
                searcher=self.searcher,
                search_vertex_cap=self.search_vertex_cap,
                max_embeddings=max_embeddings,
                planner=self.planner,
                enumerator=self.enumerator,
                mesh=self.mesh,
                shard_axis=self.shard_axis,
                device=self.device,
            )
            return emb, stats
