"""Request-queue front end for subgraph queries over a mutable graph, port
of ``repro.serve.graph_service``.

A fixed pool of ``max_slots`` query slots with static padded shapes
``(S, V)`` / ``(S, U_cap, L_cap)``, as tensors on the store's device:

* ``submit`` enqueues a query; ``_admit`` moves queued queries into free
  slots (their padded digest rows, built on the host, are written into the
  slot tensors).  When the backing ``GraphStore`` carries an incremental
  index, the slot's starting alive mask is the store-digest prefilter,
  combined with the label mask on the device.
* ``tick()`` runs one ``batched_ilgf_round`` per distinct pinned epoch
  among the active slots (normally one), which on a CUDA graph launches
  ``cni_encode`` and ``candidate_filter``, then reads the round's
  ``changed`` flags on the host, the tick's one sync per epoch group.  A
  slot whose alive mask did not change has reached its fixed point: its
  candidates are final, the search runs on the host copy of the pinned
  epoch's graph (``search_filtered``: compaction, then the join, whose
  ``enumerator="device"`` launches the ``embed_join`` kernels), the result
  is emitted and the slot frees.
* ``add_edges`` / ``remove_edges`` mutate the store between ticks (an
  indexed store launches ``cni_update``).  Each request is pinned to the
  epoch it was admitted on: its rounds, candidates and search all read
  that immutable snapshot.  Snapshots are refcounted on the store and
  released when their last pinned request finishes.
* ``shutdown()`` drains (or cancels) active slots and reports every
  queued request as cancelled; nothing is silently dropped.
* **Admission control**: the queue is bounded (``max_queue_depth``),
  per-tenant quotas cap one tenant's queued + active load, and free slots
  admit by (priority desc, deadline asc, FIFO).  Overload raises the typed
  ``AdmissionRejected`` (recorded in ``rejections`` and in
  ``repro_service_rejected_total``), and queued requests whose deadline
  lapses expire into ``expired``.
* **Durable snapshots** (``serve/persist.py``): with
  ``GraphServiceConfig(checkpoint_dir=...)`` the store and its index
  persist every ``checkpoint_every`` epochs; ``GraphQueryService.restore``
  warm-starts a service from the newest committed snapshot.
* **Out-of-core stores** (``graphs/ooc.py``): an admission widens its
  pinned epoch's restricted graph to cover the slot's prefilter mask (one
  chunk fetch when the mask adds vertices), and the rounds and the search
  read that graph.  The fetches' ``OocReport``s add up per epoch, feed the
  ``repro_ooc_*`` counters and ride on results and cancellations; a
  ``ChunkIOError`` fails its request closed (recorded in ``failures``,
  the pin released) and propagates.

A service built from a ``Graph`` or a snapshot runs on ``device``
(``None`` means ``"cuda"``); a store-backed one runs where its store does.
With ``GraphServiceConfig(mesh=...)`` (a ``core.distributed.ShardMesh``)
each tick's round runs vertex-partitioned
(``sharded_batched_ilgf_round``) over the pinned epoch's shard buckets,
prepared once per epoch (from a ``ShardedGraphStore``'s own tables when
the snapshot carries them), and with ``enumerator="device"`` each finalize
enumerates row-partitioned; results equal the unmeshed service's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import obsv
from repro_torch.checkpoint import CheckpointError
from repro_torch.configs.cni_engine import CONFIG as _ENGINE_CONFIG
from repro_torch.core import filters as flt
from repro_torch.core.batch_engine import (
    BatchedQueries,
    batched_ilgf_round,
    prepare_padded_query,
)
from repro_torch.core.cni import default_max_p
from repro_torch.core.distributed import (
    mesh_shards,
    prepare_sharded_edges,
    sharded_batched_ilgf_round,
)
from repro_torch.core.engine import QueryStats, search_filtered
from repro_torch.core.incremental import store_prefilter
from repro_torch.core.planner import QueryPlanner
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, graph_to, max_degree, to_host
from repro_torch.graphs.io import ChunkIOError
from repro_torch.graphs.store import BaseGraphStore, GraphSnapshot, as_snapshot
from repro_torch.serve.persist import ServiceCheckpointer


@dataclasses.dataclass
class GraphServiceConfig:
    """Slot shapes default to the engine preset (``configs/cni_engine.py``)
    so service deployments and the batch engine agree."""

    max_slots: int = _ENGINE_CONFIG.service_slots
    max_query_vertices: int = _ENGINE_CONFIG.service_max_query_vertices
    max_query_labels: int = _ENGINE_CONFIG.service_max_query_labels
    filter_variant: str = _ENGINE_CONFIG.filter_variant
    khop: int = _ENGINE_CONFIG.khop
    searcher: str = _ENGINE_CONFIG.searcher
    # "host" | "device": the join of each finalize (embeddings are equal
    # either way); "device" records its telemetry in stats.extras["enum"]
    enumerator: str = _ENGINE_CONFIG.enumerator
    search_vertex_cap: int = 8192
    max_rounds_per_query: int = 1_000  # safety valve: finalize early (sound)
    # a core.distributed.ShardMesh: ticks run the vertex-partitioned round,
    # finalize with enumerator="device" the row-partitioned join (results
    # equal either way); a ShardedGraphStore with the mesh's shard count
    # gives its per-shard tables directly
    mesh: object = None
    shard_axis: str = _ENGINE_CONFIG.distributed_axis
    # cost-based matching orders (core/planner.py): one QueryPlanner, hence
    # one epoch-aware plan cache, shared across every tick and slot;
    # ``planner`` overrides it with a caller-owned instance
    plan_queries: bool = False
    planner: object = None
    # admission control: ``max_queue_depth`` bounds the queue (None =
    # unbounded), ``tenant_quota`` caps one tenant's queued + active
    # requests (None = no cap)
    max_queue_depth: int | None = 1024
    tenant_quota: int | None = None
    # durable snapshots (serve/persist.py): at construction and every
    # ``checkpoint_every`` epochs after a mutation
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    checkpoint_keep: int = 3
    checkpoint_async: bool = True


class AdmissionRejected(RuntimeError):
    """Typed backpressure from ``submit``: the request was not enqueued.

    ``reason`` is ``"queue_full"`` or ``"tenant_quota"``; ``rid`` identifies
    the rejection in ``GraphQueryService.rejections``.
    """

    def __init__(self, message: str, *, rid: int, reason: str, tenant: str):
        super().__init__(message)
        self.rid = rid
        self.reason = reason
        self.tenant = tenant


class DrainTimeout(RuntimeError):
    """``run_to_completion`` spent ``max_ticks`` with work remaining; the
    triples finished before that ride on ``err.finished``."""

    def __init__(self, message: str, *, finished: list):
        super().__init__(message)
        self.finished = finished


class RejectedRequest(NamedTuple):
    """One admission rejection, recorded."""

    rid: int
    reason: str   # "queue_full" | "tenant_quota"
    tenant: str


@dataclasses.dataclass
class _Request:
    rid: int
    query: Graph
    max_embeddings: Optional[int]
    submitted_at: float
    rounds: int = 0
    filter_seconds: float = 0.0  # wall time of this request's filter rounds
    slot: int = -1
    epoch: int = -1
    span: object = None  # obsv.Span root, open from admit to finalize
    tenant: str = "default"
    priority: int = 0
    deadline: Optional[float] = None  # absolute perf_counter() time


class CancelledRequest(NamedTuple):
    """A request the service gave up on, reported.  ``ooc``: the pinned
    epoch's accumulated chunk-IO ``OocReport`` for a request cancelled
    after admission over an out-of-core store; None otherwise."""

    rid: int
    reason: str
    queued_seconds: float
    ooc: object = None


class FailedRequest(NamedTuple):
    """A request that died on the fail-closed path (a ``ChunkIOError`` of
    an out-of-core fetch), recorded before the error propagates, with its
    queue wait and the fetch's partial ``OocReport``."""

    rid: int
    reason: str
    queued_seconds: float
    ooc: object = None


class _EpochEntry(NamedTuple):
    snapshot: GraphSnapshot
    host_graph: Graph  # numpy copy of the snapshot graph, for the search
    sharded: Optional[tuple] = None  # (ShardedEdges, PartitionPlan), meshed


class GraphQueryService:
    """Continuous-batching subgraph-query service over one mutable graph.

    ``data`` may be a ``Graph`` (static service, mutations raise), a
    ``GraphStore`` (live updates via ``add_edges`` / ``remove_edges``), or
    a ``GraphSnapshot``.  ``device`` places a ``Graph`` or a snapshot's
    graph (``None`` means ``"cuda"``); a store-backed service runs on the
    store's device.
    """

    def __init__(self, data, cfg: GraphServiceConfig | None = None, *,
                 device=None):
        self.store: BaseGraphStore | None = (
            data if isinstance(data, BaseGraphStore) else None)
        snap = as_snapshot(data)
        self.cfg = cfg or GraphServiceConfig()
        self._ooc = snap.ooc
        if self.cfg.mesh is not None:
            mesh_shards(self.cfg.mesh, self.cfg.shard_axis)
        if self._ooc is not None and self.cfg.mesh is not None:
            raise ValueError(
                "out-of-core stores run single-host: the chunk prefilter "
                "fetches a per-epoch restricted edge set that is not "
                "mesh-partitioned; drop GraphServiceConfig.mesh")
        if self._ooc is not None and snap.index is None:
            raise ValueError(
                "OutOfCoreGraphStore needs an attached incremental index — "
                "its digests drive the chunk prefilter (construct the store "
                "with index='auto')")
        if self.store is not None:
            self.device = self.store.device
            if device is not None and torch.device(device).type != \
                    self.device.type:
                raise ValueError(
                    f"a store-backed service runs on its store's device "
                    f"({self.device}), not {device!r}")
        else:
            self.device = resolve_device(device)
            snap = snap._replace(graph=graph_to(snap.graph, self.device))
        self.data = snap.graph
        if self.store is not None and self.store.degree_cap is not None:
            self.d_max = int(self.store.degree_cap)
        elif self._ooc is not None:
            # an out-of-core snapshot's graph has no edges; the resident
            # degrees carry the true bound
            self.d_max = self._ooc.d_max
            if self.store is not None:
                self.store.degree_cap = self.d_max
        else:
            self.d_max = max(1, max_degree(snap.graph))
            if self.store is not None:
                # the service's static table bound becomes the store's
                # degree_cap: apply() then rejects an over-cap batch before
                # any state mutates
                self.store.degree_cap = self.d_max
        self.max_p = default_max_p(self.d_max, self.cfg.max_query_labels)
        s = self.cfg.max_slots
        u = self.cfg.max_query_vertices
        l = self.cfg.max_query_labels
        v = snap.graph.n_vertices
        dev = self.device
        self.n_vertices = v
        self._ords = torch.zeros((s, v), dtype=torch.int32, device=dev)
        self._counts = torch.zeros((s, u, l), dtype=torch.int32, device=dev)
        self._digest = flt.VertexDigest(
            ord_label=torch.zeros((s, u), dtype=torch.int32, device=dev),
            deg=torch.zeros((s, u), dtype=torch.int32, device=dev),
            cni=torch.zeros((s, u), dtype=torch.int64, device=dev),
            cni_log=torch.full((s, u), -torch.inf, dtype=torch.float32,
                               device=dev),
        )
        self._mnd = torch.zeros((s, u), dtype=torch.int32, device=dev)
        self._alive = torch.zeros((s, v), dtype=torch.bool, device=dev)
        self.active: list[Optional[_Request]] = [None] * s
        self.queue: list[_Request] = []
        self._rid = 0
        self._epochs: dict[int, _EpochEntry] = {}
        self._shutting_down = False
        self.failures: list[FailedRequest] = []
        self.rejections: list[RejectedRequest] = []
        self.expired: list[CancelledRequest] = []
        # out-of-core bookkeeping by pinned epoch: the union of the
        # admitted slots' prefilter masks (the restricted graph covers all
        # of them) and the accumulated fetch telemetry
        self._ooc_cover: dict[int, np.ndarray] = {}
        self._ooc_tel: dict[int, obsv.OocReport] = {}
        # always-on service metrics (host-side dict/bisect updates), with
        # the reference's names; scrape via ``metrics_text()``
        self.metrics = obsv.MetricsRegistry()
        m = self.metrics
        self._m_queue_wait = m.histogram(
            "repro_service_queue_wait_seconds",
            "Submit-to-admission wait per request",
            start=1e-5, factor=4.0, count=14,
        )
        self._m_stage = m.histogram(
            "repro_service_stage_seconds",
            "Per-stage latency (label stage: filter|plan|enumerate|total)",
            start=1e-5, factor=4.0, count=14,
        )
        self._m_requests = m.counter(
            "repro_service_requests_total",
            "Requests by terminal status (completed|failed|cancelled)",
        )
        self._m_ticks = m.counter(
            "repro_service_ticks_total", "Scheduler ticks run")
        self._m_admitted = m.counter(
            "repro_service_admitted_total", "Requests admitted into slots")
        self._m_embeddings = m.counter(
            "repro_service_embeddings_total", "Embeddings emitted to callers")
        self._m_rounds = m.counter(
            "repro_service_rounds_total", "Batched peeling rounds dispatched")
        self._m_active = m.gauge(
            "repro_service_active_slots", "Currently occupied query slots")
        self._m_rejected = m.counter(
            "repro_service_rejected_total",
            "Admission rejections by reason (queue_full|tenant_quota)",
        )
        self._m_deadline_miss = m.counter(
            "repro_service_deadline_missed_total",
            "Requests expired in queue or completed past their deadline",
        )
        self._m_queue_depth = m.gauge(
            "repro_service_queue_depth", "Currently queued requests")
        self._m_queue_depth_hist = m.histogram(
            "repro_service_queue_depth_ticks",
            "Queue depth sampled at each scheduler tick",
            start=1.0, factor=2.0, count=16,
        )
        self._m_ckpts = m.counter(
            "repro_service_checkpoints_total", "Durable snapshots written")
        # chunk IO of the out-of-core fetches (0 over an in-memory store)
        self._m_ooc_chunks = m.counter(
            "repro_ooc_chunks_read_total",
            "Chunk accesses during restricted fetches")
        self._m_ooc_bytes = m.counter(
            "repro_ooc_bytes_read_total", "Bytes read from chunk files")
        self._m_ooc_hits = m.counter(
            "repro_ooc_cache_hits_total", "Chunk-cache hits")
        self._m_ooc_misses = m.counter(
            "repro_ooc_cache_misses_total", "Chunk-cache misses (disk reads)")
        self._m_hit_ratio = m.gauge(
            "repro_ooc_cache_hit_ratio",
            "Lifetime chunk-cache hit ratio of the backing store")
        self._m_rss = m.gauge(
            "repro_process_peak_rss_bytes",
            "Host-level canary: process peak resident set size",
        )
        self.planner = None
        if self.cfg.planner is not None:
            self.planner = self.cfg.planner
        elif self.cfg.plan_queries:
            # the live store's index keeps its GraphStats current, so the
            # plan cache invalidates on real drift
            self.planner = QueryPlanner.for_data(
                self.store if self.store is not None else snap)
        self._ckpt = None
        self._ckpt_last_epoch: int | None = None
        if self.cfg.checkpoint_dir is not None:
            if self.store is None:
                raise ValueError(
                    "checkpoint_dir needs a store-backed service — an "
                    "immutable Graph has no durable state to snapshot")
            self._ckpt = ServiceCheckpointer(
                self.cfg.checkpoint_dir, keep=self.cfg.checkpoint_keep,
                async_write=self.cfg.checkpoint_async)
            # the base state is durable from construction
            self._ckpt_last_epoch = self._ckpt.save(self.store)
            self._m_ckpts.inc()
        self._cache_epoch(snap)

    @classmethod
    def restore(cls, directory: str, cfg: "GraphServiceConfig | None" = None,
                *, storage_dir: str | None = None,
                device=None) -> "GraphQueryService":
        """Warm-start a service from the newest durable snapshot.

        Rebuilds the store, its incremental index and the planner stats
        from the latest committed step under ``directory``, on ``device``
        (``None`` means ``"cuda"``): no index rebuild, same epoch, same
        digests.  ``storage_dir`` relocates an out-of-core snapshot's
        chunk-directory root.  Raises ``CheckpointError`` when the
        directory holds no committed snapshot or the snapshot fails
        validation.  Unless ``cfg`` says otherwise, the restored service
        keeps checkpointing into the same directory.
        """
        _, store = ServiceCheckpointer(directory).restore_latest(
            storage_dir=storage_dir, device=device)
        if store is None:
            raise CheckpointError(
                f"{directory} holds no committed service snapshot")
        cfg = cfg if cfg is not None else GraphServiceConfig()
        if cfg.checkpoint_dir is None:
            cfg = dataclasses.replace(cfg, checkpoint_dir=directory)
        return cls(store, cfg)

    # -- epoch/snapshot management -------------------------------------------

    def _cache_epoch(self, snap: GraphSnapshot) -> _EpochEntry:
        entry = self._epochs.get(snap.epoch)
        if entry is None:
            sharded = None
            if self.cfg.mesh is not None:
                # partition this epoch's edge set once; every tick on the
                # epoch reuses the buckets
                sharded = prepare_sharded_edges(
                    snap, self.cfg.mesh, self.cfg.shard_axis)[:2]
            entry = _EpochEntry(snapshot=snap, host_graph=to_host(snap.graph),
                                sharded=sharded)
            self._epochs[snap.epoch] = entry
        return entry

    def _pin_current(self) -> _EpochEntry:
        if self.store is not None:
            return self._cache_epoch(self.store.pin())
        return self._epochs[min(self._epochs)]

    def _release_epoch(self, epoch: int) -> None:
        if self.store is None:
            return
        self.store.release(epoch)
        self._gc_epochs()

    def _gc_epochs(self) -> None:
        """Drop cached epochs no in-flight request pins (keep the latest)."""
        pinned = {r.epoch for r in self.active if r is not None}
        for ep in list(self._epochs):
            if ep not in pinned and ep != self.epoch:
                self._epochs.pop(ep)
        for d in (self._ooc_cover, self._ooc_tel):
            for ep in list(d):
                if ep not in self._epochs:
                    del d[ep]

    def _ensure_ooc_cover(self, epoch: int, alive_row: np.ndarray) -> None:
        """Grow the epoch's restricted graph to cover one more seed mask.

        An out-of-core epoch's cached graph holds the edges among the union
        of the seeds admitted so far.  A slot's alive mask only shrinks
        inside its seed, and every round masks counts by alive at both
        endpoints, so a wider graph gives every earlier slot the same
        rounds.  A refetch replaces the entry; its telemetry adds to the
        epoch's report and the ``repro_ooc_*`` counters.
        """
        entry = self._epochs[epoch]
        cover = self._ooc_cover.get(epoch)
        if cover is not None and not np.any(alive_row & ~cover):
            return
        new_cover = alive_row.copy() if cover is None else (cover | alive_row)
        restricted, tel = entry.snapshot.ooc.fetch_restricted(new_cover)
        self._ooc_cover[epoch] = new_cover
        agg = self._ooc_tel.get(epoch)
        self._ooc_tel[epoch] = tel if agg is None else agg.merge(tel)
        self._m_ooc_chunks.inc(tel.chunks_read)
        self._m_ooc_bytes.inc(tel.bytes_read)
        self._m_ooc_hits.inc(tel.cache_hits)
        self._m_ooc_misses.inc(tel.cache_misses)
        restricted = graph_to(restricted, self.device)
        self._epochs[epoch] = _EpochEntry(
            snapshot=entry.snapshot._replace(graph=restricted),
            host_graph=to_host(restricted))

    # -- public API ----------------------------------------------------------

    def submit(self, query: Graph, max_embeddings: int | None = None, *,
               tenant: str = "default", priority: int = 0,
               deadline_seconds: float | None = None) -> int:
        """Enqueue a query; returns its request id.

        Raises ``ValueError`` for a query past the static slot shapes, and
        ``AdmissionRejected`` (also recorded in ``rejections``) for a full
        queue or an over-quota tenant.  ``priority`` (higher first) and
        ``deadline_seconds`` (sooner first; lapsed-in-queue requests expire
        into ``expired``) order the admission.
        """
        if self._shutting_down:
            raise RuntimeError("service is shut down; no new submissions")
        query = to_host(query)
        n_labels = int(np.unique(query.vlabels).size)
        if query.n_vertices > self.cfg.max_query_vertices:
            raise ValueError(
                f"query has {query.n_vertices} vertices > service cap "
                f"{self.cfg.max_query_vertices}")
        if n_labels > self.cfg.max_query_labels:
            raise ValueError(
                f"query has {n_labels} labels > service cap "
                f"{self.cfg.max_query_labels}")
        self._rid += 1
        if (self.cfg.max_queue_depth is not None
                and len(self.queue) >= self.cfg.max_queue_depth):
            raise self._reject(
                self._rid, "queue_full", tenant,
                f"queue depth {len(self.queue)} is at max_queue_depth="
                f"{self.cfg.max_queue_depth}; tick/drain and retry")
        if self.cfg.tenant_quota is not None:
            load = sum(r.tenant == tenant for r in self.queue) + sum(
                r is not None and r.tenant == tenant for r in self.active)
            if load >= self.cfg.tenant_quota:
                raise self._reject(
                    self._rid, "tenant_quota", tenant,
                    f"tenant {tenant!r} has {load} queued+active requests "
                    f">= tenant_quota={self.cfg.tenant_quota}")
        now = time.perf_counter()
        self.queue.append(_Request(
            self._rid, query, max_embeddings, now,
            tenant=tenant, priority=int(priority),
            deadline=(now + float(deadline_seconds)
                      if deadline_seconds is not None else None),
        ))
        self._m_queue_depth.set(len(self.queue))
        return self._rid

    def _reject(self, rid: int, reason: str, tenant: str,
                message: str) -> AdmissionRejected:
        self.rejections.append(RejectedRequest(rid, reason, tenant))
        self._m_rejected.inc(1, reason=reason)
        return AdmissionRejected(message, rid=rid, reason=reason,
                                 tenant=tenant)

    def add_edges(self, edges, elabels=None):
        """Insert edges into the backing store (between ticks).  In-flight
        queries keep their pinned epochs; later admissions see the edges."""
        return self._mutate("add_edges", edges, elabels)

    def remove_edges(self, edges):
        """Delete edges from the backing store (between ticks)."""
        return self._mutate("remove_edges", edges)

    def _mutate(self, op: str, edges, elabels=None):
        if self.store is None:
            raise RuntimeError(
                "service was constructed from an immutable Graph; build it "
                "from a GraphStore to take live updates")
        if getattr(self, "_read_only", False):
            raise RuntimeError(
                "this service is a read replica; route mutations through "
                "the router's writer (serve/replicas.py)")
        if op == "add_edges":
            res = self.store.add_edges(edges, elabels)
        else:
            res = self.store.remove_edges(edges)
        # unreachable while degree_cap <= d_max (apply validates first);
        # guards a cap widened behind the service's back.  A real raise,
        # not an assert: the slot digests are encoded against d_max, and
        # the guard must hold under ``python -O`` too
        if self.store.max_degree > self.d_max:
            raise RuntimeError(
                f"store max degree {self.store.max_degree} exceeds the "
                f"service's static d_max={self.d_max}")
        self._maybe_checkpoint()
        self._gc_epochs()
        return res

    def _maybe_checkpoint(self) -> None:
        if self._ckpt is None:
            return
        if self.epoch - self._ckpt_last_epoch >= self.cfg.checkpoint_every:
            self._ckpt.save(self.store)
            self._ckpt_last_epoch = self.epoch
            self._m_ckpts.inc()

    def checkpoint_now(self) -> int:
        """Force a durable snapshot of the current epoch; returns the step."""
        if self._ckpt is None:
            raise RuntimeError("no checkpoint_dir configured on this service")
        step = self._ckpt.save(self.store)
        self._ckpt_last_epoch = self.epoch
        self._m_ckpts.inc()
        return step

    def wait_for_checkpoints(self) -> None:
        """Block until the in-flight async snapshot write commits; a failed
        write re-raises as ``CheckpointError``."""
        if self._ckpt is not None:
            self._ckpt.wait()

    def tick(self) -> list[tuple[int, np.ndarray, QueryStats]]:
        """One scheduler step: one batched peeling round per pinned epoch.

        Returns the finished (rid, embeddings, stats) triples (possibly
        none).  Normally every active slot shares one epoch (one dispatch);
        after a mutation, old and new queries coexist on their own epochs
        until the old ones drain.
        """
        self._m_ticks.inc()
        self._m_queue_depth_hist.observe(float(len(self.queue)))
        self._m_queue_depth.set(len(self.queue))
        with obsv.span("service.tick", active=self.n_active,
                       queued=len(self.queue)):
            return self._tick()

    def _tick(self) -> list[tuple[int, np.ndarray, QueryStats]]:
        self._admit()
        live = [r for r in self.active if r is not None]
        if not live:
            return []
        finished = []
        alive_merged = self._alive
        for epoch in sorted({r.epoch for r in live}):
            group = [r for r in live if r.epoch == epoch]
            mask_np = np.zeros(self.cfg.max_slots, bool)
            for r in group:
                mask_np[r.slot] = True
            mask = torch.as_tensor(mask_np, device=self.device)[:, None]
            # slots outside this epoch group are inert for the dispatch
            # (zero ords: empty alive, no work)
            qb = BatchedQueries(
                ords=torch.where(mask, self._ords, 0),
                counts=self._counts, digest=self._digest, mnd=self._mnd,
            )
            entry = self._epochs[epoch]
            t_round = time.perf_counter()
            if entry.sharded is not None:
                se, plan = entry.sharded
                new_alive, cand, changed = sharded_batched_ilgf_round(
                    se, plan, qb, self._alive & mask, mesh=self.cfg.mesh,
                    axis=self.cfg.shard_axis,
                    n_labels=self.cfg.max_query_labels,
                    d_max=self.d_max, max_p=self.max_p,
                    variant=self.cfg.filter_variant,
                )
            else:
                new_alive, cand, changed = batched_ilgf_round(
                    entry.snapshot.graph, qb, self._alive & mask,
                    n_labels=self.cfg.max_query_labels,
                    d_max=self.d_max, max_p=self.max_p,
                    variant=self.cfg.filter_variant,
                )
            converged = ~changed.cpu().numpy()  # the group's one sync
            alive_merged = torch.where(mask, new_alive, alive_merged)
            self._m_rounds.inc()
            t_round_end = time.perf_counter()
            for req in group:
                req.rounds += 1
                req.filter_seconds += t_round_end - t_round
                # one dispatch serves the whole epoch group; the shared
                # round is mirrored into each member's request trace
                obsv.span_at("service.filter_round", t_round, t_round_end,
                             parent=req.span, round=req.rounds,
                             epoch=epoch, shared=len(group) > 1)
                if (converged[req.slot]
                        or req.rounds >= self.cfg.max_rounds_per_query):
                    finished.append(self._finalize(req, new_alive, cand))
                    self._free(req.slot)
        self._alive = alive_merged
        return finished

    def run_to_completion(self, max_ticks: int = 100_000):
        """Drain queue and slots; returns every finished triple.  Raises
        ``DrainTimeout`` (partial results on ``err.finished``) when
        ``max_ticks`` runs out with requests still queued or in flight."""
        done = []
        for _ in range(max_ticks):
            done.extend(self.tick())
            if not self.queue and all(a is None for a in self.active):
                return done
        if not self.queue and all(a is None for a in self.active):
            return done
        raise DrainTimeout(
            f"run_to_completion: {len(self.queue)} queued and "
            f"{self.n_active} in-flight requests remain after "
            f"{max_ticks} ticks",
            finished=done,
        )

    def shutdown(self, *, drain: bool = True, max_ticks: int = 100_000):
        """Stop the service: returns ``(finished, cancelled)``.

        ``drain=True`` finishes every admitted query first; queued requests
        are always cancelled and reported, and ``drain=False`` cancels the
        in-flight slots too.  A drain that spends ``max_ticks`` cancels the
        leftovers (reason ``"shutdown drain exhausted"``).  With a
        ``checkpoint_dir`` the final state is saved and the write waited
        on.  ``submit`` raises afterwards.
        """
        self._shutting_down = True  # _admit is disabled from here on
        finished: list = []
        cancelled: list[CancelledRequest] = []
        if drain:
            for _ in range(max_ticks):
                if all(a is None for a in self.active):
                    break
                finished.extend(self.tick())
        now = time.perf_counter()
        reason = ("shutdown drain exhausted" if drain
                  else "shutdown before completion")
        for req in [r for r in self.active if r is not None]:
            # the IO done on the request's behalf rides along
            cancelled.append(CancelledRequest(
                req.rid, reason, now - req.submitted_at,
                ooc=self._ooc_tel.get(req.epoch)))
            if req.span is not None:
                req.span.set_attrs(cancelled=True)
                obsv.end(req.span)
            self._free(req.slot)
        for req in self.queue:
            cancelled.append(CancelledRequest(
                req.rid, "shutdown before admission", now - req.submitted_at))
        self.queue.clear()
        self._m_requests.inc(len(cancelled), status="cancelled")
        if self._ckpt is not None:
            if self._ckpt_last_epoch != self.epoch:
                self._ckpt.save(self.store)
                self._ckpt_last_epoch = self.epoch
                self._m_ckpts.inc()
            self._ckpt.wait()
        return finished, cancelled

    def metrics_snapshot(self) -> dict:
        """Point-in-time value of every registered metric (plain dict)."""
        self._refresh_gauges()
        return self.metrics.snapshot()

    def metrics_text(self) -> str:
        """The registry in Prometheus exposition format."""
        self._refresh_gauges()
        return self.metrics.render_prometheus()

    def _refresh_gauges(self) -> None:
        self._m_active.set(self.n_active)
        self._m_queue_depth.set(len(self.queue))
        if self._ooc is not None:
            cache = self._ooc.cache
            acc = cache.hits + cache.misses
            self._m_hit_ratio.set(cache.hits / acc if acc else 0.0)
        try:
            import resource

            # ru_maxrss is KiB on Linux
            self._m_rss.set(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)
        except ImportError:  # pragma: no cover - platforms without it
            pass

    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self.active)

    @property
    def epoch(self) -> int:
        return self.store.epoch if self.store is not None else 0

    # -- internals -----------------------------------------------------------

    def _expire_queued(self, now: float) -> None:
        """Expire queued requests whose deadline lapsed: reported in
        ``expired`` and the deadline-miss counter, never admitted."""
        keep: list[_Request] = []
        for r in self.queue:
            if r.deadline is not None and now >= r.deadline:
                self.expired.append(CancelledRequest(
                    r.rid, "deadline expired before admission",
                    now - r.submitted_at))
                self._m_deadline_miss.inc()
                self._m_requests.inc(1, status="expired")
            else:
                keep.append(r)
        self.queue[:] = keep

    def _pick_queued(self) -> _Request:
        """Admission order: priority desc, then deadline asc (undeadlined
        last), then FIFO."""
        i = min(
            range(len(self.queue)),
            key=lambda j: (
                -self.queue[j].priority,
                self.queue[j].deadline
                if self.queue[j].deadline is not None else float("inf"),
                self.queue[j].submitted_at,
            ),
        )
        return self.queue.pop(i)

    def _admit(self):
        if self._shutting_down:
            return
        self._expire_queued(time.perf_counter())
        for slot in range(self.cfg.max_slots):
            if self.active[slot] is None and self.queue:
                req = self._pick_queued()
                req.slot = slot
                now = time.perf_counter()
                queue_s = now - req.submitted_at
                self._m_queue_wait.observe(queue_s)
                self._m_admitted.inc()
                # one detached root span per request, open across ticks
                # until finalize or cancel: the whole lifetime lands in one
                # trace tree
                req.span = obsv.start_detached("service.request", rid=req.rid)
                obsv.span_at("service.queue_wait", req.submitted_at, now,
                             parent=req.span, rid=req.rid)
                with obsv.activate(req.span), \
                        obsv.span("service.admit", slot=slot) as admit_span:
                    with obsv.span("service.epoch_pin"):
                        entry = self._pin_current()
                    req.epoch = entry.snapshot.epoch
                    admit_span.set_attrs(epoch=req.epoch)
                    self.active[slot] = req
                    self._load_slot(slot, req, entry, queue_s)

    def _load_slot(self, slot: int, req: _Request, entry: _EpochEntry,
                   queue_s: float):
        """Write the request's padded digest rows and starting alive mask
        into the slot tensors.  Over an out-of-core epoch the mask first
        widens the epoch's restricted graph; a ``ChunkIOError`` there is
        recorded in ``failures``, frees the slot (releasing its epoch pin)
        and propagates, and the service stays usable."""
        dev = self.device
        with obsv.span("service.ords"):
            ords, counts, digest, mnd = prepare_padded_query(
                req.query, entry.host_graph.vlabels, self.d_max, self.max_p,
                self.cfg.max_query_vertices, self.cfg.max_query_labels)
        ords_t = torch.as_tensor(ords, device=dev)
        alive_row = ords_t > 0
        if entry.snapshot.index is not None:
            # the maintained store digests stand in for round one
            alive_row &= store_prefilter(
                entry.snapshot.index, req.query,
                variant=self.cfg.filter_variant).to(dev)
        if entry.snapshot.ooc is not None:
            try:
                self._ensure_ooc_cover(req.epoch, alive_row.cpu().numpy())
            except ChunkIOError as err:
                tel = getattr(err, "tel", None)
                prior = self._ooc_tel.get(req.epoch)
                if prior is not None:
                    tel = prior if tel is None else prior.merge(tel)
                self.failures.append(FailedRequest(req.rid, str(err), queue_s,
                                                   ooc=tel))
                self._m_requests.inc(1, status="failed")
                if req.span is not None:
                    req.span.set_attrs(failed=True)
                    obsv.end(req.span)
                self._free(slot)
                raise
        self._ords[slot] = ords_t
        self._counts[slot] = torch.as_tensor(counts, device=dev)
        for acc, row in zip(self._digest, digest):
            acc[slot] = torch.as_tensor(row, device=dev)
        self._mnd[slot] = torch.as_tensor(mnd, device=dev)
        self._alive[slot] = alive_row

    def _finalize(self, req: _Request, alive, cand):
        u_q = req.query.n_vertices
        with obsv.activate(req.span), \
                obsv.span("service.readback") as readback_span:
            alive_np = alive[req.slot].cpu().numpy()
            cand_np = cand[req.slot, :, :u_q].cpu().numpy()
            if obsv.enabled():
                readback_span.set_attrs(rid=req.rid)
        stats = QueryStats(vertices_before=self.n_vertices,
                           ilgf_iterations=req.rounds)
        deadline_missed = (req.deadline is not None
                           and time.perf_counter() > req.deadline)
        if deadline_missed:
            self._m_deadline_miss.inc()
        stats.extras["service"] = obsv.ServiceReport(
            slot=req.slot,
            epoch=req.epoch,
            queue_seconds=time.perf_counter() - req.submitted_at,
            rounds=req.rounds,
            trace_id=req.span.trace_id if req.span is not None else None,
            tenant=req.tenant,
            priority=req.priority,
            deadline_missed=deadline_missed,
        ).validate()
        if req.epoch in self._ooc_tel:
            # the epoch's accumulated report (never mutated in place)
            stats.extras["ooc"] = self._ooc_tel[req.epoch]
        with obsv.activate(req.span), \
                obsv.span("service.finalize", rid=req.rid, rounds=req.rounds):
            emb = search_filtered(
                self._epochs[req.epoch].host_graph, req.query, alive_np,
                cand_np, stats,
                khop=self.cfg.khop,
                searcher=self.cfg.searcher,
                search_vertex_cap=self.cfg.search_vertex_cap,
                max_embeddings=req.max_embeddings,
                planner=self.planner,
                enumerator=self.cfg.enumerator,
                mesh=self.cfg.mesh,
                shard_axis=self.cfg.shard_axis,
                device=self.device,
            )
        if req.span is not None:
            req.span.set_attrs(n_embeddings=len(emb), rounds=req.rounds)
            obsv.end(req.span)
        self._m_requests.inc(1, status="completed")
        self._m_embeddings.inc(len(emb))
        # the request's own filter rounds (and any k-hop refinement)
        self._m_stage.observe(req.filter_seconds + stats.filter_seconds,
                              stage="filter")
        plan = stats.extras.get("plan")
        if plan is not None:
            self._m_stage.observe(float(plan["plan_seconds"]), stage="plan")
        self._m_stage.observe(stats.search_seconds, stage="enumerate")
        self._m_stage.observe(time.perf_counter() - req.submitted_at,
                              stage="total")  # submit to result
        return req.rid, emb, stats

    def _free(self, slot: int):
        req = self.active[slot]
        self.active[slot] = None
        if req is not None and req.epoch >= 0:
            self._release_epoch(req.epoch)
        self._ords[slot] = 0
        self._alive[slot] = False
