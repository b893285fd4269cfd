"""Epoch-consistent replica routing: N readers, one writer, shared pins
(port of ``repro.serve.replicas``; in-process, on the store's device).

``ReplicatedGraphService`` scales the query side of
``GraphQueryService`` horizontally over **one** mutable store:

* **N read replicas** — independent ``GraphQueryService`` instances (each
  with its own slot arrays, scheduler and metrics registry) over the *same*
  ``BaseGraphStore``.  They share its snapshot cache, so replicas serve the
  identical epoch-versioned views; there is no per-replica copy of the
  graph or the index.
* **A single writer** — mutations route through replica 0 only (the other
  replicas are marked read-only and raise on direct mutation), so the
  epoch sequence is a single total order and the ``d_max`` soundness
  invariant plus the durable-snapshot stream (``checkpoint_dir`` is
  stripped from non-writer configs) have exactly one owner.
* **Epoch-consistent routing** — pins are refcounts *on the shared store*:
  a query in flight on any replica pins its admit-time epoch against
  mutations routed through the writer.  Because every replica pins from
  the same store, a submit after a mutation is admitted at an epoch ≥ that
  mutation on *whichever* replica the router picks — readers can never
  time-travel behind the writer.

Routing picks the least-loaded replica (queued + active), round-robin on
ties.  Request ids are router-global: results from any replica are
translated back before they reach the caller.  Admission control is
per-replica (each enforces its own ``max_queue_depth`` / ``tenant_quota``
slice); a typed ``AdmissionRejected`` from the chosen replica propagates
to the caller unchanged — backpressure stays visible, never silently
rerouted into an unbounded pile-up.
"""

from __future__ import annotations

import dataclasses

from repro_torch.graphs.store import BaseGraphStore
from repro_torch.serve.graph_service import (
    DrainTimeout,
    GraphQueryService,
    GraphServiceConfig,
)


class ReplicatedGraphService:
    """Round-robin/least-loaded router over N replicas of one store."""

    def __init__(self, store: BaseGraphStore,
                 cfg: GraphServiceConfig | None = None, *,
                 n_replicas: int = 2):
        if not isinstance(store, BaseGraphStore):
            raise TypeError(
                "ReplicatedGraphService needs a mutable BaseGraphStore "
                f"(shared snapshots + a writer), got {type(store).__name__}"
            )
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        cfg = cfg if cfg is not None else GraphServiceConfig()
        self.store = store
        self.replicas: list[GraphQueryService] = []
        for i in range(n_replicas):
            # exactly one durable-snapshot stream: the writer's
            rcfg = (cfg if i == 0
                    else dataclasses.replace(cfg, checkpoint_dir=None))
            svc = GraphQueryService(store, rcfg)
            if i > 0:
                svc._read_only = True
            self.replicas.append(svc)
        self._next = 0  # round-robin tiebreak cursor
        self._grid = 0  # router-global request ids
        self._to_local: dict[int, tuple[int, int]] = {}
        self._to_global: dict[tuple[int, int], int] = {}

    # -- topology -------------------------------------------------------------

    @property
    def writer(self) -> GraphQueryService:
        return self.replicas[0]

    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def epoch(self) -> int:
        return self.store.epoch

    @property
    def n_active(self) -> int:
        return sum(r.n_active for r in self.replicas)

    @property
    def queue_depth(self) -> int:
        return sum(len(r.queue) for r in self.replicas)

    # -- read path ------------------------------------------------------------

    def submit(self, query, max_embeddings=None, **kwargs) -> int:
        """Route one query to the least-loaded replica; returns a
        router-global request id.  ``AdmissionRejected`` from the chosen
        replica propagates (its ``rid`` is replica-local — the request was
        never admitted anywhere)."""
        n = len(self.replicas)
        i = min(
            range(n),
            key=lambda j: (
                len(self.replicas[j].queue) + self.replicas[j].n_active,
                (j - self._next) % n,
            ),
        )
        local = self.replicas[i].submit(query, max_embeddings, **kwargs)
        self._next = (i + 1) % n
        self._grid += 1
        self._to_local[self._grid] = (i, local)
        self._to_global[(i, local)] = self._grid
        return self._grid

    def _xlate(self, i: int, triples):
        return [
            (self._to_global.get((i, rid), rid), emb, stats)
            for rid, emb, stats in triples
        ]

    def tick(self):
        """One scheduler step on every replica; merged finished triples."""
        out = []
        for i, r in enumerate(self.replicas):
            out.extend(self._xlate(i, r.tick()))
            # a replica only GCs its epoch cache on ITS mutations — which a
            # read replica never performs; sweep here so stale snapshots of
            # superseded epochs don't accumulate on the read path
            r._gc_epochs()
        return out

    def run_to_completion(self, max_ticks: int = 100_000):
        """Drain every replica; same ``DrainTimeout`` contract as the
        single-service method (partial results on ``err.finished``)."""
        done = []
        for _ in range(max_ticks):
            done.extend(self.tick())
            if self._drained():
                return done
        if self._drained():
            return done
        raise DrainTimeout(
            f"run_to_completion: {self.queue_depth} queued and "
            f"{self.n_active} in-flight requests remain across "
            f"{len(self.replicas)} replicas after {max_ticks} ticks",
            finished=done,
        )

    def _drained(self) -> bool:
        return all(
            not r.queue and r.n_active == 0 for r in self.replicas
        )

    # -- write path (single writer) -------------------------------------------

    def add_edges(self, edges, elabels=None):
        """Insert edges through the single writer; every replica admits at
        the new epoch from the next tick on (shared store, shared pins)."""
        res = self.writer.add_edges(edges, elabels)
        for r in self.replicas[1:]:
            r._gc_epochs()
        return res

    def remove_edges(self, edges):
        res = self.writer.remove_edges(edges)
        for r in self.replicas[1:]:
            r._gc_epochs()
        return res

    # -- lifecycle ------------------------------------------------------------

    def shutdown(self, *, drain: bool = True, max_ticks: int = 100_000):
        """Shut down every replica: merged ``(finished, cancelled)`` with
        router-global rids; nothing is silently dropped on any replica."""
        finished, cancelled = [], []
        for i, r in enumerate(self.replicas):
            f, c = r.shutdown(drain=drain, max_ticks=max_ticks)
            finished.extend(self._xlate(i, f))
            cancelled.extend(
                rec._replace(rid=self._to_global.get((i, rec.rid), rec.rid))
                for rec in c
            )
        return finished, cancelled

    # -- observability --------------------------------------------------------

    def metrics_snapshot(self) -> dict:
        """Per-replica metric snapshots, keyed ``replica_<i>``."""
        return {
            f"replica_{i}": r.metrics_snapshot()
            for i, r in enumerate(self.replicas)
        }
