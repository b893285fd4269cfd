"""Cost-based query planner: matching-order optimization + plan caching,
port of ``repro.core.planner`` (host numpy, as in the reference).

* ``canonical_form`` runs 1-WL label refinement (with edge labels) over
  the query and serializes the relabeled graph; the plan cache keys on the
  full form, so a key match means byte-identical canonical adjacency.
* The cost of an order u1..uk is the total join work sum_t R_{t-1}·|C(u_t)|,
  with |C(u)| from the live post-filter candidate counts when given (else
  the label histogram of ``GraphStats``) and the surviving rows shrunk by
  the label-pair edge probabilities of each matched query edge.
* Beam search over connected extension orders, states deduplicated by
  placed-vertex set, ties broken on the order tuple.  Without stats the
  planner returns ``greedy_matching_order`` (the searchers' own rule) and
  caches nothing.
* ``PlanCache``: LRU keyed on ``(canonical form, stats bucket)``; a bucket
  move prunes every entry planned under another bucket.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.search import _host_adjacency, greedy_matching_order
from repro_torch.core.stats import GraphStats
from repro_torch.graphs.csr import as_numpy
from repro_torch.graphs.store import BaseGraphStore, as_snapshot

# ---------------------------------------------------------------------------
# Canonical query fingerprinting (label refinement).
# ---------------------------------------------------------------------------


def canonical_form(query) -> tuple[np.ndarray, bytes]:
    """Label-refined canonical ordering of a query graph.

    Returns ``(perm, form)``: ``perm[i]`` is the canonical position of query
    vertex ``i`` and ``form`` is the serialized canonical graph (vertex
    labels in canonical order + sorted canonical edge triples).  Isomorphic
    queries agree on ``form`` whenever refinement separates their orbits
    (always true for identically-numbered repeats — the serving hot case);
    equal forms always describe byte-identical canonical adjacency.
    """
    vlab = as_numpy(query.vlabels)
    n = int(vlab.shape[0])
    src = as_numpy(query.src)
    dst = as_numpy(query.dst)
    elab = as_numpy(query.elabels)
    nbrs: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for s, d, e in zip(src, dst, elab):
        nbrs[int(s)].append((int(e), int(d)))

    # 1-WL refinement: color = (old color, sorted multiset of
    # (edge label, neighbor color)); iterate until the partition is stable
    _, colors = np.unique(vlab, return_inverse=True)
    colors = colors.astype(np.int64)
    for _ in range(max(1, n)):
        sigs = [
            (int(colors[v]), tuple(sorted((e, int(colors[w]))
                                          for e, w in nbrs[v])))
            for v in range(n)
        ]
        uniq = sorted(set(sigs))
        rank = {s: i for i, s in enumerate(uniq)}
        new_colors = np.asarray([rank[s] for s in sigs], dtype=np.int64)
        if np.array_equal(new_colors, colors):
            break
        colors = new_colors

    by_canon = sorted(range(n), key=lambda v: (int(colors[v]), v))
    perm = np.zeros(n, dtype=np.int64)
    for pos, v in enumerate(by_canon):
        perm[v] = pos
    canon_vlab = [int(vlab[v]) for v in by_canon]
    canon_edges = sorted(
        (int(perm[int(s)]), int(perm[int(d)]), int(e))
        for s, d, e in zip(src, dst, elab)
    )
    form = repr((n, canon_vlab, canon_edges)).encode()
    return perm, form


def query_fingerprint(query) -> str:
    """Short hex digest of the canonical form (display/logging handle)."""
    _, form = canonical_form(query)
    return hashlib.sha1(form).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Plans.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Plan:
    """One matching order plus the cost-model trace that chose it.

    ``order`` holds query vertex ids in matching order.  ``cards`` and
    ``est_rows`` are the per-step candidate-set cardinality estimates and
    predicted surviving partial-embedding rows; ``est_cost`` is the
    predicted total join work (Σ rows·cards).  ``source`` records how the
    plan was produced: ``"stats"`` (beam search over GraphStats),
    ``"greedy"`` (no-stats fallback), or ``"cache"``.
    """

    order: tuple[int, ...]
    est_cost: float
    cards: tuple[float, ...]
    est_rows: tuple[float, ...]
    source: str
    fingerprint: str
    stats_version: int = -1
    stats_bucket: int = -1

    def explain(self) -> str:
        """Human-readable plan trace (one line per matching step)."""
        head = (
            f"Plan[{self.source}] query={self.fingerprint} "
            f"est_cost={self.est_cost:.3g} "
            f"stats=(version={self.stats_version}, bucket={self.stats_bucket})"
        )
        lines = [head, "  step  u     |C(u)|      est_rows"]
        for t, u in enumerate(self.order):
            lines.append(
                f"  {t:>4}  {u:<4} {self.cards[t]:>9.3g}  {self.est_rows[t]:>12.4g}"
            )
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Plan cache.
# ---------------------------------------------------------------------------


class PlanCache:
    """LRU plan cache keyed on ``(canonical form, stats bucket)``.

    Epoch-aware invalidation is carried by the key: a mutation that moves
    the stats bucket makes every old key unreachable (and ``prune`` drops
    them eagerly).  Counters are cumulative; ``hit_rate`` is the repeat-
    query planning savings the service benchmark reports.
    """

    def __init__(self, max_entries: int = 1024):
        self.max_entries = int(max_entries)
        self._entries: OrderedDict[tuple[bytes, int], Plan] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidated = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: tuple[bytes, int]) -> Optional[Plan]:
        plan = self._entries.get(key)
        if plan is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return plan

    def insert(self, key: tuple[bytes, int], plan: Plan) -> None:
        self._entries[key] = plan
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1

    def prune(self, bucket: int) -> int:
        """Drop entries planned under a different stats bucket."""
        stale = [k for k in self._entries if k[1] != bucket]
        for k in stale:
            del self._entries[k]
        self.invalidated += len(stale)
        return len(stale)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"PlanCache(entries={len(self)}, hits={self.hits}, "
            f"misses={self.misses}, evictions={self.evictions}, "
            f"invalidated={self.invalidated})"
        )


# ---------------------------------------------------------------------------
# The planner.
# ---------------------------------------------------------------------------

_MIN_ROWS = 1e-9  # keep cost products strictly positive (deterministic ties)


class QueryPlanner:
    """Matching-order optimizer over ``GraphStats`` with a shared plan cache.

    ``stats`` may be live (the ``graph_stats`` object an incremental index
    maintains — versions/buckets then track store mutations automatically)
    or frozen (an ``IndexSnapshot.stats`` copy), or ``None`` — in which
    case every plan is the engines' exact greedy fallback and nothing is
    cached.  One planner (hence one cache) can serve any number of engines,
    slots, and ticks concurrently; plans are immutable.  Share a ``cache``
    only between planners tracking the *same* stats lineage: the bucket
    component of the key is a per-stats counter, and a bucket move prunes
    every entry planned under a different bucket.
    """

    def __init__(self, stats: Optional[GraphStats] = None, *,
                 cache: Optional[PlanCache] = None, beam_width: int = 4):
        self.stats = stats
        self.cache = cache if cache is not None else PlanCache()
        self.beam_width = max(1, int(beam_width))
        self._last_bucket: Optional[int] = None

    @classmethod
    def for_data(cls, data, **kwargs) -> "QueryPlanner":
        """Build a planner for Graph | GraphStore | GraphSnapshot.

        Prefers the *live* ``graph_stats`` of an attached incremental index
        (stays current as the store mutates), then a snapshot's frozen
        stats, then an O(E) scratch build from the graph.  Note the frozen
        paths never re-bucket: a mutable store should carry an
        ``IncrementalIndex`` if cached plans are expected to track
        statistics drift (results are exact either way — DESIGN.md §10).
        """
        if isinstance(data, BaseGraphStore) and data.index is not None:
            live = getattr(data.index, "graph_stats", None)
            if live is not None:
                return cls(live, **kwargs)
        snap = as_snapshot(data)
        frozen = getattr(snap.index, "stats", None)
        if frozen is not None:
            return cls(frozen, **kwargs)
        return cls(GraphStats.from_graph(snap.graph, version=snap.epoch),
                   **kwargs)

    # -- public entry ---------------------------------------------------------

    def plan(self, query, *,
             candidate_counts: Optional[Sequence[float]] = None) -> Plan:
        """Produce (or fetch) a matching order for one query.

        ``candidate_counts``: optional (U,) live per-query-vertex candidate
        cardinalities (e.g. post-ILGF column sums) — the tightest |C(u)|
        estimate available; falls back to the stats label histogram.
        """
        perm, form = canonical_form(query)
        fp = hashlib.sha1(form).hexdigest()[:16]
        stats = self.stats
        n_q = int(query.vlabels.shape[0])

        if stats is None:
            q_adj = _host_adjacency(query)
            card = self._cards(query, candidate_counts, None)
            order = greedy_matching_order(card, q_adj)
            cost, cards, rows = self._estimate(order, q_adj, card, None)
            return Plan(tuple(order), cost, cards, rows, "greedy", fp)

        bucket = stats.bucket
        if bucket != self._last_bucket:
            if self._last_bucket is not None:
                self.cache.prune(bucket)
            self._last_bucket = bucket
        key = (form, bucket)
        cached = self.cache.lookup(key)
        if cached is not None:
            inv = np.argsort(perm)  # canonical position -> query vertex id
            order = tuple(int(inv[c]) for c in cached.order)
            return replace(cached, order=order, source="cache",
                           fingerprint=fp)

        q_adj = _host_adjacency(query)
        hist_q, prob_q, lab_ix = self._query_stats(query, stats)
        card = self._cards(query, candidate_counts, hist_q[lab_ix])
        order = self._beam_search(n_q, q_adj, card, prob_q, lab_ix)
        cost, cards, rows = self._estimate(order, q_adj, card,
                                           (prob_q, lab_ix))
        plan = Plan(tuple(order), cost, cards, rows, "stats", fp,
                    stats_version=stats.version, stats_bucket=bucket)
        canon_plan = replace(
            plan, order=tuple(int(perm[u]) for u in plan.order)
        )
        self.cache.insert(key, canon_plan)
        return plan

    # -- internals ------------------------------------------------------------

    @staticmethod
    def _query_stats(query, stats: GraphStats):
        q_lab = as_numpy(query.vlabels)
        labels = np.unique(q_lab)
        hist_q, prob_q = stats.query_view(labels)
        lab_ix = np.searchsorted(labels, q_lab)
        return hist_q, prob_q, lab_ix

    @staticmethod
    def _cards(query, candidate_counts, default) -> np.ndarray:
        n_q = int(query.vlabels.shape[0])
        if candidate_counts is not None:
            card = np.asarray(candidate_counts, dtype=np.float64)
            if card.shape != (n_q,):
                raise ValueError(
                    f"candidate_counts shape {card.shape} != ({n_q},)"
                )
            return card
        if default is not None:
            return np.asarray(default, dtype=np.float64)
        return np.zeros(n_q, dtype=np.float64)

    @staticmethod
    def _step(rows: float, u: int, placed, q_adj, card, prob) -> tuple:
        """(join cost, surviving rows) of matching ``u`` after ``placed``."""
        c = float(card[u])
        cost = rows * c
        if prob is None:
            return cost, max(rows * c, _MIN_ROWS)
        prob_q, lab_ix = prob
        surv = rows * c
        matched = [w for w in placed if w in q_adj.get(u, {})]
        for w in matched:
            surv *= float(prob_q[lab_ix[u], lab_ix[w]])
        return cost, max(surv, _MIN_ROWS)

    def _estimate(self, order, q_adj, card, prob):
        """Simulate an order: (total cost, per-step cards, per-step rows)."""
        rows = 1.0
        total = 0.0
        cards_t, rows_t = [], []
        placed: list[int] = []
        for u in order:
            cost, rows = self._step(rows, u, placed, q_adj, card, prob)
            total += cost
            cards_t.append(float(card[u]))
            rows_t.append(rows)
            placed.append(u)
        return total, tuple(cards_t), tuple(rows_t)

    def _beam_search(self, n_q, q_adj, card, prob_q, lab_ix) -> list[int]:
        """Beam over connected extension orders, minimizing total join cost.

        States are (cost, rows, order); per depth, states covering the same
        vertex set are deduplicated down to the cheapest, then the beam
        keeps the ``beam_width`` best.  Ties break on the order tuple, so
        planning is deterministic.
        """
        prob = (prob_q, lab_ix)
        beam = []
        for u in range(n_q):
            cost, rows = self._step(1.0, u, (), q_adj, card, prob)
            beam.append((cost, rows, (u,)))
        beam = sorted(beam, key=lambda s: (s[0], s[2]))[: self.beam_width]

        for _ in range(n_q - 1):
            best: dict[frozenset, tuple] = {}
            for cost, rows, order in beam:
                placed = set(order)
                ext = [u for u in range(n_q) if u not in placed
                       and any(w in q_adj.get(u, {}) for w in order)]
                if not ext:  # disconnected query: forced cartesian step
                    ext = [u for u in range(n_q) if u not in placed]
                for u in ext:
                    c, r = self._step(rows, u, order, q_adj, card, prob)
                    state = (cost + c, r, order + (u,))
                    key = frozenset(state[2])
                    cur = best.get(key)
                    if cur is None or (state[0], state[2]) < (cur[0], cur[2]):
                        best[key] = state
            beam = sorted(best.values(),
                          key=lambda s: (s[0], s[2]))[: self.beam_width]
        return list(beam[0][2])
