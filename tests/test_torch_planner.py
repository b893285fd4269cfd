"""The port's planner (``core/stats.py`` + ``core/planner.py``) against the
reference's, on the workload shapes of ``tests/test_planner.py`` and
``benchmarks/planner_benches.py``.

Everything here is exact: ``GraphStats`` aggregates are integers (equal,
scratch and maintained, with the same version and bucket), and plans must
agree in order, fingerprint, source, ``est_cost``, per-step cards and rows
(float64 arithmetic in the same order) and ``explain()`` text, with the
same plan-cache hit / miss / eviction / invalidation counts after the same
query sequence.  Engines with a planner record the reference's
``stats.extras["plan"]`` and return its embeddings.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro.core import BatchQueryEngine as RefBatchEngine
from repro.core import GraphStats as RefStats
from repro.core import IncrementalIndex as RefIndex
from repro.core import PlanCache as RefPlanCache
from repro.core import QueryPlanner as RefPlanner
from repro.core import SubgraphQueryEngine as RefEngine
from repro.core.planner import canonical_form as r_canonical_form
from repro.core.planner import query_fingerprint as r_query_fingerprint
from repro.graphs import GraphStore as RefStore
from repro.graphs import random_labeled_graph, random_update_batches
from repro.graphs import random_walk_query
from repro.graphs.csr import build_graph
from repro_torch.core import (
    BatchQueryEngine,
    GraphStats,
    IncrementalIndex,
    PlanCache,
    QueryPlanner,
    SubgraphQueryEngine,
    canonical_form,
    query_fingerprint,
)
from repro_torch.graphs import GraphStore, graph_from_numpy
from strategies import label_candidates

ROOT = Path(__file__).resolve().parents[1]


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def planner_benches():
    """``benchmarks/planner_benches.py``, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "planner_benches", ROOT / "benchmarks" / "planner_benches.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def skewed_graph_and_query(n_a=6, n_b=60, n_c=7, seed=0):
    """``tests/test_planner.py``'s label-skewed workload."""
    rng = np.random.default_rng(seed)
    vlabels = np.array([0] * n_a + [1] * n_b + [2] * n_c)
    a_ids = np.arange(n_a)
    b_ids = n_a + np.arange(n_b)
    c_ids = n_a + n_b + np.arange(n_c)
    edges = [(a, b) for a in a_ids for b in b_ids]
    edges += [(b, int(rng.choice(c_ids))) for b in b_ids]
    g = build_graph(vlabels.size, vlabels, np.asarray(edges))
    q = build_graph(3, np.array([0, 1, 2]), np.array([[0, 1], [1, 2]]))
    return g, q


def twin_stores(g):
    ref = RefStore.from_graph(g)
    ref.attach_index(RefIndex())
    got = GraphStore.from_graph(port(g), device="cpu")
    got.attach_index(IncrementalIndex())
    return ref, got


def assert_stats_equal(got, want):
    for name in ("universe", "label_hist", "deg_sum", "pair_counts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype, name
    assert (got.n_vertices, got.n_edges, got.version, got.bucket, got._drift) \
        == (want.n_vertices, want.n_edges, want.version, want.bucket,
            want._drift)


def assert_plans_equal(got, want):
    assert (got.order, got.source, got.fingerprint, got.est_cost, got.cards,
            got.est_rows, got.stats_version, got.stats_bucket) == \
        (want.order, want.source, want.fingerprint, want.est_cost, want.cards,
         want.est_rows, want.stats_version, want.stats_bucket)
    assert got.explain() == want.explain()


def assert_caches_equal(got, want):
    assert (len(got), got.hits, got.misses, got.evictions, got.invalidated) == \
        (len(want), want.hits, want.misses, want.evictions, want.invalidated)


# ---------------------------------------------------------------------------
# GraphStats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 5])
def test_stats_scratch_and_maintained_equal_reference(seed):
    g = random_labeled_graph(100, 360, 5, n_edge_labels=2, seed=seed)
    assert_stats_equal(GraphStats.from_graph(port(g)), RefStats.from_graph(g))
    ref, got = twin_stores(g)
    assert_stats_equal(GraphStats.from_store(got), RefStats.from_store(ref))
    ref.index.graph_stats.rebucket_frac = 0.05
    got.index.graph_stats.rebucket_frac = 0.05
    for batch in random_update_batches(g, 6, 40, delete_frac=0.4, seed=4):
        ref.apply(batch)
        got.apply(batch)
        assert_stats_equal(got.index.graph_stats, ref.index.graph_stats)
        assert got.index.graph_stats.version == got.epoch
    assert got.index.graph_stats.bucket > 0  # the drift gate moved
    assert_stats_equal(got.snapshot().index.stats, ref.snapshot().index.stats)
    scratch = GraphStats.from_store(got)
    for name in ("label_hist", "deg_sum", "pair_counts"):
        np.testing.assert_array_equal(getattr(scratch, name),
                                      getattr(got.index.graph_stats, name))


def test_query_view_and_avg_degree_equal_reference():
    g = random_labeled_graph(90, 300, 4, seed=8)
    got, want = GraphStats.from_graph(port(g)), RefStats.from_graph(g)
    labels = np.array([0, 1, 3, 99])  # 99 is not in the universe
    for a, b in zip(got.query_view(labels), want.query_view(labels)):
        np.testing.assert_array_equal(a, b)
    for lab in (0, 2, 99):
        assert got.avg_degree(lab) == want.avg_degree(lab)
    for a, b in zip(got.label_columns(labels), want.label_columns(labels)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# fingerprints and plans
# ---------------------------------------------------------------------------


def test_canonical_form_and_fingerprint_equal_reference():
    for seed in range(8):
        g = random_labeled_graph(120, 420, 3 + seed % 3, n_edge_labels=2,
                                 seed=seed)
        q = random_walk_query(g, 4 + seed % 4, sparse=bool(seed % 2),
                              seed=seed + 30)
        perm, form = canonical_form(port(q))
        r_perm, r_form = r_canonical_form(q)
        np.testing.assert_array_equal(perm, r_perm)
        assert form == r_form
        assert query_fingerprint(port(q)) == r_query_fingerprint(q)


@pytest.mark.parametrize("with_counts", [False, True])
def test_plans_equal_reference_on_random_graphs(with_counts):
    for seed in range(6):
        g = random_labeled_graph(150, 600, 5, seed=seed + 9)
        planner = QueryPlanner(GraphStats.from_graph(port(g)))
        r_planner = RefPlanner(RefStats.from_graph(g))
        for s in range(3):
            q = random_walk_query(g, 6, sparse=bool(s % 2), seed=seed * 10 + s)
            counts = label_candidates(g, q).sum(axis=0) if with_counts else None
            assert_plans_equal(planner.plan(port(q), candidate_counts=counts),
                               r_planner.plan(q, candidate_counts=counts))


def test_statsless_planner_is_greedy_and_caches_nothing():
    planner, r_planner = QueryPlanner(None), RefPlanner(None)
    for seed in range(6):
        g = random_labeled_graph(90, 300, 4, seed=seed)
        q = random_walk_query(g, 5, seed=seed + 30)
        sizes = label_candidates(g, q).sum(axis=0)
        plan = planner.plan(port(q), candidate_counts=sizes)
        assert plan.source == "greedy"
        assert_plans_equal(plan, r_planner.plan(q, candidate_counts=sizes))
    assert len(planner.cache) == 0


def test_skewed_workloads_equal_reference():
    """The skewed 3-path of the planner tests and the hub 4-path of
    ``benchmarks/planner_benches.py`` (its smoke and full sizes)."""
    bench = planner_benches()
    cases = [skewed_graph_and_query(),
             bench.skewed_hub_workload(4, 128, 5, 16),
             bench.skewed_hub_workload(16, 2000, 17, 128)]
    for g, q in cases:
        planner = QueryPlanner(GraphStats.from_graph(port(g)))
        r_planner = RefPlanner(RefStats.from_graph(g))
        sizes = label_candidates(g, q).sum(axis=0).astype(float)
        for counts in (None, sizes):
            plan = planner.plan(port(q), candidate_counts=counts)
            assert_plans_equal(plan, r_planner.plan(q, candidate_counts=counts))
        assert plan.source == "cache"  # the second plan hit the first
    # the renumbered 3-path maps its cached plan back to its own ids
    q2 = build_graph(3, np.array([2, 1, 0]), np.array([[2, 1], [1, 0]]))
    g, q1 = cases[0]
    planner = QueryPlanner(GraphStats.from_graph(port(g)))
    r_planner = RefPlanner(RefStats.from_graph(g))
    planner.plan(port(q1))
    r_planner.plan(q1)
    assert_plans_equal(planner.plan(port(q2)), r_planner.plan(q2))


# ---------------------------------------------------------------------------
# the plan cache
# ---------------------------------------------------------------------------


def test_cache_hits_evictions_and_bucket_invalidation_equal_reference():
    g = random_labeled_graph(100, 360, 6, seed=12)
    ref, got = twin_stores(g)
    for s in (ref, got):
        s.index.graph_stats.rebucket_frac = 0.0  # every batch re-buckets
    cache, r_cache = PlanCache(max_entries=2), RefPlanCache(max_entries=2)
    planner = QueryPlanner.for_data(got, cache=cache)
    r_planner = RefPlanner.for_data(ref, cache=r_cache)
    assert planner.stats is got.index.graph_stats  # the live statistics
    queries = [random_walk_query(g, 5, seed=20 + i) for i in range(3)]
    sequence = [0, 0, 1, 2, 0, "mutate", 1, 1, 2, "mutate", 0]
    n_mutations = 0
    for step in sequence:
        if step == "mutate":
            n_mutations += 1
            for s in (ref, got):
                s.add_edges([[0, 60 + n_mutations]])
            continue
        assert_plans_equal(planner.plan(port(queries[step])),
                           r_planner.plan(queries[step]))
        assert_caches_equal(cache, r_cache)
    assert cache.invalidated >= 1 and cache.evictions >= 1
    assert cache.hit_rate == r_cache.hit_rate


def test_for_data_on_graph_and_snapshot_equals_reference():
    g = random_labeled_graph(100, 360, 5, seed=14)
    ref, got = twin_stores(g)
    q = random_walk_query(g, 5, seed=15)
    for data, r_data in ((port(g), g), (got.snapshot(), ref.snapshot())):
        assert_plans_equal(QueryPlanner.for_data(data).plan(port(q)),
                           RefPlanner.for_data(r_data).plan(q))


# ---------------------------------------------------------------------------
# engines with a planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("searcher,enumerator", [("join", "device"),
                                                 ("dfs", "host")])
def test_engine_with_planner_equals_reference(searcher, enumerator):
    g = random_labeled_graph(250, 900, 6, seed=17)
    ref, got = twin_stores(g)
    eng = SubgraphQueryEngine(got, planner=QueryPlanner.for_data(got),
                              searcher=searcher, enumerator=enumerator,
                              device="cpu")
    r_eng = RefEngine(ref, planner=RefPlanner.for_data(ref), searcher=searcher,
                      enumerator=enumerator)
    off = SubgraphQueryEngine(got, device="cpu")
    for seed in range(3):
        q = random_walk_query(g, 5, seed=30 + seed)
        emb, st = eng.query(port(q))
        want, r_st = r_eng.query(q)
        np.testing.assert_array_equal(emb, want)
        plan, r_plan = st.extras["plan"], r_st.extras["plan"]
        assert {k: plan[k] for k in ("order", "source", "est_cost",
                                     "fingerprint")} == \
            {k: r_plan[k] for k in ("order", "source", "est_cost",
                                    "fingerprint")}
        assert plan["source"] in ("stats", "cache")
        assert set(map(tuple, emb)) == set(map(tuple, off.query(port(q))[0]))


def test_all_pruned_query_records_skipped_plan():
    g = random_labeled_graph(60, 200, 4, seed=18)
    _, got = twin_stores(g)
    q = build_graph(3, np.array([99, 98, 99]), np.array([[0, 1], [1, 2]]))
    eng = SubgraphQueryEngine(got, planner=QueryPlanner.for_data(got),
                              enumerator="device", device="cpu")
    emb, st = eng.query(port(q))
    assert emb.shape == (0, 3)
    assert st.extras["plan"] == {"order": (), "source": "skipped",
                                 "est_cost": 0.0, "fingerprint": None,
                                 "plan_seconds": 0.0}
    assert st.extras["enum"]["device_rounds"] == 0


def test_batch_engine_with_planner_equals_reference():
    g = random_labeled_graph(200, 700, 5, n_edge_labels=2, seed=19)
    ref, got = twin_stores(g)
    queries = [random_walk_query(g, 4 + i % 2, seed=80 + i) for i in range(5)]
    planner, r_planner = QueryPlanner.for_data(got), RefPlanner.for_data(ref)
    results = BatchQueryEngine(got, planner=planner, max_batch=4,
                               device="cpu").query_batch(
        [port(q) for q in queries])
    want = RefBatchEngine(ref, planner=r_planner, max_batch=4).query_batch(
        queries)
    for (emb, st), (w_emb, w_st) in zip(results, want):
        np.testing.assert_array_equal(emb, w_emb)
        assert st.extras["plan"]["order"] == w_st.extras["plan"]["order"]
    assert_caches_equal(planner.cache, r_planner.cache)
