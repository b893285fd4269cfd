"""The port's partition authority and mesh-partitioned engine
(``repro_torch.core.distributed``, ``core/search.py``'s sharded join and the
engines' ``mesh=``) against the reference, on the same numpy-seeded inputs.

The port's mesh holds 1, 2 or 4 logical shards on the host
(``device_mesh(D, devices="cpu")``).  Results that do not depend on the
shard count (the ILGF fixed point, the partitioned join's rows and row
order, the engines' answers) are held against the reference's unmeshed
functions in this process.  Results that do (the shard fields of the
enumeration reports, ``distributed_join_search``'s row order) are held
against the reference run at the same shard count, once, in a subprocess
with ``--xla_force_host_platform_device_count=4``.
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch
from repro import obsv as r_obsv
from repro.core import BatchQueryEngine as RefBatchEngine
from repro.core import SubgraphQueryEngine as RefEngine
from repro.core import batch_engine as r_be
from repro.core import distributed as r_dist
from repro.core import ilgf as r_ilgf
from repro.core.cni import default_max_p
from repro.core.search import bfs_join_search as r_bfs
from repro.core.search import device_join_search as r_device_join
from repro.core.search import host_dfs_search as r_dfs
from repro.graphs import ShardedGraphStore as RefShardedStore
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.csr import build_graph, induced_subgraph, max_degree
from repro_torch import obsv
from repro_torch.core import (
    BatchQueryEngine,
    SubgraphQueryEngine,
    device_mesh,
    distributed_ilgf,
    distributed_join_search,
    empty_enum_report,
    sharded_batched_ilgf_round,
    sharded_device_join_search,
)
from repro_torch.core import batch_engine as t_be
from repro_torch.core import distributed as t_dist
from repro_torch.graphs import ShardedGraphStore, graph_from_numpy

_SRC = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
SHARDS = [1, 2, 4]
# the report fields that depend on the shard count (all but the seconds and
# the scan route, which is the host's in the reference on the CPU)
SHARD_FIELDS = ("device_rounds", "host_levels", "max_table_rows",
                "max_emit_rows", "enum_shards", "emit_rows_max",
                "emit_rows_min", "rebalance_rounds", "rebalance_rows_moved")


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def mesh(n):
    return device_mesh(n, devices="cpu")


def filtered(g, q):
    """The reference's filtered graph and candidates for one query."""
    res = r_ilgf(g, q)
    alive = np.asarray(res.alive)
    sub, _ = induced_subgraph(g, alive)
    return sub, np.asarray(res.candidates)[alive]


def label_cands(g, q):
    return np.asarray(g.vlabels)[:, None] == np.asarray(q.vlabels)[None, :]


def shard_fields(rep) -> dict:
    out = {k: int(rep[k]) for k in SHARD_FIELDS}
    out["levels"] = [[int(lv["level"]), [int(x) for x in lv["emit_rows"]],
                      bool(lv["rebalanced"])] for lv in rep["levels"]]
    return out


# the cases whose results depend on the shard count: (graph seed, V, E, L,
# query seed, query size)
JOIN_CASES = {"a": (11, 300, 1000, 5, 13, 5), "b": (21, 400, 1400, 6, 22, 4)}


def join_case(name):
    gs, n, e, n_labels, qs, qn = JOIN_CASES[name]
    g = random_labeled_graph(n, e, n_labels, n_edge_labels=2, seed=gs)
    return g, random_walk_query(g, qn, sparse=True, seed=qs)


_REFERENCE_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from repro.core import ilgf, sharded_device_join_search
    from repro.core.distributed import device_mesh, distributed_join_search
    from repro.graphs import random_labeled_graph, random_walk_query
    from repro.graphs.csr import induced_subgraph

    assert len(jax.devices()) == 4, jax.devices()
    fields, cases = json.loads(sys.argv[1])
    out = {"enum": {}, "join": {}}
    for name, (gs, n, e, nl, qs, qn) in cases.items():
        g = random_labeled_graph(n, e, nl, n_edge_labels=2, seed=gs)
        q = random_walk_query(g, qn, sparse=True, seed=qs)
        res = ilgf(g, q)
        alive = np.asarray(res.alive)
        sub, _ = induced_subgraph(g, alive)
        cand = np.asarray(res.candidates)[alive]
        for d in (1, 2, 4):
            mesh = device_mesh(d)
            for th in (1.25, 1.05):
                rep = {}
                sharded_device_join_search(sub, q, cand, mesh=mesh,
                                           report=rep, rebalance_threshold=th)
                r = {k: int(rep[k]) for k in fields}
                r["levels"] = [[int(lv["level"]), [int(x) for x in
                                lv["emit_rows"]], bool(lv["rebalanced"])]
                               for lv in rep["levels"]]
                out["enum"][f"{name}/{d}/{th}"] = r
            if name == "a" and d > 1:
                emb, ovf = distributed_join_search(sub, q, cand, mesh, cap=128)
                out["join"][str(d)] = [emb.tolist(), bool(ovf)]
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_at_d():
    """The reference at 1, 2 and 4 devices, run once in a subprocess."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _SRC
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT,
         json.dumps([SHARD_FIELDS, JOIN_CASES])],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line, = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[len("RESULT "):])


# ---------------------------------------------------------------------------
# the partition authority
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_vertices,n_shards", [
    (5, 4), (363, 2), (363, 4), (8, 4), (1, 3), (0, 2), (100, 1)])
def test_plan_equals_reference(n_vertices, n_shards):
    plan = t_dist.vertex_partition(n_vertices, n_shards)
    want = r_dist.vertex_partition(n_vertices, n_shards)
    assert tuple(plan) == tuple(want)
    for s in range(n_shards):
        assert plan.bounds(s) == want.bounds(s)
        lo, hi = plan.bounds(s)
        assert 0 <= lo <= hi <= n_vertices
    ids = np.arange(max(n_vertices, 1))
    np.testing.assert_array_equal(plan.owner(ids), want.owner(ids))
    with pytest.raises(ValueError, match="n_shards"):
        t_dist.vertex_partition(n_vertices, 0)


def test_trailing_shard_of_padding_only():
    plan = t_dist.vertex_partition(5, 4)
    assert plan.v_local == 2 and plan.bounds(3) == (5, 5)


def test_device_mesh_placement(monkeypatch):
    m = device_mesh(4, devices="cpu")
    assert m.n_shards == 4 and m.axis == "data"
    assert set(m.devices) == {torch.device("cpu")}
    two = device_mesh(devices=["cpu", "cpu"], axis="rows")
    assert (two.n_shards, two.axis) == (2, "rows")
    assert device_mesh(devices="cpu").n_shards == 1
    assert hash(m) == hash(device_mesh(4, devices="cpu"))
    with pytest.raises(ValueError, match="2 devices for 3 shards"):
        device_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="n_shards"):
        device_mesh(0, devices="cpu")
    with pytest.raises(ValueError, match="axis"):
        t_dist.mesh_shards(m, "model")
    with pytest.raises(TypeError, match="ShardMesh"):
        t_dist.mesh_shards(object())
    # without devices= the mesh is the visible cards, never the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mesh(2, devices="cuda:0")


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_buckets_and_both_prepare_routes_equal_reference(n_shards):
    g = random_labeled_graph(301, 900, 5, n_edge_labels=2, seed=4)
    plan = t_dist.vertex_partition(301, n_shards)
    want = r_dist.shard_edges(np.asarray(g.src), np.asarray(g.dst), plan)
    fake_mesh = SimpleNamespace(shape={"data": n_shards})

    def same_buckets(se, ref_se):
        ok = np.asarray(ref_se.edge_ok)
        for i in range(n_shards):
            np.testing.assert_array_equal(
                se.edge_src[i].numpy(), np.asarray(ref_se.edge_src)[i][ok[i]])
            np.testing.assert_array_equal(
                se.edge_dst[i].numpy(), np.asarray(ref_se.edge_dst)[i][ok[i]])
            assert se.edge_src[i].dtype == torch.int32

    same_buckets(t_dist.shard_edges(np.asarray(g.src), np.asarray(g.dst),
                                    plan), want)
    # the edge-list route, from a plain graph
    se, plan2, _ = t_dist.prepare_sharded_edges(port(g), mesh(n_shards))
    assert plan2 == plan
    same_buckets(se, want)
    # the store-table route, from a sharded store's snapshot
    ref_store = RefShardedStore.from_graph(g, n_shards=n_shards)
    ref_store.add_edges([[0, 300], [3, 150]])
    ref_store.remove_edges([[int(np.asarray(g.src)[0]),
                             int(np.asarray(g.dst)[0])]])
    store = ShardedGraphStore.from_graph(port(g), n_shards=n_shards,
                                         device="cpu")
    store.add_edges([[0, 300], [3, 150]])
    store.remove_edges([[int(np.asarray(g.src)[0]),
                         int(np.asarray(g.dst)[0])]])
    ref_se, _, _ = r_dist.prepare_sharded_edges(ref_store, fake_mesh)
    se, _, _ = t_dist.prepare_sharded_edges(store, mesh(n_shards))
    assert store.snapshot().shards is not None
    same_buckets(se, ref_se)


@pytest.mark.parametrize("weights,n_shards", [
    ([3, 0, 0, 5, 1, 0, 2, 2, 7, 0], 4),
    ([1, 1, 1, 1, 1, 1], 4),          # ties: cut at the smallest index
    ([0, 0, 0, 0, 0], 3),             # all zero: equal row counts
    ([0, 9, 0], 2), ([4], 4), ([], 3), ([5, 2, 9], 1),
    ([2, 2, 0, 0, 2, 2, 0, 8], 3),
])
def test_enum_row_blocks_equal_reference(weights, n_shards):
    got = t_dist.enum_row_blocks(np.asarray(weights, np.int64), n_shards)
    np.testing.assert_array_equal(
        got, r_dist.enum_row_blocks(np.asarray(weights, np.int64), n_shards))
    assert got[0] == 0 and got[-1] == len(weights)
    assert (np.diff(got) >= 0).all()


# ---------------------------------------------------------------------------
# the partitioned ILGF: single query and batched rounds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ilgf_inputs():
    g = random_labeled_graph(363, 1100, 6, n_edge_labels=2, seed=11)
    queries = [random_walk_query(g, 5, sparse=bool(i % 2), seed=13 + i)
               for i in range(3)]
    return g, queries


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("variant", ["cni", "cni_log", "nlf", "label_degree"])
def test_distributed_ilgf_equals_reference(ilgf_inputs, n_shards, variant):
    g, queries = ilgf_inputs
    rng = np.random.default_rng(n_shards)
    alive0 = rng.random(g.n_vertices) < 0.8
    for q in queries:
        for a0 in (None, alive0):
            want = r_ilgf(g, q, variant=variant, alive0=a0)
            got = distributed_ilgf(port(g), port(q), mesh(n_shards),
                                   variant=variant, alive0=a0)
            np.testing.assert_array_equal(got.alive.numpy(),
                                          np.asarray(want.alive))
            np.testing.assert_array_equal(got.candidates.numpy(),
                                          np.asarray(want.candidates))
            assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_distributed_ilgf_over_a_sharded_store(ilgf_inputs, n_shards):
    g, queries = ilgf_inputs
    store = ShardedGraphStore.from_graph(port(g), n_shards=n_shards,
                                         device="cpu")
    store.add_edges([[0, 362], [1, 200], [5, 90]])
    ref_g = build_graph(g.n_vertices, np.asarray(g.vlabels),
                        np.stack(store.alive_edges()[:2], axis=1),
                        store.alive_edges()[2])
    prepared = t_dist.prepare_sharded_edges(store, mesh(n_shards))
    for q in queries:
        want = r_ilgf(ref_g, q)
        got = distributed_ilgf(store, port(q), mesh(n_shards),
                               prepared=prepared)
        np.testing.assert_array_equal(got.alive.numpy(),
                                      np.asarray(want.alive))
        np.testing.assert_array_equal(got.candidates.numpy(),
                                      np.asarray(want.candidates))
        assert got.iterations == int(want.iterations)


def test_mnd_nlf_is_not_offered_sharded(ilgf_inputs):
    g, queries = ilgf_inputs
    with pytest.raises(ValueError, match="mnd_nlf") as err:
        distributed_ilgf(port(g), port(queries[0]), mesh(2),
                         variant="mnd_nlf")
    with pytest.raises(ValueError) as ref_err:
        r_dist.local_match_matrix("mnd_nlf", np.zeros((2, 2), np.int32),
                                  np.zeros(2, np.int32), None, 1, 1)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("variant", ["cni", "cni_log", "nlf", "label_degree"])
def test_sharded_batched_round_equals_reference(n_shards, variant):
    g = random_labeled_graph(151, 500, 4, n_edge_labels=2, seed=31)
    queries = [random_walk_query(g, 4 + i, sparse=True, seed=900 + i)
               for i in range(3)]
    d_max = max(1, max_degree(g))
    u_pad, l_pad = 8, 4
    max_p = default_max_p(d_max, l_pad)
    ref_qb = r_be.stack_queries(queries, g, d_max, max_p, u_pad, l_pad, 4)
    port_qb = t_be.batched_queries_from_numpy(ref_qb, device="cpu")
    se, plan, _ = t_dist.prepare_sharded_edges(port(g), mesh(n_shards))
    r_alive = ref_qb.ords > 0
    t_alive = port_qb.ords > 0
    for _ in range(12):
        r_alive, r_cand, r_changed = r_be.batched_ilgf_round(
            g, ref_qb, r_alive, n_labels=l_pad, d_max=d_max, max_p=max_p,
            variant=variant)
        t_alive, t_cand, t_changed = sharded_batched_ilgf_round(
            se, plan, port_qb, t_alive, mesh=mesh(n_shards), n_labels=l_pad,
            d_max=d_max, max_p=max_p, variant=variant)
        np.testing.assert_array_equal(t_alive.numpy(), np.asarray(r_alive))
        np.testing.assert_array_equal(t_cand.numpy(), np.asarray(r_cand))
        np.testing.assert_array_equal(t_changed.numpy(), np.asarray(r_changed))
        if not np.asarray(r_changed).any():
            break
    else:
        pytest.fail("no fixed point within 12 rounds")


# ---------------------------------------------------------------------------
# the partitioned join
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("threshold", [1.25, 1.05])
def test_sharded_join_rows_and_prefixes_equal_reference(n_shards, threshold):
    g = random_labeled_graph(48, 150, 3, n_edge_labels=2, seed=5)
    q = random_walk_query(g, 4, seed=9)
    cand = label_cands(g, q)
    want = np.asarray(r_device_join(g, q, cand))
    total = want.shape[0]
    assert total > 0
    rep = {}
    got = sharded_device_join_search(port(g), port(q), cand,
                                     mesh=mesh(n_shards), report=rep,
                                     rebalance_threshold=threshold)
    np.testing.assert_array_equal(got, want)
    assert set(rep) == set(empty_enum_report())
    assert rep["enum_shards"] == n_shards and rep["host_levels"] == 0
    for cap in (1, max(1, total // 2), total, total + 3):
        np.testing.assert_array_equal(
            sharded_device_join_search(port(g), port(q), cand,
                                       mesh=mesh(n_shards),
                                       max_embeddings=cap,
                                       rebalance_threshold=threshold),
            np.asarray(r_device_join(g, q, cand, max_embeddings=cap)))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_join_corners_equal_reference(n_shards):
    g = random_labeled_graph(48, 150, 3, n_edge_labels=2, seed=5)
    # all-pruned: an empty result and the full schema
    q_dead = build_graph(3, [97, 98, 99], [(0, 1), (1, 2)])
    rep = {}
    emb = sharded_device_join_search(port(g), port(q_dead),
                                     label_cands(g, q_dead),
                                     mesh=mesh(n_shards), report=rep)
    assert emb.shape == (0, 3) and rep["enum_shards"] == n_shards
    assert set(rep) == set(empty_enum_report())
    # single vertex: the seed table is the answer, truncation included
    lab = int(np.asarray(g.vlabels)[0])
    q1 = build_graph(1, [lab], np.zeros((0, 2), np.int64))
    for cap in (None, 2):
        rep = {}
        got = sharded_device_join_search(port(g), port(q1),
                                         label_cands(g, q1),
                                         mesh=mesh(n_shards),
                                         max_embeddings=cap, report=rep)
        np.testing.assert_array_equal(got, np.asarray(r_device_join(
            g, q1, label_cands(g, q1), max_embeddings=cap)))
        assert rep["device_rounds"] == 0
        assert rep["max_table_rows"] == int(label_cands(g, q1).sum())


@pytest.mark.parametrize("name", sorted(JOIN_CASES))
@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("threshold", [1.25, 1.05])
def test_sharded_join_report_equals_reference_at_same_shards(
        reference_at_d, name, n_shards, threshold):
    g, q = join_case(name)
    sub, cand = filtered(g, q)
    rep = {}
    got = sharded_device_join_search(port(sub), port(q), cand,
                                     mesh=mesh(n_shards), report=rep,
                                     rebalance_threshold=threshold)
    np.testing.assert_array_equal(got, np.asarray(r_device_join(sub, q,
                                                                cand)))
    assert shard_fields(rep) == reference_at_d["enum"][
        f"{name}/{n_shards}/{threshold}"]
    if n_shards == 1:
        assert rep["rebalance_rounds"] == 0
    obsv.EnumReport.from_dict(rep)  # the schema holds


@pytest.mark.parametrize("n_shards", SHARDS)
def test_distributed_join_search_rows(reference_at_d, n_shards):
    g, q = join_case("a")
    sub, cand = filtered(g, q)
    emb, ovf = distributed_join_search(port(sub), port(q), cand,
                                       mesh(n_shards), cap=128)
    assert not ovf
    truth = np.asarray(r_dfs(sub, q, cand))
    assert {tuple(r) for r in emb.tolist()} == {tuple(r) for r in
                                               truth.tolist()}
    if n_shards == 1:  # one pile: the flat row-major order of the join
        np.testing.assert_array_equal(emb, np.asarray(r_bfs(sub, q, cand)))
    else:  # the piles' order depends on D: the reference at the same D
        want_rows, want_ovf = reference_at_d["join"][str(n_shards)]
        np.testing.assert_array_equal(emb, np.asarray(want_rows,
                                                      dtype=np.int64))
        assert ovf == want_ovf
    with pytest.raises(ValueError, match="divide"):
        distributed_join_search(port(sub), port(q), cand, mesh(4), cap=130)


# ---------------------------------------------------------------------------
# the meshed engines against the reference's unmeshed ones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("enumerator", ["host", "device"])
def test_meshed_engine_equals_reference(ilgf_inputs, n_shards, enumerator):
    g, _ = ilgf_inputs
    queries = [random_walk_query(g, 4, seed=20 + i) for i in range(3)]
    eng = SubgraphQueryEngine(port(g), mesh=mesh(n_shards),
                              enumerator=enumerator, device="cpu")
    ref = RefEngine(g, enumerator=enumerator)
    for q in queries:
        for cap in (None, 2):
            want, w_st = ref.query(q, max_embeddings=cap)
            got, st = eng.query(port(q), max_embeddings=cap)
            np.testing.assert_array_equal(got, np.asarray(want))
            assert st.ilgf_iterations == w_st.ilgf_iterations
            assert st.vertices_after == w_st.vertices_after
            assert st.extras["shards"] == n_shards
            if enumerator == "device" and st.vertices_after:
                assert st.extras["enum"]["enum_shards"] == n_shards


@pytest.mark.parametrize("n_shards", SHARDS)
def test_meshed_batch_engine_equals_reference(n_shards):
    g = random_labeled_graph(250, 900, 6, n_edge_labels=2, seed=3)
    rng = np.random.default_rng(7)
    queries = [random_walk_query(g, int(rng.integers(4, 8)),
                                 sparse=bool(i % 2), seed=400 + i)
               for i in range(6)]
    queries.insert(2, build_graph(3, [99, 98, 99], [(0, 1), (1, 2)]))
    want = RefBatchEngine(g, enumerator="device").query_batch(queries)
    got = BatchQueryEngine(port(g), mesh=mesh(n_shards), enumerator="device",
                           device="cpu").query_batch([port(q) for q in
                                                      queries])
    for (e_t, s_t), (e_r, s_r) in zip(got, want):
        np.testing.assert_array_equal(e_t, np.asarray(e_r))
        for f in ("ilgf_iterations", "vertices_after", "candidate_pairs"):
            assert getattr(s_t, f) == getattr(s_r, f), f
        assert s_t.extras["batch"] == s_r.extras["batch"].to_dict()


def test_engines_check_their_mesh(ilgf_inputs):
    g, _ = ilgf_inputs
    with pytest.raises(TypeError, match="ShardMesh"):
        SubgraphQueryEngine(port(g), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="axis"):
        BatchQueryEngine(port(g), mesh=mesh(2), shard_axis="model",
                         device="cpu")


# ---------------------------------------------------------------------------
# telemetry on every exit path (tests/test_obsv.py's and
# tests/test_differential.py's sharded patterns)
# ---------------------------------------------------------------------------


def test_exit_path_sharded():
    g = random_labeled_graph(120, 420, 4, n_edge_labels=2, seed=5)
    q = random_walk_query(g, 4, seed=5)
    eng = SubgraphQueryEngine(port(g), mesh=mesh(2), enumerator="device",
                              device="cpu")
    with obsv.tracing() as tr:
        emb, stats = eng.query(port(q))
    want, _ = RefEngine(g, enumerator="device").query(q)
    np.testing.assert_array_equal(emb, np.asarray(want))
    assert emb.shape[0] > 0
    assert not tr.open_spans
    assert {"query", "query.filter", "query.enumerate", "enum.count",
            "enum.emit"} <= tr.names()
    obsv.validate_extras(stats.extras)
    assert isinstance(stats.extras["enum"], obsv.EnumReport)
    assert stats.extras["enum"]["enum_shards"] == 2
    assert stats.extras["enum"]["levels"]
    assert set(stats.extras["enum"].keys()) == set(
        r_obsv.EnumReport.empty().to_dict())


def test_enum_telemetry_sharded_exit_paths():
    g = random_labeled_graph(120, 420, 4, n_edge_labels=2, seed=7)
    m = mesh(4)
    q_dead = build_graph(3, [97, 98, 99], [(0, 1), (1, 2)])
    # filter-killed through the meshed engine: the zeroed schema verbatim
    _, stats = SubgraphQueryEngine(port(g), mesh=m, enumerator="device",
                                   device="cpu").query(port(q_dead))
    assert stats.extras["enum"] == empty_enum_report()
    _, w_stats = RefEngine(g, enumerator="device").query(q_dead)
    assert stats.extras["enum"] == w_stats.extras["enum"].to_dict()
    # single vertex through the engine: no join level, shard fields filled
    lab = int(np.asarray(g.vlabels)[0])
    q1 = build_graph(1, [lab], np.zeros((0, 2), np.int64))
    emb, stats = SubgraphQueryEngine(port(g), mesh=m, enumerator="device",
                                     device="cpu").query(port(q1))
    rep = stats.extras["enum"]
    assert emb.shape[0] > 0 and rep["device_rounds"] == 0
    assert rep["enum_shards"] == 4 and rep["max_table_rows"] == emb.shape[0]
