"""The port's batched multi-query engine against the JAX reference's, on the
same graphs and queries (the cases of ``tests/test_batch_engine.py``).

Per query: embeddings equal in content and row order, the same rounds,
filtered-graph size, candidate pairs and ``BatchReport``.  The batch
internals — ``stack_queries`` digests, every ``batched_ilgf_round``'s alive
mask, candidates and changed flags, and the lockstep fixed point — are
equal bit for bit when both packages are fed the same stack (the reference
stack carried over by ``batched_queries_from_numpy``); log digests are held
to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BatchQueryEngine as RefBatchEngine
from repro.core import batch_engine as r_be
from repro.core.cni import default_max_p
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.csr import build_graph, max_degree
from repro_torch import obsv
from repro_torch.core import BatchQueryEngine, SubgraphQueryEngine, ilgf
from repro_torch.core import batch_engine as t_be
from repro_torch.graphs import graph_from_numpy
from strategies import emb_set

VARIANTS = ["cni", "cni_log", "nlf", "label_degree", "mnd_nlf"]


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def all_pruned_query():
    # labels 98/99 never occur in the random data graphs below
    return build_graph(3, [99, 98, 99], [(0, 1), (1, 2)])


def assert_port_equals_reference(data, queries, *, variant="cni",
                                 max_batch=32, enumerator="host"):
    want = RefBatchEngine(data, filter_variant=variant, max_batch=max_batch,
                          enumerator=enumerator).query_batch(queries)
    engine = BatchQueryEngine(port(data), filter_variant=variant,
                              max_batch=max_batch, enumerator=enumerator,
                              device="cpu")
    got = engine.query_batch([port(q) for q in queries])
    assert len(got) == len(queries)
    for i, ((e_t, s_t), (e_r, s_r)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(e_t, e_r, err_msg=f"query {i}")
        for field in ("ilgf_iterations", "vertices_before", "vertices_after",
                      "candidate_pairs", "n_embeddings"):
            assert getattr(s_t, field) == getattr(s_r, field), (i, field)
        assert isinstance(s_t.extras["batch"], obsv.BatchReport)
        assert s_t.extras["batch"] == s_r.extras["batch"].to_dict()
    return got


def test_mixed_batch_equals_reference_and_sequential():
    g = random_labeled_graph(250, 900, 6, n_edge_labels=2, seed=3)
    rng = np.random.default_rng(7)
    queries = [random_walk_query(g, int(rng.integers(4, 9)),
                                 sparse=bool(i % 2), seed=400 + i)
               for i in range(10)]
    queries.insert(5, all_pruned_query())
    queries.insert(11, all_pruned_query())
    got = assert_port_equals_reference(g, queries)
    seq = SubgraphQueryEngine(port(g), device="cpu")
    for q, (emb, _) in zip(queries, got):
        assert emb_set(seq.query(port(q))[0]) == emb_set(emb)


def test_all_pruned_and_zero_embedding_in_same_batch():
    g = build_graph(3, [0, 1, 0], [(0, 1), (1, 2)], elabels=[0, 0])
    queries = [
        build_graph(3, [0, 1, 0], [(0, 1), (1, 2)], elabels=[0, 1]),  # 0 embeddings
        all_pruned_query(),                                          # filter empties
        build_graph(2, [0, 1], [(0, 1)], elabels=[0]),               # 2 embeddings
    ]
    (e0, s0), (e1, s1), (e2, s2) = assert_port_equals_reference(
        g, queries, enumerator="device")
    assert e0.shape == (0, 3) and s0.vertices_after == 3
    assert e1.shape == (0, 3) and s1.vertices_after == 0
    assert emb_set(e2) == {(0, 1), (2, 1)}
    # the device join's report is there on every exit path
    assert s1.extras["enum"] == obsv.EnumReport.empty()
    assert s2.extras["enum"]["device_rounds"] > 0


@pytest.mark.parametrize("variant", VARIANTS)
def test_all_variants_equal_reference(variant):
    g = random_labeled_graph(150, 500, 4, n_edge_labels=2, seed=11)
    queries = [random_walk_query(g, 4 + (i % 3), sparse=i % 2 == 0,
                                 seed=600 + i) for i in range(6)]
    assert_port_equals_reference(g, queries, variant=variant)


def test_small_max_batch_chunks_across_buckets():
    g = random_labeled_graph(200, 700, 5, n_edge_labels=2, seed=5)
    queries = [random_walk_query(g, 3 + (i % 2), sparse=bool(i % 2), seed=70 + i)
               for i in range(8)]
    got = assert_port_equals_reference(g, queries, max_batch=4)
    keys = {t_be.bucket_key(port(q), max(1, max_degree(g))) for q in queries}
    assert len(keys) > 1 and all(k[2] == t_be.ceil_pow2(k[2]) for k in keys)
    sizes = sorted({s.extras["batch"]["batch_size"] for _, s in got})
    assert max(sizes) == 4 and len(sizes) > 1  # chunked under max_batch


def test_batch_report_contents_and_validation():
    g = random_labeled_graph(120, 400, 4, seed=9)
    queries = [random_walk_query(g, 5, sparse=True, seed=90 + i) for i in range(4)]
    engine = BatchQueryEngine(port(g), device="cpu")
    with obsv.tracing() as tracer:
        results = engine.query_batch([port(q) for q in queries])
    assert {"batch.bucket", "batch.round", "batch.retire",
            "query.enumerate"} <= tracer.names()
    for emb, stats in results:
        rep = stats.extras["batch"]
        assert rep["batch_size"] == 4 and len(rep["bucket"]) == 3
        assert rep["bucket"][0] == engine.d_max
        assert stats.ilgf_iterations >= 1
        assert stats.vertices_before == g.n_vertices
        assert set(rep) == {"bucket", "batch_size"}
    with pytest.raises(ValueError, match="bucket"):
        obsv.BatchReport(bucket=(1, 2), batch_size=1).validate()
    with pytest.raises(ValueError, match="batch_size"):
        obsv.BatchReport.from_dict({"bucket": (1, 2, 4), "batch_size": 1.5})
    with pytest.raises(ValueError, match="unknown keys"):
        obsv.BatchReport.from_dict({"bucket": (1, 2, 4), "batch_size": 1, "x": 0})


def stacks(seed=31, n_queries=3, b_pad=4):
    g = random_labeled_graph(150, 500, 4, n_edge_labels=2, seed=seed)
    queries = [random_walk_query(g, 4 + i, sparse=True, seed=900 + i)
               for i in range(n_queries)]
    d_max = max(1, max_degree(g))
    u_pad, l_pad = 8, 4
    max_p = default_max_p(d_max, l_pad)
    ref_qb = r_be.stack_queries(queries, g, d_max, max_p, u_pad, l_pad, b_pad)
    port_qb = t_be.stack_queries([port(q) for q in queries], port(g), d_max,
                                 max_p, u_pad, l_pad, b_pad, device="cpu")
    return g, queries, (d_max, max_p, l_pad), ref_qb, port_qb


def test_stack_queries_equals_reference():
    _, _, _, ref_qb, port_qb = stacks()
    carried = t_be.batched_queries_from_numpy(ref_qb, device="cpu")
    for name in ("ords", "counts", "mnd"):
        np.testing.assert_array_equal(getattr(port_qb, name).numpy(),
                                      np.asarray(getattr(ref_qb, name)), name)
    for name in ("ord_label", "deg", "cni"):
        np.testing.assert_array_equal(getattr(port_qb.digest, name).numpy(),
                                      getattr(carried.digest, name).numpy(), name)
    np.testing.assert_allclose(port_qb.digest.cni_log.numpy(),
                               np.asarray(ref_qb.digest.cni_log), rtol=0, atol=1e-5)
    assert port_qb.digest.cni.dtype == torch.int64
    assert not port_qb.ords[3].any()  # the spare slot is inert


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_round_equals_reference(variant):
    g, _, (d_max, max_p, l_pad), ref_qb, _ = stacks()
    port_qb = t_be.batched_queries_from_numpy(ref_qb, device="cpu")
    tg = port(g)
    r_alive = ref_qb.ords > 0
    t_alive = port_qb.ords > 0
    for _ in range(12):
        r_alive, r_cand, r_changed = r_be.batched_ilgf_round(
            g, ref_qb, r_alive, n_labels=l_pad, d_max=d_max, max_p=max_p,
            variant=variant)
        t_alive, t_cand, t_changed = t_be.batched_ilgf_round(
            tg, port_qb, t_alive, n_labels=l_pad, d_max=d_max, max_p=max_p,
            variant=variant)
        np.testing.assert_array_equal(t_alive.numpy(), np.asarray(r_alive))
        np.testing.assert_array_equal(t_cand.numpy(), np.asarray(r_cand))
        np.testing.assert_array_equal(t_changed.numpy(), np.asarray(r_changed))
        if not np.asarray(r_changed).any():
            break
    else:
        pytest.fail("no fixed point within 12 rounds")


def test_lockstep_fixed_point_equals_reference_and_per_query_ilgf():
    g, queries, (d_max, max_p, l_pad), ref_qb, _ = stacks()
    port_qb = t_be.batched_queries_from_numpy(ref_qb, device="cpu")
    r_alive, r_cand, r_rounds = r_be.batched_ilgf_fixed_point(
        g, ref_qb, n_labels=l_pad, d_max=d_max, max_p=max_p, variant="cni",
        max_iters=1000)
    alive, cand, rounds = t_be.batched_ilgf_fixed_point(
        port(g), port_qb, n_labels=l_pad, d_max=d_max, max_p=max_p,
        variant="cni", max_iters=1000)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(r_alive))
    np.testing.assert_array_equal(cand.numpy(), np.asarray(r_cand))
    assert rounds == int(r_rounds)
    for b, q in enumerate(queries):
        # the batch's shared max_p clips less, so its fixed point is a
        # superset of the per-query one
        seq = ilgf(port(g), port(q), d_max=d_max).alive.numpy()
        assert not (seq & ~alive[b].numpy()).any()
    assert not alive[3].any()  # the spare slot stays inert


def test_max_iters_degrades_soundly():
    g = random_labeled_graph(200, 700, 5, n_edge_labels=2, seed=5)
    queries = [random_walk_query(g, 5, sparse=True, seed=70 + i) for i in range(4)]
    full = BatchQueryEngine(port(g), device="cpu").query_batch(
        [port(q) for q in queries])
    cut = BatchQueryEngine(port(g), max_iters=1, device="cpu").query_batch(
        [port(q) for q in queries])
    for (e_full, s_full), (e_cut, s_cut) in zip(full, cut):
        assert emb_set(e_full) == emb_set(e_cut)
        assert s_cut.ilgf_iterations == 2  # one round, then one aligning round
        assert s_cut.vertices_after >= s_full.vertices_after


def test_compact_batch_gathers_and_inerts():
    _, _, _, ref_qb, port_qb = stacks(n_queries=4)
    alive = port_qb.ords > 0
    idx = torch.tensor([2, 0, 2, 2])
    qb2, alive2 = t_be._compact_batch(port_qb, alive, idx, 2)
    r_qb2, r_alive2 = r_be._compact_batch(ref_qb, jnp.asarray(alive.numpy()),
                                          jnp.asarray(idx.numpy()), np.int32(2))
    np.testing.assert_array_equal(qb2.ords.numpy(), np.asarray(r_qb2.ords))
    np.testing.assert_array_equal(alive2.numpy(), np.asarray(r_alive2))
    np.testing.assert_array_equal(qb2.digest.deg.numpy(),
                                  np.asarray(r_qb2.digest.deg))


def test_empty_batch_and_later_slices_raise():
    """An empty batch; the multi-device cases (ROADMAP A11), which raised
    until that slice, now equal the reference's unmeshed batch; the
    argument checks."""
    from repro_torch.core import device_mesh
    from repro_torch.graphs import GraphSnapshot, ShardedGraphStore

    g = random_labeled_graph(50, 120, 3, seed=0)
    assert BatchQueryEngine(port(g), device="cpu").query_batch([]) == []
    queries = [random_walk_query(g, 3, seed=s) for s in range(4)]
    want = RefBatchEngine(g).query_batch(queries)
    for eng in (
        BatchQueryEngine(ShardedGraphStore.from_graph(port(g), n_shards=2,
                                                      device="cpu"),
                         device="cpu"),
        BatchQueryEngine(port(g), mesh=device_mesh(2, devices="cpu"),
                         device="cpu"),
    ):
        got = eng.query_batch([port(q) for q in queries])
        for (emb, st), (w_emb, w_st) in zip(got, want):
            np.testing.assert_array_equal(emb, np.asarray(w_emb))
            assert st.ilgf_iterations == w_st.ilgf_iterations
    with pytest.raises(ValueError, match="incremental index"):
        BatchQueryEngine(GraphSnapshot(0, port(g), None, ooc=object()),
                         device="cpu")
    with pytest.raises(TypeError, match="ShardMesh"):
        BatchQueryEngine(port(g), mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="enumerator"):
        BatchQueryEngine(port(g), enumerator="gpu", device="cpu")


def test_filter_seconds_follow_each_querys_own_rounds():
    """A query's ``filter_seconds`` sums the rounds its row was live in: in
    one chunk, a query that converged in more rounds took longer, and none
    took longer than the chunk's deepest."""
    g = random_labeled_graph(300, 1200, 3, seed=21)
    queries = [port(random_walk_query(g, 5, seed=40 + i)) for i in range(12)]
    queries.append(port(all_pruned_query()))
    got = BatchQueryEngine(port(g), device="cpu").query_batch(queries)
    by_bucket: dict = {}
    for _, stats in got:
        by_bucket.setdefault(stats.extras["batch"]["bucket"], []).append(stats)
    pairs = 0
    for chunk in by_bucket.values():
        for a in chunk:
            for b in chunk:
                if a.ilgf_iterations < b.ilgf_iterations:
                    assert 0 < a.filter_seconds < b.filter_seconds
                    pairs += 1
    assert pairs >= 1
