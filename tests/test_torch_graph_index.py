"""The port's graph-database CNI index against the reference's.

On the patterns of ``tests/test_graph_index.py`` and its fixture (eight
random graphs of 120-260 vertices): the per-label descending digest
lists agree within 1e-5 (float32 log digests of the same counts), the
candidate lists are equal on 20 seeded random-walk queries and keep each
query's source graph, a path graph is pruned for a star query, an alien
label prunes everything, and ``query`` equals the engine run on every
graph.  The build digests the whole database in one
``cni_encode`` call.
"""

import numpy as np
import pytest

from repro.core.engine import SubgraphQueryEngine as RefEngine
from repro.core.graph_index import GraphDatabaseIndex as RefIndex
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.csr import build_graph as r_build_graph
from repro_torch.core import SubgraphQueryEngine
from repro_torch.core import graph_index as gi_mod
from repro_torch.core.graph_index import GraphDatabaseIndex
from repro_torch.graphs import Graph, build_graph, graph_from_numpy


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


@pytest.fixture(scope="module")
def graphs():
    return [random_labeled_graph(120 + 20 * i, 400 + 60 * i, 5, seed=100 + i)
            for i in range(8)]


@pytest.fixture(scope="module")
def ref_db(graphs):
    return RefIndex(graphs)


@pytest.fixture(scope="module")
def db(graphs):
    return GraphDatabaseIndex([port(g) for g in graphs], device="cpu")


def test_digests_equal_reference(db, ref_db):
    assert (db.d_max, db.max_p) == (ref_db.d_max, ref_db.max_p)
    np.testing.assert_array_equal(db.label_map.sorted_labels.numpy(),
                                  np.asarray(ref_db.label_map.sorted_labels))
    for got, want in zip(db.entries, ref_db.entries):
        assert got.digests.keys() == want.digests.keys()
        for lab, vals in want.digests.items():
            assert got.digests[lab].dtype == vals.dtype
            np.testing.assert_allclose(got.digests[lab], vals, rtol=0,
                                       atol=1e-5)


def test_build_encodes_once(graphs, monkeypatch):
    calls = []
    real = gi_mod.encode_ops.cni_encode
    monkeypatch.setattr(gi_mod.encode_ops, "cni_encode",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    GraphDatabaseIndex([port(g) for g in graphs], device="cpu")
    assert calls == [(sum(g.n_vertices for g in graphs), 5)]


def test_candidates_equal_reference(db, ref_db, graphs):
    rng = np.random.default_rng(0)
    for s in range(20):
        i = int(rng.integers(len(graphs)))
        q = random_walk_query(graphs[i], 4 + s % 4, sparse=s % 2 == 0, seed=s)
        got = db.candidates(port(q))
        assert got == ref_db.candidates(q), f"seed {s}"
        assert i in got, f"seed {s}: the source graph {i} was pruned"


def test_index_prunes_weak_graphs_as_the_reference():
    path_edges = [(i, i + 1) for i in range(39)]
    star_edges = [(0, i) for i in range(1, 7)] + [(i, i + 1) for i in range(7, 20)]
    vlab_path = [i % 3 for i in range(40)]
    vlab_star = [i % 3 for i in range(21)]
    q_lab = [0] + [i % 3 for i in range(1, 7)]
    q_edges = [(0, i) for i in range(1, 7)]
    ref = RefIndex([r_build_graph(40, vlab_path, path_edges),
                    r_build_graph(21, vlab_star, star_edges)])
    got = GraphDatabaseIndex(
        [build_graph(40, vlab_path, path_edges, device="cpu"),
         build_graph(21, vlab_star, star_edges, device="cpu")], device="cpu")
    cands = got.candidates(build_graph(7, q_lab, q_edges, device="cpu"))
    assert cands == ref.candidates(r_build_graph(7, q_lab, q_edges)) == [1]


def test_full_query_equals_brute_force_and_reference(db, graphs):
    """``query`` equals the port's engine over every graph (the index
    prunes only graphs without embeddings), and the reference's engine on
    the query's source graph, row order included."""
    q = random_walk_query(graphs[3], 4, sparse=True, seed=7)
    got = db.query(port(q))
    expected = {}
    for i, g in enumerate(db.graphs):
        emb, _ = SubgraphQueryEngine(g, device="cpu").query(port(q))
        if emb.shape[0]:
            expected[i] = emb
    assert set(got) == set(expected) and 3 in got
    for i, emb in expected.items():
        np.testing.assert_array_equal(got[i], emb)
    np.testing.assert_array_equal(
        got[3], np.asarray(RefEngine(graphs[3]).query(q)[0]))


def test_disjoint_labels_pruned_entirely(db, graphs):
    q = port(random_walk_query(graphs[0], 3, seed=1))
    shifted = Graph(vlabels=q.vlabels + 10_000, src=q.src, dst=q.dst,
                    elabels=q.elabels)
    assert db.candidates(shifted) == []
    assert db.query(shifted) == {}
