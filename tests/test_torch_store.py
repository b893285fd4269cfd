"""The port's mutable ``GraphStore`` against the reference's, op for op.

Both stores get the same numpy records; after every batch they must agree
exactly on the ``ApplyResult`` (epoch, counts, and the applied records in
plan order, each delete carrying the label it removed), the alive edge set
in table order, ``has_edge``, the degrees, ``stats()`` and the epoch, and
their snapshot graphs must be bit-identical arrays.  The sequences include
duplicate inserts, missing deletes, self-loops, repeated records within a
batch (the first wins), padding rows, re-inserts of deleted edges,
compaction and a degree-cap violation.  ``random_update_batches`` is held
seed for seed.
"""

import numpy as np
import pytest
import torch

from repro.graphs import GraphStore as RefStore
from repro.graphs import make_edge_batch as r_make_edge_batch
from repro.graphs import random_labeled_graph
from repro.graphs import random_update_batches as r_update_batches
from repro.graphs.store import EdgeBatch as RefEdgeBatch
from repro.graphs.store import canonicalize_batch as r_canonicalize
from repro_torch.graphs import (
    EdgeBatch,
    GraphStore,
    ShardedGraphStore,
    as_snapshot,
    graph_from_numpy,
    make_edge_batch,
    random_update_batches,
)
from repro_torch.graphs.store import canonicalize_batch


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def messy_batch(rng, n, k, present):
    """k records over n vertices: half deletes of present edges or of
    absent ones, half inserts of new or present edges, with self-loops,
    repeated pairs and a few padding rows."""
    pres = list(present)
    recs = []
    for _ in range(k):
        if pres and rng.random() < 0.5:
            a, b = pres[int(rng.integers(len(pres)))]
            if rng.random() < 0.5:
                a, b = b, a
        else:
            a, b = (int(x) for x in rng.integers(0, n, size=2))
        recs.append((a, b, int(rng.integers(0, 3)), bool(rng.random() < 0.5)))
    recs += recs[: k // 5]  # repeats: the first record of a pair wins
    arr = np.asarray([r[:3] for r in recs], dtype=np.int64)
    valid = rng.random(len(recs)) < 0.9
    return RefEdgeBatch(src=arr[:, 0], dst=arr[:, 1], elabels=arr[:, 2],
                        insert=np.asarray([r[3] for r in recs]), valid=valid)


def assert_stores_equal(ref, got):
    assert got.epoch == ref.epoch
    assert tuple(got.stats()) == tuple(ref.stats())
    for a, b in zip(ref.alive_edges(), got.alive_edges()):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(got.degrees(), ref.degrees())
    assert got.max_degree == ref.max_degree


def assert_results_equal(r, t):
    assert (t.epoch, t.n_inserted, t.n_deleted, t.n_skipped) == \
        (r.epoch, r.n_inserted, r.n_deleted, r.n_skipped)
    for name in RefEdgeBatch._fields:
        np.testing.assert_array_equal(getattr(t.applied, name),
                                      getattr(r.applied, name), name)
        assert getattr(t.applied, name).dtype == getattr(r.applied, name).dtype


@pytest.mark.parametrize("seed,compact_every", [(0, 3), (1, 0), (2, 64)])
def test_random_op_sequences_agree(seed, compact_every):
    rng = np.random.default_rng(seed)
    g = random_labeled_graph(60, 150, 4, n_edge_labels=3, seed=seed)
    ref = RefStore.from_graph(g, compact_every=compact_every)
    got = GraphStore.from_graph(port(g), compact_every=compact_every,
                                device="cpu")
    assert_stores_equal(ref, got)
    for _ in range(10):
        lo, hi, _ = ref.alive_edges()
        batch = messy_batch(rng, 60, 30, set(zip(lo.tolist(), hi.tolist())))
        assert_results_equal(ref.apply(batch), got.apply(EdgeBatch(*batch)))
        assert_stores_equal(ref, got)
        pairs = rng.integers(0, 60, size=(40, 2))
        want = [ref.has_edge(int(a), int(b)) for a, b in pairs]
        assert [got.has_edge(int(a), int(b)) for a, b in pairs] == want
        np.testing.assert_array_equal(got.has_edges(pairs[:, 0], pairs[:, 1]),
                                      want)
    for a, b in zip(ref.snapshot().graph, got.snapshot().graph):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got.compact() == ref.compact()
    assert_stores_equal(ref, got)


def test_canonicalize_batch_equals_reference():
    rng = np.random.default_rng(3)
    for _ in range(5):
        batch = messy_batch(rng, 25, 40, {(0, 1), (2, 3)})
        for a, b in zip(r_canonicalize(batch, 25),
                        canonicalize_batch(EdgeBatch(*batch), 25)):
            np.testing.assert_array_equal(b, a)
    with pytest.raises(ValueError, match="out of range"):
        canonicalize_batch(make_edge_batch([[0, 25]]), 25)


def test_make_edge_batch_equals_reference():
    edges = [[3, 1], [2, 2], [0, 4]]
    for kwargs in ({}, {"insert": False}, {"insert": [True, False, True]}):
        for a, b in zip(r_make_edge_batch(edges, [5, 6, 7], **kwargs),
                        make_edge_batch(edges, [5, 6, 7], **kwargs)):
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype


def test_reinsert_revives_row_with_new_label_and_delete_reports_it():
    ref = RefStore(6, np.zeros(6, np.int64), compact_every=0)
    got = GraphStore(6, np.zeros(6, np.int32), compact_every=0, device="cpu")
    steps = [
        make_edge_batch([[0, 1], [1, 2], [2, 3]], [4, 5, 6]),
        make_edge_batch([[1, 0], [3, 2]], insert=False),
        make_edge_batch([[0, 1], [4, 5]], [9, 1]),
        make_edge_batch([[1, 0], [5, 4], [0, 3]], [0, 0, 0], insert=False),
    ]
    for b in steps:
        assert_results_equal(ref.apply(b), got.apply(b))
        assert_stores_equal(ref, got)
    assert got.stats().n_edges_dead == 3  # (0,1), (2,3) and (4,5)


def test_degree_cap_violation_is_atomic_and_named():
    ref = RefStore(8, np.zeros(8, np.int64), degree_cap=2)
    got = GraphStore(8, np.zeros(8, np.int32), degree_cap=2, device="cpu")
    for s in (ref, got):
        s.add_edges([[0, 1], [0, 2], [3, 4]])
    # vertex 3 goes past the cap first in record order, then vertex 0
    bad = make_edge_batch([[3, 5], [3, 6], [0, 7], [1, 2]])
    with pytest.raises(ValueError) as want:
        ref.apply(bad)
    with pytest.raises(ValueError) as err:
        got.apply(bad)
    assert str(err.value) == str(want.value)
    assert "vertex 3" in str(err.value)
    assert_stores_equal(ref, got)
    # deletes offset inserts within one batch: post-batch degrees count
    ok = make_edge_batch([[0, 1], [0, 5]], insert=np.asarray([False, True]))
    assert_results_equal(ref.apply(ok), got.apply(ok))
    assert_stores_equal(ref, got)


def test_random_update_batches_seed_for_seed():
    g = random_labeled_graph(80, 200, 4, seed=5)
    ref = RefStore.from_graph(g, compact_every=2)
    got = GraphStore.from_graph(port(g), compact_every=2, device="cpu")
    for src_ref, src_got in ((g, port(g)), (ref, got)):
        want = r_update_batches(src_ref, 3, 20, delete_frac=0.4,
                                n_edge_labels=2, seed=6)
        batches = random_update_batches(src_got, 3, 20, delete_frac=0.4,
                                        n_edge_labels=2, seed=6)
        for a, b in zip(want, batches):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
        for a, b in zip(want, batches):
            assert_results_equal(ref.apply(a), got.apply(b))
    assert_stores_equal(ref, got)


def test_snapshots_cache_pin_and_release():
    g = random_labeled_graph(40, 90, 3, seed=7)
    ref = RefStore.from_graph(g)
    got = GraphStore.from_graph(port(g), device="cpu")
    for s in (ref, got):
        s0 = s.pin()
        s.add_edges([[0, 39]])
        s.snapshot()
        s.add_edges([[1, 38]])
        assert s.stats().n_snapshots_cached == 1  # epoch 0 is pinned
        assert s.pin(0) is s0
        s.release(0)
        assert s.stats().n_snapshots_cached == 1
        s.release(0)
        assert s.stats().n_snapshots_cached == 0
        assert s.snapshot() is s.snapshot()
    assert tuple(got.stats()) == tuple(ref.stats())
    snap = got.snapshot()
    assert as_snapshot(got) is snap and as_snapshot(snap) is snap
    assert snap.index is None and snap.graph.src.device.type == "cpu"
    assert as_snapshot(snap.graph).epoch == 0
    with pytest.raises(TypeError, match="GraphStore"):
        as_snapshot(ref)


def test_later_slices_and_device_default(monkeypatch):
    """The sharded store (ROADMAP A11) raised until that slice; it now
    holds the reference's edge set and round-trips its checkpoint.  The
    device default."""
    from repro.graphs import ShardedGraphStore as RefShardedStore

    ref_g = random_labeled_graph(20, 40, 3, seed=8)
    g = port(ref_g)
    sharded = ShardedGraphStore.from_graph(g, n_shards=2, device="cpu")
    ref_sharded = RefShardedStore.from_graph(ref_g, n_shards=2)
    back = ShardedGraphStore.from_checkpoint_state(
        *sharded.checkpoint_state(), device="cpu")
    for a, b, c in zip(sharded.alive_edges(), ref_sharded.alive_edges(),
                       back.alive_edges()):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)
    assert sharded.shard_stats() == back.shard_stats()
    store = GraphStore.from_graph(g, device="cpu")
    # persistence came with item 8: the hooks round-trip the edge table
    back = GraphStore.from_checkpoint_state(*store.checkpoint_state(),
                                            device="cpu")
    for a, b in zip(back.alive_edges(), store.alive_edges()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.degrees(), store.degrees())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphStore(4, np.zeros(4, np.int32))
