"""The port's ``IncrementalIndex`` against the reference's, on the
patterns of ``tests/test_incremental.py`` (incremental == scratch, the
saturation boundary, store-backed serving).

Both packages' stores get the same batches.  After each one the port's
index must equal (a) a scratch ``rebuild`` of the port, bit for bit
(counts, degrees, exact and log digests), and (b) the reference's index:
counts, degrees and exact digests bit for bit (the reference's uint64
against the port's int64), log digests within 1e-5 (the reference's own
tolerance, ``tests/test_incremental.py``), and ``IndexStats`` equal.
``store_prefilter`` masks are equal for every variant, and store-backed
engine and batch-engine embeddings are bit-identical, row order included.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.core import BatchQueryEngine as RefBatchEngine
from repro.core import SubgraphQueryEngine as RefEngine
from repro.core.cni import limb_to_u64_np
from repro.core.incremental import IncrementalIndex as RefIndex
from repro.core.incremental import store_digest as r_store_digest
from repro.core.incremental import store_prefilter as r_store_prefilter
from repro.graphs import GraphStore as RefStore
from repro.graphs import random_labeled_graph, random_update_batches
from repro.graphs import random_walk_query
from repro_torch.core import (
    BatchQueryEngine,
    IncrementalIndex,
    ShardedIncrementalIndex,
    SubgraphQueryEngine,
    ilgf,
    store_prefilter,
)
from repro_torch.core import incremental as t_inc
from repro_torch.core.cni import LOG_SAT64, SAT64
from repro_torch.graphs import GraphStore, graph_from_numpy, make_edge_batch
from strategies import edge_batch_from_ops, update_ops

VARIANTS = ["cni", "cni_log", "nlf", "label_degree", "mnd_nlf"]


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def twin_stores(g, *, d_max=None, **kwargs):
    """The same graph in both packages, each with its index attached."""
    ref = RefStore.from_graph(g, **kwargs)
    ref.attach_index(RefIndex(d_max=d_max))
    got = GraphStore.from_graph(port(g), device="cpu", **kwargs)
    got.attach_index(IncrementalIndex(d_max=d_max))
    return ref, got


def star_stores(n_leaves=39):
    """A star centre whose CNI saturates, in both packages."""
    n = 64
    vlab = np.zeros(n, np.int64)
    vlab[1:] = 2
    ref = RefStore(n, vlab)
    ref.attach_index(RefIndex(d_max=64))
    got = GraphStore(n, vlab, device="cpu")
    got.attach_index(IncrementalIndex(d_max=64))
    edges = [[0, i] for i in range(1, 1 + n_leaves)]
    ref.add_edges(edges)
    got.add_edges(edges)
    return ref, got


def scratch(store, idx):
    fresh = IncrementalIndex(d_max=idx.d_max)
    fresh.rebuild(store)
    return fresh


def assert_port_state_equal(idx, want):
    for name in ("counts", "deg", "cni", "cni_log"):
        assert torch.equal(getattr(idx, name), getattr(want, name)), name
    assert (idx.d_max, idx.max_p) == (want.d_max, want.max_p)


def assert_equals_reference(idx, ref):
    np.testing.assert_array_equal(idx.counts.numpy(), ref.counts)
    np.testing.assert_array_equal(idx.deg.numpy(), ref.deg)
    np.testing.assert_array_equal(idx.cni.numpy(), ref.cni_u64.astype(np.int64))
    want_log = ref.cni_log
    got_log = idx.cni_log.numpy()
    fin = np.isfinite(want_log)
    np.testing.assert_array_equal(np.isfinite(got_log), fin)
    np.testing.assert_array_equal(got_log[~fin], want_log[~fin])
    np.testing.assert_allclose(got_log[fin], want_log[fin], rtol=0, atol=1e-5)
    assert (idx.d_max, idx.max_p) == (ref.d_max, ref.max_p)
    assert dataclasses.asdict(idx.stats) == dataclasses.asdict(ref.stats)


def assert_both(got, ref):
    assert_port_state_equal(got.index, scratch(got, got.index))
    assert_equals_reference(got.index, ref.index)


# ---------------------------------------------------------------------------
# incremental == scratch == reference
# ---------------------------------------------------------------------------


def test_random_insert_delete_sequence():
    g = random_labeled_graph(96, 260, 6, n_edge_labels=2, seed=0)
    ref, got = twin_stores(g, compact_every=3)
    assert_both(got, ref)
    for batch in random_update_batches(ref, 8, 24, delete_frac=0.45, seed=7):
        ref.apply(batch)
        got.apply(batch)
        assert_both(got, ref)
    assert got.index.stats.edges_inserted > 0
    assert got.index.stats.edges_deleted > 0


def test_batches_reach_cni_update_with_their_real_delta(monkeypatch):
    """The batch path calls ``cni_update`` once, with the frontier's current
    rows and the batch's nonzero net delta (the reference passes zeros)."""
    g = random_labeled_graph(50, 120, 4, seed=1)
    _, got = twin_stores(g)
    before = got.index.counts.clone()
    calls = []
    inner = t_inc.update_ops.cni_update

    def spy(rows, delta, d_max, max_p):
        calls.append((rows.clone(), delta.clone()))
        return inner(rows, delta, d_max, max_p)

    monkeypatch.setattr(t_inc.update_ops, "cni_update", spy)
    batch = random_update_batches(g, 1, 12, delete_frac=0.5, seed=2)[0]
    res = got.apply(batch)
    assert len(calls) == 1
    rows, delta = calls[0]
    frontier = np.unique(np.concatenate([res.applied.src, res.applied.dst]))
    assert torch.equal(rows, before[torch.as_tensor(frontier)])
    assert torch.equal(rows + delta, got.index.counts[torch.as_tensor(frontier)])
    assert bool((delta < 0).any()) and bool((delta > 0).any())


def test_duplicate_insert_and_missing_delete_are_noops():
    g = random_labeled_graph(40, 90, 4, seed=1)
    ref, got = twin_stores(g)
    before = got.index.freeze()
    src, dst = int(np.asarray(g.src)[0]), int(np.asarray(g.dst)[0])
    for s in (ref, got):
        assert s.add_edges([[src, dst]]).n_skipped == 1
        assert s.remove_edges([[38, 39]] if not s.has_edge(38, 39)
                              else [[0, 0]]).n_deleted == 0
    after = got.index.freeze()
    assert torch.equal(before.counts, after.counts)
    assert torch.equal(before.cni, after.cni)
    assert_equals_reference(got.index, ref.index)


def test_compaction_preserves_logical_state():
    g = random_labeled_graph(60, 150, 5, seed=2)
    ref, got = twin_stores(g, compact_every=0)
    for batch in random_update_batches(ref, 4, 16, delete_frac=0.6, seed=3):
        ref.apply(batch)
        got.apply(batch)
    snap = got.snapshot()
    assert got.compact() == ref.compact() > 0
    for a, b in zip(snap.graph, got.snapshot().graph):
        assert torch.equal(a, b)
    assert_both(got, ref)


@settings(max_examples=8, deadline=None)
@given(update_ops(max_vertex=29, max_ops=40))
def test_property_any_op_sequence(ops):
    g = random_labeled_graph(30, 60, 3, seed=4)
    ref, got = twin_stores(g)
    batch = edge_batch_from_ops(ops)
    if batch is None:
        return
    ref.apply(batch)
    got.apply(batch)
    assert_both(got, ref)


def test_frozen_snapshot_does_not_see_later_batches():
    g = random_labeled_graph(40, 100, 3, seed=5)
    _, got = twin_stores(g)
    snap = got.snapshot()
    counts = snap.index.counts.clone()
    got.add_edges([[0, 39], [1, 38]])
    assert torch.equal(snap.index.counts, counts)
    assert snap.index.epoch == 0 and got.snapshot().index.epoch == 1
    assert snap.index.stats.version == 0


# ---------------------------------------------------------------------------
# saturation boundary
# ---------------------------------------------------------------------------


def test_center_saturates_with_canonical_log():
    ref, got = star_stores()
    assert int(got.index.cni[0]) == SAT64
    assert got.index.cni_log[0].item() == np.float32(LOG_SAT64)
    assert_both(got, ref)


def test_insert_onto_saturated_is_skipped_and_exact():
    ref, got = star_stores()
    skips0 = got.index.stats.saturated_skips
    for s in (ref, got):
        s.add_edges([[0, 50], [0, 51]])
    assert got.index.stats.saturated_skips == skips0 + 1
    assert_both(got, ref)


def test_saturated_delete_takes_recompute_fallback():
    ref, got = star_stores()
    rec0 = got.index.stats.saturated_recomputes
    for s in (ref, got):
        s.remove_edges([[0, 1]])
    assert got.index.stats.saturated_recomputes == rec0 + 1
    assert_both(got, ref)


def test_delete_across_saturation_boundary_restores_exact():
    ref, got = star_stores()
    for leaf in range(1, 40):
        for s in (ref, got):
            s.remove_edges([[0, leaf]])
        assert_port_state_equal(got.index, scratch(got, got.index))
    assert int(got.index.cni[0]) == 0
    assert got.index.stats.saturated_recomputes > 0
    assert_equals_reference(got.index, ref.index)


def test_d_max_autogrowth_rebuild():
    n = 32
    ref = RefStore(n, np.zeros(n, np.int64))
    ref.attach_index(RefIndex(d_max=4))
    got = GraphStore(n, np.zeros(n, np.int32), device="cpu")
    got.attach_index(IncrementalIndex(d_max=4))
    for s in (ref, got):
        s.add_edges([[0, i] for i in range(1, 9)])  # degree 8 > 4
    assert got.index.stats.full_rebuilds == 1 and got.index.d_max == 8
    assert_both(got, ref)
    for s in (ref, got):  # the grown tables serve the next batch
        s.add_edges([[1, 2], [3, 4]])
    assert_both(got, ref)


def test_degree_cap_pins_d_max_and_rejected_batch_leaves_index():
    ref = RefStore(4, np.asarray([0, 1, 0, 1]), degree_cap=1)
    ref.attach_index(RefIndex())
    got = GraphStore(4, np.asarray([0, 1, 0, 1]), degree_cap=1, device="cpu")
    got.attach_index(IncrementalIndex())
    assert got.index.d_max == 1
    frozen = got.index.freeze()
    for s in (ref, got):
        with pytest.raises(ValueError, match="degree_cap"):
            s.add_edges([[0, 1], [2, 3], [0, 2]])
    assert got.epoch == 0 and torch.equal(got.index.counts, frozen.counts)
    for s in (ref, got):
        assert s.add_edges([[0, 1], [2, 3]]).n_inserted == 2
    assert_both(got, ref)


# ---------------------------------------------------------------------------
# engines served from store snapshots
# ---------------------------------------------------------------------------


def served_stores(seed=5):
    g = random_labeled_graph(110, 300, 6, n_edge_labels=2, seed=seed)
    ref, got = twin_stores(g)
    for batch in random_update_batches(ref, 3, 20, delete_frac=0.3,
                                       seed=seed + 1):
        ref.apply(batch)
        got.apply(batch)
    return ref, got


@pytest.mark.parametrize("variant", VARIANTS)
def test_store_prefilter_equals_reference(variant):
    ref, got = served_stores()
    r_snap, t_snap = ref.snapshot(), got.snapshot()
    cache = {}
    for s in range(4):
        q = random_walk_query(r_snap.graph, 5 + s % 2, seed=40 + s)
        want = r_store_prefilter(r_snap.index, q, variant=variant)
        mask = store_prefilter(t_snap.index, port(q), variant=variant,
                               digest_cache=cache)
        assert mask.dtype == torch.bool
        np.testing.assert_array_equal(mask.numpy(), want)
        fixed = ilgf(t_snap.graph, port(q), variant=variant).alive.numpy()
        assert not (fixed & ~mask.numpy()).any()  # sound superset
    assert cache  # same-alphabet queries share one data-side digest


def test_store_digest_restricted_and_full_alphabets():
    ref, got = served_stores()
    r_idx, t_idx = ref.snapshot().index, got.snapshot().index
    for labels in (np.asarray(t_idx.universe), np.asarray([1, 3, 77])):
        want, want_counts, want_ords = r_store_digest(r_idx, labels)
        digest, counts, ords = t_inc.store_digest(t_idx, labels)
        np.testing.assert_array_equal(counts.numpy(), want_counts)
        np.testing.assert_array_equal(ords.numpy(), want_ords)
        np.testing.assert_array_equal(digest.deg.numpy(), want.deg)
        np.testing.assert_array_equal(
            digest.cni.numpy(),
            limb_to_u64_np(want.cni.hi, want.cni.lo).astype(np.int64))
        fin = np.isfinite(want.cni_log)
        np.testing.assert_array_equal(np.isfinite(digest.cni_log.numpy()), fin)
        np.testing.assert_allclose(digest.cni_log.numpy()[fin],
                                   want.cni_log[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("enumerator", ["host", "device"])
def test_engine_on_store_equals_reference_and_fresh_graph(enumerator):
    ref, got = served_stores()
    r_eng = RefEngine(ref, enumerator=enumerator)
    t_eng = SubgraphQueryEngine(got, enumerator=enumerator, device="cpu")
    fresh = SubgraphQueryEngine(got.snapshot().graph, enumerator=enumerator,
                                device="cpu")
    assert t_eng.epoch == ref.epoch
    for s in range(4):
        q = random_walk_query(ref.snapshot().graph, 6, seed=40 + s)
        want, r_st = r_eng.query(q)
        emb, st = t_eng.query(port(q))
        np.testing.assert_array_equal(emb, want)
        assert st.extras["store_prefilter_alive"] == \
            r_st.extras["store_prefilter_alive"]
        assert (st.ilgf_iterations, st.vertices_after, st.candidate_pairs) == \
            (r_st.ilgf_iterations, r_st.vertices_after, r_st.candidate_pairs)
        np.testing.assert_array_equal(fresh.query(port(q))[0], want)


def test_batch_engine_on_store_equals_reference():
    g = random_labeled_graph(90, 240, 5, n_edge_labels=2, seed=8)
    ref, got = twin_stores(g)
    batch = random_update_batches(ref, 1, 30, seed=9)[0]
    ref.apply(batch)
    got.apply(batch)
    queries = [random_walk_query(ref.snapshot().graph, 5, seed=60 + i)
               for i in range(6)]
    want = RefBatchEngine(ref, max_batch=4).query_batch(queries)
    results = BatchQueryEngine(got, max_batch=4, device="cpu").query_batch(
        [port(q) for q in queries])
    seq = SubgraphQueryEngine(got.snapshot().graph, device="cpu")
    for q, (emb, st), (w_emb, w_st) in zip(queries, results, want):
        np.testing.assert_array_equal(emb, w_emb)
        assert st.ilgf_iterations == w_st.ilgf_iterations
        assert set(map(tuple, emb)) == set(map(tuple, seq.query(port(q))[0]))


def test_later_slices_raise():
    """The sharded index (ROADMAP A11) raised until that slice; over a
    plain store it now partitions by its own ``n_shards`` and equals the
    unsharded index, as the reference's does."""
    g = random_labeled_graph(30, 70, 3, seed=2)
    ref, flat = twin_stores(g)
    sharded = GraphStore.from_graph(port(g), device="cpu")
    sharded.attach_index(ShardedIncrementalIndex(n_shards=2))
    edges = [[0, 29], [1, 28], [2, 3]]
    for store in (ref, flat, sharded):
        store.add_edges(edges)
    assert sharded.index._plan.n_shards == 2
    for name in ("counts", "deg", "cni", "cni_log"):
        assert torch.equal(getattr(sharded.index, name),
                           getattr(flat.index, name)), name
    assert_equals_reference(flat.index, ref.index)
    idx = IncrementalIndex()
    store = GraphStore(3, np.zeros(3, np.int32), device="cpu")
    store.attach_index(idx)
    assert store.apply(make_edge_batch([[0, 1]])).n_inserted == 1
    assert idx.counts.device.type == "cpu" and idx._epoch == 1
    # persistence came with item 8: the hooks round-trip the state
    leaves, meta = idx.checkpoint_state()
    back = IncrementalIndex.from_checkpoint_state(leaves, meta, store=store)
    for name in ("counts", "deg", "cni", "cni_log"):
        assert torch.equal(getattr(back, name), getattr(idx, name))
    assert back._epoch == 1 and back.counts.device.type == "cpu"
