"""The port's ``ShardedGraphStore``, ``ShardedIncrementalIndex`` and meshed
services against the reference, on the patterns of
``tests/test_distributed_core.py`` (its in-process classes and its sharded
service script) and ``tests/test_differential.py``'s sharded service.

* Store: the same batches applied to the reference's sharded store, the
  port's and the port's unsharded ``GraphStore`` give the same
  ``ApplyResult``s, alive edges in table order, snapshot graphs, degrees,
  per-shard ghost counts, delta logs, ``shard_stats`` and boundary
  counters.
* Index: counts, degrees and exact digests equal the reference's sharded
  index and the port's unsharded one bit for bit; log digests equal the
  port's unsharded index bit for bit and the reference's within 1e-5
  (``tests/test_torch_incremental.py``); ``IndexStats`` equal the
  reference's, ``boundary_exchanged`` included.
* Persistence: a sharded service snapshot round-trips warm; a directory
  the reference's sharded service wrote restores in the port to an index
  equal to a scratch rebuild; a shard-count disagreement fails closed.
* Services: a meshed ``GraphQueryService`` / ``ReplicatedGraphService``
  over a sharded store equals an unmeshed twin over a ``GraphStore``,
  at 2 and 4 logical shards on the host.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ShardedIncrementalIndex as RefShardedIndex
from repro.graphs import ShardedGraphStore as RefShardedStore
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs import random_update_batches as r_update_batches
from repro.serve import GraphQueryService as RefService
from repro.serve import GraphServiceConfig as RefConfig
from repro_torch.checkpoint import CheckpointError
from repro_torch.core import (
    IncrementalIndex,
    ShardedIncrementalIndex,
    SubgraphQueryEngine,
    device_mesh,
    distributed_ilgf,
    ilgf,
)
from repro_torch.graphs import (
    EdgeBatch,
    GraphStore,
    ShardedGraphStore,
    graph_from_numpy,
)
from repro_torch.serve import (
    GraphQueryService,
    GraphServiceConfig,
    ReplicatedGraphService,
    ServiceCheckpointer,
)

INDEX_STATE = ("counts", "deg", "cni", "cni_log")


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def port_batch(b):
    return EdgeBatch(*(np.asarray(x) for x in b))


def mesh(n):
    return device_mesh(n, devices="cpu")


def triple(g, n_shards=4, **kwargs):
    """The reference's sharded store, the port's, and the port's unsharded
    twin, each with its index."""
    ref = RefShardedStore.from_graph(g, n_shards=n_shards, **kwargs)
    ref.attach_index(RefShardedIndex())
    sh = ShardedGraphStore.from_graph(port(g), n_shards=n_shards,
                                      device="cpu", **kwargs)
    sh.attach_index(ShardedIncrementalIndex())
    flat = GraphStore.from_graph(port(g), device="cpu", **kwargs)
    flat.attach_index(IncrementalIndex())
    return ref, sh, flat


def assert_store_state(ref, sh, flat):
    for x, y in zip(ref.alive_edges(), sh.alive_edges()):
        np.testing.assert_array_equal(x, y)
    s_ref, s_sh, s_flat = ref.snapshot(), sh.snapshot(), flat.snapshot()
    for f in ("vlabels", "src", "dst", "elabels"):
        assert torch.equal(getattr(s_sh.graph, f), getattr(s_flat.graph, f))
        np.testing.assert_array_equal(getattr(s_sh.graph, f).numpy(),
                                      np.asarray(getattr(s_ref.graph, f)))
    np.testing.assert_array_equal(sh.degrees(), ref.degrees())
    np.testing.assert_array_equal(sh.degrees(), flat.degrees())
    assert [tuple(s) for s in sh.shard_stats()] == [
        tuple(s) for s in ref.shard_stats()]
    for t_ref, t_sh in zip(ref._shards, sh._shards):
        assert t_sh.ghosts == t_ref.ghosts
        assert t_sh.delta_log == t_ref.delta_log
    assert sh.n_boundary_edges == ref.n_boundary_edges
    assert sh._n_boundary_records == ref._n_boundary_records
    assert tuple(sh.stats()) == tuple(ref.stats())


def assert_index_state(ref, sh, flat):
    i_ref, i_sh, i_flat = ref.index, sh.index, flat.index
    for name in INDEX_STATE:
        assert torch.equal(getattr(i_sh, name), getattr(i_flat, name)), name
    np.testing.assert_array_equal(i_sh.counts.numpy(), i_ref.counts)
    np.testing.assert_array_equal(i_sh.deg.numpy(), i_ref.deg)
    np.testing.assert_array_equal(i_sh.cni.numpy(),
                                  i_ref.cni_u64.astype(np.int64))
    want_log, got_log = i_ref.cni_log, i_sh.cni_log.numpy()
    fin = np.isfinite(want_log)
    np.testing.assert_array_equal(np.isfinite(got_log), fin)
    np.testing.assert_allclose(got_log[fin], want_log[fin], rtol=0, atol=1e-5)
    assert (i_sh.d_max, i_sh.max_p) == (i_ref.d_max, i_ref.max_p)
    got = dataclasses.asdict(i_sh.stats)
    want = dataclasses.asdict(i_ref.stats)
    assert got == want
    flat_stats = dataclasses.asdict(i_flat.stats)
    flat_stats["boundary_exchanged"] = got["boundary_exchanged"]
    assert got == flat_stats


# ---------------------------------------------------------------------------
# the store and its index against the reference's sharded twins
# ---------------------------------------------------------------------------


class TestShardedStoreParity:
    @pytest.mark.parametrize("n_shards", [2, 4])
    def test_mutation_stream_bit_identical(self, n_shards):
        g = random_labeled_graph(220, 700, 6, n_edge_labels=2, seed=0)
        ref, sh, flat = triple(g, n_shards, compact_every=5)
        for b in r_update_batches(g, 14, 48, delete_frac=0.4, seed=1):
            r1, r2 = ref.apply(b), sh.apply(port_batch(b))
            flat.apply(port_batch(b))
            assert (r2.epoch, r2.n_inserted, r2.n_deleted, r2.n_skipped) == (
                r1.epoch, r1.n_inserted, r1.n_deleted, r1.n_skipped)
            for f in ("src", "dst", "elabels", "insert"):
                np.testing.assert_array_equal(getattr(r2.applied, f),
                                              np.asarray(getattr(r1.applied, f)))
        assert sh.stats().n_compactions > 0
        assert_store_state(ref, sh, flat)
        assert_index_state(ref, sh, flat)

    def test_cross_shard_batches_update_both_owners(self):
        g = random_labeled_graph(220, 700, 6, n_edge_labels=2, seed=0)
        ref, sh, flat = triple(g)
        rng = np.random.default_rng(3)
        lo = rng.integers(0, sh.plan.v_local, size=24)    # shard 0
        hi = rng.integers(sh.plan.v_local, 220, size=24)  # the others
        edges = np.stack([lo, hi], axis=1)
        before = sh.index.stats.boundary_exchanged
        for store in (ref, sh, flat):
            store.add_edges(edges)
        assert sh.index.stats.boundary_exchanged > before
        assert sh.n_boundary_edges > 0
        assert any(s.n_ghosts > 0 for s in sh.shard_stats())
        assert_store_state(ref, sh, flat)
        assert_index_state(ref, sh, flat)

    def test_snapshot_carries_shard_tables(self):
        g = random_labeled_graph(220, 700, 6, n_edge_labels=2, seed=0)
        ref, sh, _ = triple(g)
        snap, want = sh.snapshot(), ref.snapshot()
        assert snap.shards is not None and len(snap.shards) == 4
        for t, w in zip(snap.shards, want.shards):
            for x, y in zip(t, w):
                np.testing.assert_array_equal(x, y)
        for i, t in enumerate(snap.shards):
            assert (sh.plan.owner(t[0]) == i).all() and (t[0] < t[1]).all()

    def test_epoch_consistency_and_pins(self):
        g = random_labeled_graph(220, 700, 6, n_edge_labels=2, seed=0)
        _, sh, _ = triple(g)
        snap0 = sh.pin()
        e0 = snap0.graph.n_edges
        sh.add_edges([[0, 219], [1, 218]])
        assert sh.epoch == snap0.epoch + 1
        assert snap0.graph.n_edges == e0  # the pinned view is untouched
        assert sh.snapshot().graph.n_edges == e0 + 2
        sh.release(snap0.epoch)
        assert sh.has_edge(219, 0) and not sh.has_edge(0, 217)

    def test_degree_cap_atomicity(self):
        g = random_labeled_graph(60, 120, 4, seed=5)
        ref = RefShardedStore.from_graph(g, n_shards=2)
        sh = ShardedGraphStore.from_graph(port(g), n_shards=2, device="cpu")
        for s in (ref, sh):
            s.degree_cap = int(s.max_degree)
        hub = int(np.argmax(sh.degrees()))
        other = next(v for v in range(60)
                     if v != hub and not sh.has_edge(hub, v))
        before = sh.stats()
        with pytest.raises(ValueError, match="degree_cap") as err:
            sh.add_edges([[hub, other]])
        with pytest.raises(ValueError) as ref_err:
            ref.add_edges([[hub, other]])
        assert str(err.value) == str(ref_err.value)
        assert sh.stats() == before  # nothing mutated

    def test_padding_only_shard(self):
        """V = 5 over 4 shards: the last shard owns only padding; its
        tables, index slice and filter slice are empty and inert."""
        g = random_labeled_graph(5, 6, 2, seed=1)
        ref, sh, flat = triple(g)
        assert sh.plan.bounds(3) == (5, 5)
        assert sh.index.shard_state(3).counts.shape[0] == 0
        for store in (ref, sh, flat):
            store.add_edges([[0, 4], [1, 3]])
        assert_store_state(ref, sh, flat)
        assert_index_state(ref, sh, flat)
        q = random_walk_query(g, 2, seed=2)
        want = ilgf(flat.snapshot().graph, port(q))
        got = distributed_ilgf(sh, port(q), mesh(4))
        assert torch.equal(got.alive, want.alive)
        assert torch.equal(got.candidates, want.candidates)


class TestShardedIndexAutoGrow:
    def test_d_max_overflow_rebuild_matches_unsharded(self):
        g = random_labeled_graph(80, 160, 4, seed=0)
        ref, sh, flat = triple(g, 3)
        edges = [[0, v] for v in range(1, 70) if not flat.has_edge(0, v)]
        for store in (ref, sh, flat):
            store.add_edges(edges)
        assert sh.index.stats.full_rebuilds == 1
        assert_index_state(ref, sh, flat)


class TestShardedIndexSaturation:
    def test_saturation_rules_match_unsharded(self):
        # a dense hub graph pushes digests across the saturation boundary
        g = random_labeled_graph(120, 1400, 3, seed=7)
        ref, sh, flat = triple(g, 3)
        for b in r_update_batches(g, 10, 64, delete_frac=0.5, seed=8):
            ref.apply(b)
            sh.apply(port_batch(b))
            flat.apply(port_batch(b))
        assert sh.index.stats.saturated_skips > 0
        assert sh.index.stats.saturated_recomputes > 0
        assert_index_state(ref, sh, flat)

    def test_rebuild_encodes_per_shard_and_freezes_merged(self, monkeypatch):
        from repro_torch.kernels.cni_encode import ref as encode_ref

        g = random_labeled_graph(120, 400, 3, seed=7)
        sh = ShardedGraphStore.from_graph(port(g), n_shards=3, device="cpu")
        rows = []
        real = encode_ref.cni_encode_ref
        monkeypatch.setattr(encode_ref, "cni_encode_ref",
                            lambda c, *a: rows.append(c.shape[0]) or real(c, *a))
        sh.attach_index(ShardedIncrementalIndex())
        assert rows == [40, 40, 40]
        snap = sh.snapshot().index
        flat = IncrementalIndex()
        flat.rebuild(sh)
        for name in INDEX_STATE:
            assert torch.equal(getattr(snap, name), getattr(flat, name))


# ---------------------------------------------------------------------------
# durable snapshots of the sharded store and index
# ---------------------------------------------------------------------------


def sharded_service_dir(tmp_path, n_shards=3):
    g = random_labeled_graph(80, 260, 5, n_edge_labels=2, seed=12)
    store = ShardedGraphStore.from_graph(port(g), n_shards=n_shards,
                                         degree_cap=32, device="cpu")
    store.attach_index(ShardedIncrementalIndex())
    svc = GraphQueryService(store, GraphServiceConfig(
        max_slots=1, max_query_vertices=8, max_query_labels=8,
        checkpoint_dir=str(tmp_path), checkpoint_async=False))
    svc.add_edges([[0, 41], [5, 77]])
    svc.remove_edges([[int(np.asarray(g.src)[3]), int(np.asarray(g.dst)[3])]])
    svc.shutdown()
    return g, store


def test_sharded_checkpoint_roundtrip_is_warm(tmp_path, monkeypatch):
    from repro_torch.kernels.cni_encode import ref as encode_ref

    g, store = sharded_service_dir(tmp_path)
    calls = []
    real = encode_ref.cni_encode_ref
    monkeypatch.setattr(encode_ref, "cni_encode_ref",
                        lambda *a: calls.append(1) or real(*a))
    restored = GraphQueryService.restore(str(tmp_path), device="cpu")
    assert calls == []  # warm: no rebuild, no cni_encode
    st = restored.store
    assert isinstance(st, ShardedGraphStore)
    assert isinstance(st.index, ShardedIncrementalIndex)
    assert st.epoch == store.epoch == 2 and st.n_shards == 3
    for x, y in zip(st.alive_edges(), store.alive_edges()):
        np.testing.assert_array_equal(x, y)
    assert [tuple(s)[:5] for s in st.shard_stats()] == [
        tuple(s)[:5] for s in store.shard_stats()]
    for name in INDEX_STATE:
        assert torch.equal(getattr(st.index, name),
                           getattr(store.index, name)), name
    q = port(random_walk_query(g, 4, seed=6))
    want, _ = SubgraphQueryEngine(store, device="cpu").query(q)
    restored.submit(q)
    (_, emb, _), = restored.run_to_completion()
    np.testing.assert_array_equal(emb, want)
    restored.shutdown()


def test_sharded_restore_fails_closed(tmp_path):
    g, store = sharded_service_dir(tmp_path)
    leaves, meta = store.index.checkpoint_state()
    flat = GraphStore.from_graph(port(g), device="cpu")
    with pytest.raises(CheckpointError, match="ShardedGraphStore"):
        ShardedIncrementalIndex.from_checkpoint_state(leaves, meta, store=flat)
    other = ShardedGraphStore.from_graph(port(g), n_shards=2, device="cpu")
    with pytest.raises(CheckpointError, match="n_shards"):
        ShardedIncrementalIndex.from_checkpoint_state(leaves, meta,
                                                      store=other)
    s_leaves, s_meta = store.checkpoint_state()
    assert s_meta["kind"] == "sharded" and s_meta["n_shards"] == 3
    s_meta.pop("n_shards")
    with pytest.raises(CheckpointError, match="n_shards"):
        ShardedGraphStore.from_checkpoint_state(s_leaves, s_meta,
                                                device="cpu")


def test_reference_sharded_snapshot_restores_to_a_scratch_equal_index(
        tmp_path):
    g = random_labeled_graph(80, 260, 5, n_edge_labels=2, seed=12)
    store = RefShardedStore.from_graph(g, n_shards=3, degree_cap=32)
    store.attach_index(RefShardedIndex())
    svc = RefService(store, RefConfig(
        max_slots=1, max_query_vertices=8, max_query_labels=8,
        checkpoint_dir=str(tmp_path), checkpoint_async=False))
    svc.add_edges([[0, 41], [5, 77]])
    svc.remove_edges([[int(np.asarray(g.src)[3]), int(np.asarray(g.dst)[3])]])
    svc.shutdown()

    step, st = ServiceCheckpointer(str(tmp_path)).restore_latest(device="cpu")
    assert isinstance(st, ShardedGraphStore) and st.n_shards == 3
    assert st.epoch == store.epoch == 2
    for x, y in zip(st.alive_edges(), store.alive_edges()):
        np.testing.assert_array_equal(x, y)
    assert [tuple(s) for s in st.shard_stats()] == [
        tuple(s)[:4] + (s.n_boundary_edges, 0) for s in store.shard_stats()]
    fresh = IncrementalIndex(d_max=st.index.d_max)
    fresh.rebuild(st)
    for name in ("counts", "deg", "cni"):
        assert torch.equal(getattr(st.index, name), getattr(fresh, name)), name
    torch.testing.assert_close(st.index.cni_log, fresh.cni_log, rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# meshed services against unmeshed twins
# ---------------------------------------------------------------------------


def run_service(g, queries, data, cfg, mutate):
    svc = GraphQueryService(data, cfg)
    for q in queries:
        svc.submit(port(q))
    out, ticks = {}, 0
    while len(out) < len(queries) and ticks < 500:
        for rid, emb, st in svc.tick():
            out[rid] = (emb, st.ilgf_iterations, st.extras["service"]["epoch"])
        ticks += 1
        if ticks == 2:
            mutate(svc)
    svc.shutdown()
    return out, svc.metrics_snapshot()["repro_service_rounds_total"]


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("enumerator", ["host", "device"])
def test_meshed_service_equals_unmeshed(n_shards, enumerator):
    """The reference's sharded service script: live mutations crossing
    shards mid-flight, every result equal to the unmeshed service's."""
    g = random_labeled_graph(300, 900, 6, n_edge_labels=2, seed=0)
    qs = [random_walk_query(g, 5, seed=30 + i) for i in range(6)]
    cfg = dict(max_slots=4, max_query_vertices=8, max_query_labels=8,
               enumerator=enumerator)

    def mutate(svc):  # crossing shards
        svc.add_edges([[0, 299], [1, 250]])
        svc.remove_edges([[0, 299]])

    flat = GraphStore.from_graph(port(g), degree_cap=64, device="cpu")
    flat.attach_index(IncrementalIndex())
    want, w_rounds = run_service(g, qs, flat, GraphServiceConfig(**cfg),
                                 mutate)
    sh = ShardedGraphStore.from_graph(port(g), n_shards=4, degree_cap=64,
                                      device="cpu")
    sh.attach_index(ShardedIncrementalIndex())
    got, rounds = run_service(g, qs, sh, GraphServiceConfig(
        mesh=mesh(n_shards), **cfg), mutate)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid][0], want[rid][0])
        assert got[rid][1:] == want[rid][1:]
    assert rounds == w_rounds
    for name in INDEX_STATE:
        assert torch.equal(getattr(sh.index, name), getattr(flat.index, name))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_meshed_service_pinned_epochs_equal_reference(n_shards):
    """tests/test_differential.py's service: a meshed finalize enumerates
    each request against its pinned epoch, equal to the reference's
    unmeshed service."""
    from repro.core.incremental import IncrementalIndex as RefIndex
    from repro.graphs import GraphStore as RefStore

    g = random_labeled_graph(60, 160, 3, n_edge_labels=2, seed=21)
    queries = [random_walk_query(g, 4, sparse=bool(i % 2), seed=30 + i)
               for i in range(3)]
    cfg = dict(max_slots=2, max_query_vertices=8, max_query_labels=8,
               enumerator="device")
    edges = [[i, (i + 11) % 60] for i in range(0, 20, 2)]

    ref_store = RefStore.from_graph(g, degree_cap=64)
    ref_store.attach_index(RefIndex())
    ref = RefService(ref_store, RefConfig(**cfg))
    store = ShardedGraphStore.from_graph(port(g), n_shards=n_shards,
                                         degree_cap=64, device="cpu")
    store.attach_index(ShardedIncrementalIndex())
    svc = GraphQueryService(store, GraphServiceConfig(mesh=mesh(n_shards),
                                                      **cfg))
    for q in queries:
        assert svc.submit(port(q)) == ref.submit(q)
    want = {rid: emb for rid, emb, _ in ref.tick()}  # pins epoch 0
    got = {rid: emb for rid, emb, _ in svc.tick()}
    ref.add_edges(edges)
    svc.add_edges(edges)
    want.update((rid, emb) for rid, emb, _ in ref.run_to_completion())
    got.update((rid, emb) for rid, emb, _ in svc.run_to_completion())
    assert sorted(got) == sorted(want) and len(want) == len(queries)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]))


def test_meshed_replicas_over_a_sharded_store():
    g = random_labeled_graph(200, 700, 5, n_edge_labels=2, seed=4)
    qs = [port(random_walk_query(g, 4, seed=60 + i)) for i in range(6)]
    cfg = dict(max_slots=2, max_query_vertices=8, max_query_labels=8,
               enumerator="device")

    def drive(store, rcfg):
        rep = ReplicatedGraphService(store, rcfg, n_replicas=2)
        rids = [rep.submit(q) for q in qs[:3]]
        done = {rid: emb for rid, emb, _ in rep.tick()}
        rep.add_edges([[0, 199], [3, 150]])
        rids += [rep.submit(q) for q in qs[3:]]
        done.update((rid, emb) for rid, emb, _ in rep.run_to_completion())
        assert sorted(done) == sorted(rids)
        return done

    flat = GraphStore.from_graph(port(g), degree_cap=64, device="cpu")
    flat.attach_index(IncrementalIndex())
    sh = ShardedGraphStore.from_graph(port(g), n_shards=4, degree_cap=64,
                                      device="cpu")
    sh.attach_index(ShardedIncrementalIndex())
    want = drive(flat, GraphServiceConfig(**cfg))
    got = drive(sh, GraphServiceConfig(mesh=mesh(4), **cfg))
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
