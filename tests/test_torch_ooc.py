"""The port's out-of-core store against the reference's.

On the patterns of ``tests/test_ooc_store.py``, ``tests/test_ooc_faults.py``
and the out-of-core cases of ``tests/test_differential.py`` and
``tests/test_checkpoint_recovery.py``:

* **Parity.**  The same graph and the same edge batches go into the
  reference's and the port's ``OutOfCoreGraphStore``.  After every batch
  the ``ApplyResult``s, the alive edges, degrees and stats are equal; the
  sequential engine (dfs, host join, device join) and the batch engine
  return the reference's rows in its order, ``max_embeddings`` prefixes
  included, before and after mutation and compaction; the generations'
  chunk files are byte-identical; the service gives the reference
  service's results.  The query side's ``chunks_read``,
  ``edges_fetched``, ``n_chunks`` and ``partial`` always equal the
  reference's; the cache's hit, miss and byte counters do until the first
  ``apply`` (the port groups a batch's probes by chunk).
* **Shared format.**  A directory the reference wrote opens and answers
  in the port, and the reverse.
* **Mechanics.**  LRU accounting under a tiny budget, interval pruning,
  epoch pins keeping generation files, the streaming index and stats
  rebuild, and the resident-set bound in a subprocess.
* **Faults.**  Truncated, corrupted, disagreeing and missing chunks,
  broken manifests and sidecars, and a failing read raise
  ``ChunkIOError``; the service frees the slot, releases the pin and
  records the partial report; the same snapshot answers again once the
  fault clears.
* **Durable snapshots.**  A roundtrip restores the same generation and
  overlay; a vanished generation fails closed; a reference-written
  snapshot restores in the port.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import repro_torch
import repro_torch.graphs.io as pio
import repro_torch.graphs.ooc as ooc_mod
from repro.core.batch_engine import BatchQueryEngine as RefBatch
from repro.core.engine import SubgraphQueryEngine as RefEngine
from repro.graphs import OutOfCoreGraphStore as RefOoc
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.store import EdgeBatch as RefEdgeBatch
from repro.serve import GraphQueryService as RefService
from repro.serve import GraphServiceConfig as RefConfig
from repro.serve import ServiceCheckpointer as RefCheckpointer
from repro_torch import obsv
from repro_torch.checkpoint import CheckpointError
from repro_torch.core import (
    BatchQueryEngine,
    IncrementalIndex,
    SubgraphQueryEngine,
    device_mesh,
)
from repro_torch.core.stats import GraphStats
from repro_torch.graphs import (
    ChunkIOError,
    EdgeBatch,
    GraphStore,
    OutOfCoreGraphStore,
    build_graph,
    graph_from_numpy,
)
from repro_torch.serve import (
    FailedRequest,
    GraphQueryService,
    GraphServiceConfig,
    ServiceCheckpointer,
)
from strategies import emb_set

_V, _E = 36, 90
_PATHS = ({"searcher": "dfs"}, {"searcher": "join"}, {"enumerator": "device"})
_QUERY_SIDE = ("chunks_read", "edges_fetched", "n_chunks", "partial")
_SRC = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def _graph(seed=0, n_vertices=_V, n_edges=_E):
    return random_labeled_graph(n_vertices, n_edges, 3, n_edge_labels=2,
                                seed=seed)


def twins(g, tmp_path, **kwargs):
    ref = RefOoc.from_graph(g, storage_dir=str(tmp_path / "ref"), **kwargs)
    got = OutOfCoreGraphStore.from_graph(port(g), storage_dir=str(
        tmp_path / "port"), device="cpu", **kwargs)
    return ref, got


def same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def assert_stores_equal(ref, got):
    assert got.epoch == ref.epoch and got.generation == ref.generation
    assert tuple(got.stats()) == tuple(ref.stats())
    assert (got.n_edges, got.overlay_edges, got.n_chunks) == \
        (ref.n_edges, ref.overlay_edges, ref.n_chunks)
    for a, b in zip(ref.alive_edges(), got.alive_edges()):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(got.degrees(), ref.degrees())
    np.testing.assert_array_equal(got.index.cni.numpy(),
                                  np.asarray(ref.index.cni_u64).astype(np.int64))
    np.testing.assert_array_equal(got.index.counts.numpy(),
                                  np.asarray(ref.index.counts))


def assert_queries_equal(ref, got, q, *, caps=(None,), full_counters=False):
    """Every enumeration path and the batch engine: the reference's rows in
    its order, and its query-side chunk telemetry."""
    rs, ps = ref.snapshot(), got.snapshot()
    for cap in caps:
        for kw in _PATHS:
            want, w_st = RefEngine(rs, **kw).query(q, max_embeddings=cap)
            emb, st = SubgraphQueryEngine(ps, device="cpu", **kw).query(
                port(q), max_embeddings=cap)
            np.testing.assert_array_equal(emb, np.asarray(want),
                                          err_msg=f"{kw} cap={cap}")
            keys = tuple(w_st.extras["ooc"]) if full_counters else _QUERY_SIDE
            for k in keys:
                if k != "fetch_seconds":
                    assert st.extras["ooc"][k] == w_st.extras["ooc"][k], k
            assert st.extras["store_prefilter_alive"] == \
                w_st.extras["store_prefilter_alive"]
            obsv.validate_extras(st.extras)
        want = RefBatch(rs).query_batch([q, q], max_embeddings=cap)
        got_b = BatchQueryEngine(ps, device="cpu").query_batch(
            [port(q), port(q)], max_embeddings=cap)
        for (w, w_st), (e, st) in zip(want, got_b):
            np.testing.assert_array_equal(e, np.asarray(w))
            for k in _QUERY_SIDE:
                assert st.extras["ooc"][k] == w_st.extras["ooc"][k], k


def messy_batch(rng, store, k):
    """k records: deletes of alive edges (some repeated, some already gone),
    inserts of new pairs and of alive ones, self-loops, padding rows."""
    lo, hi, _ = store.alive_edges()
    recs = []
    for _ in range(k):
        if lo.size and rng.random() < 0.5:
            j = int(rng.integers(lo.size))
            a, b = int(lo[j]), int(hi[j])
            if rng.random() < 0.5:
                a, b = b, a
        else:
            a, b = (int(x) for x in rng.integers(0, store.n_vertices, 2))
        recs.append((a, b, int(rng.integers(0, 2)), bool(rng.random() < 0.5)))
    recs += recs[: k // 5]
    arr = np.asarray([r[:3] for r in recs], dtype=np.int64)
    return RefEdgeBatch(src=arr[:, 0], dst=arr[:, 1], elabels=arr[:, 2],
                        insert=np.asarray([r[3] for r in recs]),
                        valid=rng.random(len(recs)) < 0.9)


def apply_both(ref, got, batch):
    r = ref.apply(batch)
    t = got.apply(EdgeBatch(*batch))
    assert (t.epoch, t.n_inserted, t.n_deleted, t.n_skipped) == \
        (r.epoch, r.n_inserted, r.n_deleted, r.n_skipped)
    for name in RefEdgeBatch._fields:
        x, y = getattr(t.applied, name), getattr(r.applied, name)
        np.testing.assert_array_equal(x, y, name)
        assert x.dtype == y.dtype, name


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 2])
def test_seeded_stores_equal_reference(tmp_path, seed):
    g = _graph(seed)
    q = random_walk_query(g, 4, seed=seed + 1)
    ref, got = twins(g, tmp_path, chunk_edges=16)
    same_dirs(ref._base.path, got._base.path)
    assert_stores_equal(ref, got)
    # before any apply the caches hold the same chunks: every counter agrees
    total = RefEngine(ref.snapshot()).query(q)[0].shape[0]
    assert_queries_equal(ref, got, q, full_counters=True,
                         caps=(None, 1, max(1, total // 2), total + 5))


def test_mutation_stream_and_compaction_equal_reference(tmp_path):
    g = _graph(3)
    q = random_walk_query(g, 4, seed=4)
    ref, got = twins(g, tmp_path, chunk_edges=16)
    rng = np.random.default_rng(7)
    for _ in range(4):
        apply_both(ref, got, messy_batch(rng, ref, 24))
        assert_stores_equal(ref, got)
    assert got.overlay_edges > 0
    assert_queries_equal(ref, got, q)
    assert got.compact() == ref.compact()
    assert_stores_equal(ref, got)
    same_dirs(ref._base.path, got._base.path)
    assert got.overlay_edges == 0 and got.generation == 2
    assert_queries_equal(ref, got, q)
    # the overlay over a compacted base: re-inserts of tombstoned edges
    apply_both(ref, got, messy_batch(rng, ref, 24))
    assert_stores_equal(ref, got)
    assert_queries_equal(ref, got, q, caps=(None, 2))


def test_compact_every_and_has_edge_equal_reference(tmp_path):
    g = _graph(5)
    ref, got = twins(g, tmp_path, chunk_edges=8, compact_every=2)
    rng = np.random.default_rng(11)
    for _ in range(4):
        apply_both(ref, got, messy_batch(rng, ref, 16))
        assert_stores_equal(ref, got)
    pairs = rng.integers(0, _V, size=(60, 2))
    assert [got.has_edge(int(a), int(b)) for a, b in pairs] == \
        [ref.has_edge(int(a), int(b)) for a, b in pairs]


def test_service_equals_reference_and_counters_sum(tmp_path):
    """Both services over twin out-of-core stores, a deletion batch between
    admissions: the same rows per request, the same query-side telemetry,
    and the ``repro_ooc_*`` counters equal the sum of the epochs'
    reports."""
    g = random_labeled_graph(60, 160, 3, n_edge_labels=2, seed=21)
    queries = [random_walk_query(g, 4, sparse=bool(i % 2), seed=30 + i)
               for i in range(4)]
    ref, got = twins(g, tmp_path, chunk_edges=32, degree_cap=64)
    lo, hi, _ = ref.alive_edges()
    dels = np.stack([lo[:6], hi[:6]], axis=1)
    cfg = dict(max_slots=2, max_query_vertices=8, max_query_labels=8)
    results = []
    for svc, qs in ((RefService(ref, RefConfig(**cfg)), queries),
                    (GraphQueryService(got, GraphServiceConfig(**cfg)),
                     [port(q) for q in queries])):
        rids = [svc.submit(q) for q in qs[:2]]
        done = {rid: (emb, st) for rid, emb, st in svc.tick()}
        svc.remove_edges(dels)
        rids += [svc.submit(q, max_embeddings=5) for q in qs[2:]]
        done.update((rid, (emb, st)) for rid, emb, st in
                    svc.run_to_completion())
        results.append([done[r] for r in rids])
        last = svc
    for (w, w_st), (e, st) in zip(*results):
        np.testing.assert_array_equal(e, np.asarray(w))
        for k in _QUERY_SIDE + ("fetches",):
            assert st.extras["ooc"][k] == w_st.extras["ooc"][k], k
    reports = {st.extras["service"]["epoch"]: st.extras["ooc"]
               for _, st in results[1]}
    snap = last.metrics_snapshot()
    for metric, key in (("repro_ooc_chunks_read_total", "chunks_read"),
                        ("repro_ooc_bytes_read_total", "bytes_read"),
                        ("repro_ooc_cache_hits_total", "cache_hits"),
                        ("repro_ooc_cache_misses_total", "cache_misses")):
        assert snap[metric]["series"][()] == sum(r[key] for r in reports.values())
    ratio = snap["repro_ooc_cache_hit_ratio"]["series"][()]
    assert ratio == got.cache.hits / (got.cache.hits + got.cache.misses)
    assert got._pins == {}


# ---------------------------------------------------------------------------
# the shared on-disk format
# ---------------------------------------------------------------------------


def test_directories_open_in_either_package(tmp_path):
    g = _graph(1)
    q = random_walk_query(g, 4, seed=2)
    ref, got = twins(g, tmp_path, chunk_edges=16)
    want = RefEngine(ref.snapshot()).query(q)[0]
    ref_root, port_root = ref._root, got._root
    del ref, got
    back = OutOfCoreGraphStore.open(ref_root, device="cpu")
    assert back.chunk_edges == 16  # adopted from the manifest
    np.testing.assert_array_equal(
        SubgraphQueryEngine(back.snapshot(), device="cpu").query(port(q))[0],
        np.asarray(want))
    np.testing.assert_array_equal(
        RefEngine(RefOoc.open(port_root).snapshot()).query(q)[0],
        np.asarray(want))


# ---------------------------------------------------------------------------
# store mechanics
# ---------------------------------------------------------------------------


def test_streaming_rebuild_matches_one_shot(monkeypatch):
    """An index and ``GraphStats`` built from uneven streamed blocks equal
    the one-shot build: counts, digests and aggregates."""
    g = port(_graph(3, n_vertices=60, n_edges=200))
    one = GraphStore.from_graph(g, device="cpu")
    one.attach_index(IncrementalIndex())
    streamed = GraphStore.from_graph(g, device="cpu")

    def uneven_chunks():
        lo, hi, lab = streamed.alive_edges()
        for part in np.array_split(np.arange(lo.size), [0, 1, 7, 8, 90, 150]):
            yield lo[part], hi[part], lab[part]

    monkeypatch.setattr(streamed, "iter_alive_edge_chunks", uneven_chunks,
                        raising=False)
    streamed.attach_index(IncrementalIndex())
    for name in ("counts", "deg", "cni", "cni_log"):
        np.testing.assert_array_equal(getattr(streamed.index, name).numpy(),
                                      getattr(one.index, name).numpy(), name)
    a, b = GraphStats.from_store(one), GraphStats.from_store(streamed)
    assert (a.n_edges, a.version) == (b.n_edges, b.version)
    for name in ("label_hist", "deg_sum", "pair_counts"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    # the out-of-core store streams its chunks into the same state
    ooc = OutOfCoreGraphStore.from_graph(g, chunk_edges=16, device="cpu")
    for name in ("counts", "cni", "cni_log"):
        np.testing.assert_array_equal(getattr(ooc.index, name).numpy(),
                                      getattr(one.index, name).numpy(), name)
    c = GraphStats.from_store(ooc)
    np.testing.assert_array_equal(c.pair_counts, a.pair_counts)


def test_cache_eviction_under_budget(tmp_path):
    g = port(_graph(n_vertices=60, n_edges=300))
    store = OutOfCoreGraphStore.from_graph(
        g, storage_dir=str(tmp_path / "s"), chunk_edges=8,
        resident_budget_bytes=3 * 8 * 24, device="cpu")
    handle = store.snapshot().ooc
    chunk_bytes = 8 * 24
    for _ in range(2):  # full fetches cycle every chunk through the LRU
        graph, _ = handle.fetch_restricted(np.ones(store.n_vertices, bool))
        assert graph.src.shape[0] // 2 == store.n_edges
    c = store.cache
    assert c.misses > c.budget_bytes // chunk_bytes
    assert c.resident_bytes <= c.budget_bytes
    assert c.peak_resident_bytes <= c.budget_bytes + chunk_bytes
    assert c.bytes_read > c.budget_bytes


def test_chunk_interval_pruning():
    n = 4000
    v = n + 2
    vlab = np.zeros(v, np.int64)
    vlab[:8] = 1
    i = np.arange(n, dtype=np.int64)
    lo = np.repeat(i, 2)
    hi = np.empty_like(lo)
    hi[0::2], hi[1::2] = i + 1, i + 2
    g = build_graph(v, vlab, np.stack([lo, hi], axis=1), device="cpu")
    store = OutOfCoreGraphStore.from_graph(g, chunk_edges=256, device="cpu")
    assert store.n_chunks > 10
    q = build_graph(3, [1, 1, 1], [(0, 1), (1, 2)], device="cpu")
    emb, stats = SubgraphQueryEngine(store.snapshot(), device="cpu").query(q)
    tel = stats.extras["ooc"]
    assert emb.shape[0] > 0 and tel["chunks_read"] < tel["n_chunks"] // 4
    assert emb_set(emb) == emb_set(
        SubgraphQueryEngine(g, device="cpu").query(q)[0])


def test_epoch_pin_keeps_generation_files(tmp_path):
    import gc

    g = port(_graph())
    q = port(random_walk_query(_graph(), 4, seed=1))
    store = OutOfCoreGraphStore.from_graph(
        g, storage_dir=str(tmp_path / "store"), chunk_edges=16, device="cpu")
    snap0 = store.pin()
    old_dir = store._base.path
    want = SubgraphQueryEngine(snap0, device="cpu").query(q)[0]
    lo, hi, _ = store.alive_edges()
    store.remove_edges(np.stack([lo[:5], hi[:5]], axis=1))
    assert store.compact() > 0
    assert store._base.path != old_dir and os.path.isdir(old_dir)
    store.cache.drop_generation(snap0.ooc.base.gen_id)  # force disk reads
    np.testing.assert_array_equal(
        SubgraphQueryEngine(snap0, device="cpu").query(q)[0], want)
    store.release(snap0.epoch)
    del snap0
    gc.collect()
    store.snapshot()  # the GC sweep runs on snapshot traffic
    assert not os.path.isdir(old_dir)


def test_all_dead_prefilter_reads_nothing():
    store = OutOfCoreGraphStore.from_graph(port(_graph()), chunk_edges=16,
                                           device="cpu")
    graph, tel = store.snapshot().ooc.fetch_restricted(
        np.zeros(store.n_vertices, bool))
    assert graph.src.shape[0] == 0
    assert tel["chunks_read"] == 0 and tel["bytes_read"] == 0
    with pytest.raises(ValueError, match="alive0"):
        store.snapshot().ooc.fetch_restricted(np.ones(3, bool))


_RESIDENT_SET_SCRIPT = r"""
import os, sys
import numpy as np
from strategies import peak_rss_bytes
from repro_torch.core import SubgraphQueryEngine
from repro_torch.graphs import OutOfCoreGraphStore, build_graph
from repro_torch.graphs.io import ChunkDirWriter

root = sys.argv[1]
N = 120_000
V = N + 2
BUDGET = 1 << 18  # 256 KiB chunk-cache budget
vlab = np.zeros(V, np.int64)
vlab[:10] = 1
w = ChunkDirWriter(os.path.join(root, "gen-00000"), V, vlab, chunk_edges=2048)
for start in range(0, N, 8192):  # streamed: never materialised
    i = np.arange(start, min(start + 8192, N), dtype=np.int64)
    lo = np.repeat(i, 2)
    hi = np.empty_like(lo)
    hi[0::2], hi[1::2] = i + 1, i + 2
    w.add(lo, hi, np.zeros(lo.size, np.int64))
manifest = w.close()
disk_bytes = 24 * manifest["n_records"]
assert disk_bytes >= 10 * BUDGET, (disk_bytes, BUDGET)
store = OutOfCoreGraphStore.open(root, resident_budget_bytes=BUDGET,
                                 device="cpu")
q = build_graph(3, [1, 1, 1], [(0, 1), (1, 2)], device="cpu")
eng = SubgraphQueryEngine(store.snapshot(), device="cpu")
emb0, _ = eng.query(q)  # warm up to the steady high-water mark
eng.query(q)
base = peak_rss_bytes()
emb, stats = eng.query(q)
tel = stats.extras["ooc"]
assert emb.shape[0] > 0 and emb.shape == emb0.shape
assert tel["chunks_read"] < tel["n_chunks"], tel
assert store.cache.peak_resident_bytes <= BUDGET + 2048 * 24
delta = peak_rss_bytes() - base
assert delta < disk_bytes // 2, (delta, disk_bytes)
print("OK", store.n_edges, tel["chunks_read"], tel["n_chunks"], delta)
"""


def test_resident_set_bounded_subprocess(tmp_path):
    """A table 20x the chunk-cache budget, built and queried in a fresh
    process (``ru_maxrss`` is a high-water mark): the query's growth of the
    resident set is far below the table."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_SRC, os.path.dirname(os.path.abspath(__file__))])
    out = subprocess.run(
        [sys.executable, "-c", _RESIDENT_SET_SCRIPT, str(tmp_path / "big")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK" in out.stdout


# ---------------------------------------------------------------------------
# faults: typed errors, contained, recoverable
# ---------------------------------------------------------------------------


@pytest.fixture
def store_and_query(tmp_path):
    g = _graph()
    q = port(random_walk_query(g, 4, seed=1))
    store = OutOfCoreGraphStore.from_graph(
        port(g), storage_dir=str(tmp_path / "store"), chunk_edges=16,
        device="cpu")
    assert store.n_chunks >= 3
    return store, q


def _chunk_files(store):
    return [os.path.join(store._base.path, e["file"])
            for e in store._base.entries]


def _cold(store):
    store.cache.drop_generation(store.generation)


@pytest.mark.parametrize("fault,match", [
    ("truncate", "bytes"), ("magic", "magic"), ("drift", "disagrees"),
    ("remove", "missing")])
def test_chunk_faults_fail_closed_and_recover(store_and_query, tmp_path,
                                              fault, match):
    store, q = store_and_query
    eng = SubgraphQueryEngine(store.snapshot(), device="cpu")
    want = eng.query(q)[0]
    assert want.shape[0] > 0
    bak = str(tmp_path / "backup")
    shutil.copytree(store._base.path, bak)
    for fp in _chunk_files(store):
        if fault == "remove":
            os.remove(fp)
            continue
        with open(fp, "r+b") as f:
            if fault == "truncate":
                f.truncate(os.path.getsize(fp) - 8)
            elif fault == "magic":
                f.write(b"\xde\xad\xbe\xef" * 2)
            else:  # header word 2 = lo_min
                f.seek(16)
                f.write(np.int64(_V + 7).tobytes())
    _cold(store)
    with pytest.raises(ChunkIOError, match=match):
        eng.query(q)
    shutil.rmtree(store._base.path)
    shutil.copytree(bak, store._base.path)
    _cold(store)
    np.testing.assert_array_equal(eng.query(q)[0], want)


def test_manifest_and_sidecar_faults_fail_at_open(store_and_query, tmp_path):
    import json

    store, _ = store_and_query
    root = str(tmp_path / "store")
    mpath = os.path.join(store._base.path, pio.MANIFEST_NAME)
    good = open(mpath).read()
    manifest = json.loads(good)
    del manifest["chunks"][0]["n_records"]
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ChunkIOError, match="missing"):
        OutOfCoreGraphStore.open(root, device="cpu")
    with open(mpath, "w") as f:
        f.write("{ not json")
    with pytest.raises(ChunkIOError, match="JSON"):
        OutOfCoreGraphStore.open(root, device="cpu")
    os.remove(mpath)
    with pytest.raises(ChunkIOError, match="manifest"):
        OutOfCoreGraphStore.open(root, device="cpu")
    with open(mpath, "w") as f:
        f.write(good)
    vpath = os.path.join(store._base.path, "vlabels.bin")
    with open(vpath, "r+b") as f:
        f.truncate(os.path.getsize(vpath) - 8)
    with pytest.raises(ChunkIOError):
        OutOfCoreGraphStore.open(root, device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(ChunkIOError, match="no gen-"):
        OutOfCoreGraphStore.open(str(tmp_path / "empty"), device="cpu")


def test_simulated_read_failure_mid_query(store_and_query, monkeypatch):
    store, q = store_and_query
    eng = SubgraphQueryEngine(store.snapshot(), device="cpu")
    want = eng.query(q)[0]
    _cold(store)
    with monkeypatch.context() as mp:

        def flaky(*args, **kw):
            raise OSError("simulated device read failure")

        mp.setattr(pio.np, "memmap", flaky)
        with pytest.raises(ChunkIOError, match="could not be mapped"):
            eng.query(q)
    _cold(store)
    np.testing.assert_array_equal(eng.query(q)[0], want)


def _boom(path, entry, n_vertices):
    raise ChunkIOError("simulated chunk failure")


def test_service_fails_closed_and_keeps_serving(store_and_query, monkeypatch):
    store, q = store_and_query
    svc = GraphQueryService(store, GraphServiceConfig(
        max_slots=2, max_query_vertices=8, max_query_labels=8))
    _cold(store)
    with monkeypatch.context() as mp:
        mp.setattr(ooc_mod, "read_chunk", _boom)
        rid = svc.submit(q)
        with pytest.raises(ChunkIOError, match="simulated"):
            svc.tick()
    assert svc.n_active == 0 and store._pins == {}
    fail = svc.failures[0]
    assert isinstance(fail, FailedRequest) and fail.rid == rid
    assert fail.queued_seconds >= 0.0
    # the cold cache made the first chunk access fail: one attempted read
    assert isinstance(fail.ooc, obsv.OocReport) and fail.ooc["partial"]
    assert (fail.ooc["chunks_read"], fail.ooc["bytes_read"],
            fail.ooc["edges_fetched"]) == (1, 0, 0)
    counts = svc.metrics_snapshot()["repro_service_requests_total"]
    assert counts["series"][(("status", "failed"),)] == 1
    # the fault clears: the same query completes and equals a fresh engine
    rid2 = svc.submit(q)
    done = svc.run_to_completion()
    assert [r for r, _, _ in done] == [rid2]
    np.testing.assert_array_equal(
        done[0][1],
        SubgraphQueryEngine(store.snapshot(), device="cpu").query(q)[0])
    # a request cancelled in flight carries its epoch's IO
    _cold(store)
    lo, hi, _ = store.alive_edges()
    svc.remove_edges(np.stack([lo[:3], hi[:3]], axis=1))
    rid3 = svc.submit(q)
    svc._admit()
    _, cancelled = svc.shutdown(drain=False)
    by_rid = {c.rid: c for c in cancelled}
    assert by_rid[rid3].ooc["chunks_read"] > 0
    assert by_rid[rid3].ooc["partial"] is False


def test_batch_engine_fails_closed(store_and_query, monkeypatch):
    store, q = store_and_query
    eng = BatchQueryEngine(store.snapshot(), device="cpu")
    want = eng.query_batch([q])[0][0]
    _cold(store)
    with monkeypatch.context() as mp:
        mp.setattr(ooc_mod, "read_chunk", _boom)
        with pytest.raises(ChunkIOError, match="simulated") as err:
            eng.query_batch([q])
    assert err.value.tel["partial"] is True
    _cold(store)
    np.testing.assert_array_equal(eng.query_batch([q])[0][0], want)


def test_engines_need_the_index(store_and_query):
    store, _ = store_and_query
    bare = OutOfCoreGraphStore.open(store._root, index=None, device="cpu")
    with pytest.raises(ValueError, match="incremental index"):
        SubgraphQueryEngine(bare, device="cpu")
    # an out-of-core snapshot runs single-host: mesh= raises the
    # reference's ValueError in both engines and the service
    m = device_mesh(2, devices="cpu")
    with pytest.raises(ValueError, match="out-of-core stores run "
                       "single-host; build the batch engine without mesh="):
        BatchQueryEngine(store, mesh=m, device="cpu")
    with pytest.raises(ValueError, match="build the engine without mesh="):
        SubgraphQueryEngine(store, mesh=m, device="cpu")
    with pytest.raises(ValueError, match="drop GraphServiceConfig.mesh"):
        GraphQueryService(store, GraphServiceConfig(mesh=m))


# ---------------------------------------------------------------------------
# durable snapshots
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_missing_generation(store_and_query,
                                                     tmp_path):
    store, q = store_and_query
    store.add_edges([[0, 21]])
    store.remove_edges(np.stack(store.alive_edges()[:2], axis=1)[:2])
    ckpt = ServiceCheckpointer(str(tmp_path / "c"), async_write=False)
    ckpt.save(store)
    _, back = ckpt.restore_latest(device="cpu")
    assert isinstance(back, OutOfCoreGraphStore)
    assert (back.epoch, back.generation, back.overlay_edges) == \
        (store.epoch, store.generation, store.overlay_edges)
    for a, b in zip(store.alive_edges(), back.alive_edges()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(back.index.cni.numpy(),
                                  store.index.cni.numpy())
    np.testing.assert_array_equal(
        SubgraphQueryEngine(back, device="cpu").query(q)[0],
        SubgraphQueryEngine(store, device="cpu").query(q)[0])
    shutil.rmtree(store._base.path)
    with pytest.raises(CheckpointError, match="generation"):
        ckpt.restore_latest(device="cpu")


def test_reference_snapshot_restores_in_the_port(tmp_path):
    g = _graph(4)
    q = random_walk_query(g, 4, seed=5)
    ref = RefOoc.from_graph(g, storage_dir=str(tmp_path / "chunks"),
                            chunk_edges=16)
    ref.add_edges([[0, 21]])
    RefCheckpointer(str(tmp_path / "c"), async_write=False).save(ref)
    svc = GraphQueryService.restore(str(tmp_path / "c"), device="cpu")
    back = svc.store
    assert (back.epoch, back.generation) == (ref.epoch, ref.generation)
    for a, b in zip(ref.alive_edges(), back.alive_edges()):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_array_equal(back.index.counts.numpy(),
                                  np.asarray(ref.index.counts))
    np.testing.assert_array_equal(
        SubgraphQueryEngine(back, device="cpu").query(port(q))[0],
        np.asarray(RefEngine(ref.snapshot()).query(q)[0]))
