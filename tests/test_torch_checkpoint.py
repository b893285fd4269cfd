"""The port's durable snapshots (``repro_torch.checkpoint``,
``repro_torch.serve.persist``) on the patterns of
``tests/test_checkpoint_recovery.py``, against the reference.

* A service killed with SIGKILL mid-stream (a real subprocess running the
  port) restores to a committed epoch E equal, bit for bit, to an unkilled
  twin that replayed the first E mutations.
* A roundtrip after mutations restores the same edge set and a warm index
  (no rebuild, no ``cni_encode``) equal to the original bit for bit, and
  the same answers as the reference on the same calls.
* Reads fail closed: an empty directory, a truncated or missing leaf, a
  ``leaf_keys`` disagreement and a torn store/index pair raise
  ``CheckpointError``; an async write's failure surfaces on ``wait``, on
  the next ``save`` and through the service.
* A snapshot directory the reference wrote restores in the port to an
  index equal to the port's scratch rebuild.
* An in-memory snapshot relabelled sharded (no ``n_shards``) or
  out-of-core (no overlay leaves) fails closed.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
import repro_torch.checkpoint.ckpt as ckpt_mod
from repro.core.incremental import IncrementalIndex as RefIndex
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.store import GraphStore as RefStore
from repro.serve import GraphQueryService as RefService
from repro.serve import GraphServiceConfig as RefConfig
from repro.serve import ServiceCheckpointer as RefCheckpointer
from repro_torch.checkpoint import (
    CheckpointError,
    CheckpointManager,
    latest_step,
    load_leaves,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core import GraphStats, IncrementalIndex, SubgraphQueryEngine
from repro_torch.graphs import GraphStore, ShardedGraphStore, graph_from_numpy
from repro_torch.kernels.cni_encode import ref as encode_ref
from repro_torch.serve import (
    GraphQueryService,
    GraphServiceConfig,
    ServiceCheckpointer,
)

_SRC = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
INDEX_STATE = ("counts", "deg", "cni", "cni_log")


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def eset(emb):
    emb = np.asarray(emb)
    return set(map(tuple, emb.reshape(emb.shape[0], -1).tolist()))


def port_store(g, **kwargs):
    store = GraphStore.from_graph(port(g), device="cpu", **kwargs)
    store.attach_index(IncrementalIndex())
    return store


def same_index(a, b):
    for name in INDEX_STATE:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.d_max, a.max_p, a._epoch) == (b.d_max, b.max_p, b._epoch)
    sa, sb = a.graph_stats, b.graph_stats
    assert (sa.bucket, sa._drift, sa.version, sa.n_edges) == (
        sb.bucket, sb._drift, sb.version, sb.n_edges)
    np.testing.assert_array_equal(sa.pair_counts, sb.pair_counts)
    np.testing.assert_array_equal(sa.deg_sum, sb.deg_sum)


def same_edges(a, b):
    for x, y in zip(a.alive_edges(), b.alive_edges()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.vlabels, b.vlabels)


# ---------------------------------------------------------------------------
# the checkpoint substrate
# ---------------------------------------------------------------------------


class TestCheckpointFiles:
    def test_flatten_order_and_restore_into_like(self, tmp_path):
        tree = {"b": [np.arange(3), (torch.ones(2, 2), None)],
                "a": torch.arange(4, dtype=torch.int64)}
        save_checkpoint(str(tmp_path), 7, tree, extra={"k": 1})
        leaves, manifest = load_leaves(str(tmp_path), 7)
        # dicts flatten in sorted-key order, as jax.tree.flatten does
        assert [x.tolist() for x in leaves] == [
            [0, 1, 2, 3], [0, 1, 2], [[1.0, 1.0], [1.0, 1.0]]]
        assert manifest["dtypes"] == ["int64", "int64", "float32"]
        like = {"b": [np.zeros(3, np.int32), (torch.zeros(2, 2), None)],
                "a": torch.zeros(4, dtype=torch.int64)}
        out, extra = restore_checkpoint(str(tmp_path), 7, like)
        assert extra == {"k": 1}
        assert out["b"][1][1] is None and isinstance(out["b"][1], tuple)
        assert out["b"][0].dtype == np.int32
        assert torch.equal(out["a"], tree["a"])
        with pytest.raises(CheckpointError, match="structure"):
            restore_checkpoint(str(tmp_path), 7, {"a": like["a"]})

    def test_save_copies_cpu_tensors_before_the_writer_runs(self, tmp_path,
                                                            monkeypatch):
        """A CPU tensor's numpy() shares its storage: the manager must copy
        every leaf before its writer starts, or an in-place update made
        after ``save`` returns lands in the checkpoint."""
        gate = __import__("threading").Event()
        real = ckpt_mod.save_checkpoint

        def held(*args, **kwargs):
            gate.wait(timeout=30)
            return real(*args, **kwargs)

        monkeypatch.setattr(ckpt_mod, "save_checkpoint", held)
        mgr = CheckpointManager(str(tmp_path), async_write=True)
        counts = torch.zeros(4, dtype=torch.int32)
        mgr.save(0, {"counts": counts})
        counts += 5  # the next batch, while the write is in flight
        gate.set()
        mgr.wait()
        (leaf,), _ = load_leaves(str(tmp_path), 0)
        assert leaf.tolist() == [0, 0, 0, 0]

    def test_keep_last_k_and_stale_tmp(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
        for step in range(4):
            mgr.save(step, {"x": np.full(2, step)})
        os.makedirs(tmp_path / "step_000000009.tmp")
        assert latest_step(str(tmp_path)) == 3
        assert sorted(os.listdir(tmp_path)) == ["step_000000002",
                                                "step_000000003"]
        step, tree, _ = mgr.restore_latest({"x": np.zeros(2, np.int64)})
        assert step == 3 and tree["x"].tolist() == [3, 3]


class TestAsyncWriteFailure:
    def _tree(self):
        return {"a": np.arange(4), "b": torch.ones((2, 2))}

    def test_async_failure_reraises_on_wait(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(str(tmp_path / "c"), async_write=True)
        mgr.save(0, self._tree())
        mgr.wait()

        def boom(*a, **k):
            raise OSError("disk full (injected)")

        monkeypatch.setattr(ckpt_mod, "save_checkpoint", boom)
        mgr.save(1, self._tree())
        with pytest.raises(CheckpointError, match="disk full"):
            mgr.wait()
        monkeypatch.undo()
        mgr.save(2, self._tree())
        mgr.wait()
        assert latest_step(str(tmp_path / "c")) == 2

    def test_async_failure_reraises_on_next_save(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(str(tmp_path / "c"), async_write=True)

        def boom(*a, **k):
            raise OSError("device offline (injected)")

        monkeypatch.setattr(ckpt_mod, "save_checkpoint", boom)
        mgr.save(0, self._tree())
        with pytest.raises(CheckpointError, match="device offline"):
            mgr.save(1, self._tree())

    def test_sync_failure_raises_immediately(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(str(tmp_path / "c"), async_write=False)

        def boom(*a, **k):
            raise OSError("read-only fs (injected)")

        monkeypatch.setattr(ckpt_mod, "save_checkpoint", boom)
        with pytest.raises(CheckpointError, match="read-only fs"):
            mgr.save(0, self._tree())

    def test_service_surfaces_failed_snapshot(self, tmp_path, monkeypatch):
        g = random_labeled_graph(30, 70, 3, seed=9)
        store = port_store(g, degree_cap=32)
        svc = GraphQueryService(store, GraphServiceConfig(
            max_slots=1, max_query_vertices=8, max_query_labels=8,
            checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_async=True))
        svc.wait_for_checkpoints()

        def boom(*a, **k):
            raise OSError("no space (injected)")

        monkeypatch.setattr(ckpt_mod, "save_checkpoint", boom)
        svc.add_edges([[0, 5]])
        with pytest.raises(CheckpointError, match="no space"):
            svc.wait_for_checkpoints()


# ---------------------------------------------------------------------------
# crash recovery: SIGKILL mid-stream
# ---------------------------------------------------------------------------

# the mutation workload the child and the parent's twin both derive from
# the same seed
_WORKLOAD = '''
import numpy as np
from repro_torch.graphs import random_labeled_graph, random_update_batches


def make_graph():
    return random_labeled_graph(60, 150, 4, n_edge_labels=2, seed=21,
                                device="cpu")


def mutation_calls(g, n_batches=18, batch_edges=6):
    calls = []
    for b in random_update_batches(g, n_batches, batch_edges,
                                   delete_frac=0.4, n_edge_labels=2, seed=5):
        ins = b.insert & b.valid
        dele = ~b.insert & b.valid
        if dele.any():
            calls.append(("remove_edges",
                          np.stack([b.src[dele], b.dst[dele]], 1).tolist(),
                          None))
        if ins.any():
            calls.append(("add_edges",
                          np.stack([b.src[ins], b.dst[ins]], 1).tolist(),
                          b.elabels[ins].tolist()))
    return calls
'''

_CHILD = _WORKLOAD + '''
import sys
from repro_torch.core import IncrementalIndex
from repro_torch.graphs import GraphStore
from repro_torch.serve import GraphQueryService, GraphServiceConfig

ckpt_dir = sys.argv[1]
g = make_graph()
store = GraphStore.from_graph(g, degree_cap=64, device="cpu")
store.attach_index(IncrementalIndex())
svc = GraphQueryService(store, GraphServiceConfig(
    max_slots=2, max_query_vertices=8, max_query_labels=8,
    checkpoint_dir=ckpt_dir, checkpoint_every=1, checkpoint_async=True))
print("READY", flush=True)
for k, (op, edges, labs) in enumerate(mutation_calls(g)):
    if op == "add_edges":
        svc.add_edges(edges, labs)
    else:
        svc.remove_edges(edges)
    print("MUT", k, "epoch", store.epoch, flush=True)
print("DONE", flush=True)
'''


def test_sigkill_mid_stream_restores_committed_epoch(tmp_path):
    ckpt = tmp_path / "ckpt"
    script = tmp_path / "child.py"
    script.write_text(_CHILD)
    proc = subprocess.Popen(
        [sys.executable, str(script), str(ckpt)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "PYTHONPATH": _SRC},
    )
    try:
        seen = -1
        for line in proc.stdout:
            if line.startswith("MUT"):
                seen = int(line.split()[1])
                if seen >= 6:  # mid-stream, writes still in flight
                    break
            if line.startswith("DONE"):
                break
        assert seen >= 6, "child never reached the kill point"
        os.kill(proc.pid, signal.SIGKILL)
    finally:
        proc.stdout.close()
        proc.wait(timeout=60)

    restored = GraphQueryService.restore(str(ckpt), device="cpu")
    e = restored.store.epoch
    assert e >= 1, "no post-mutation snapshot committed before the kill"

    ns: dict = {}
    exec(_WORKLOAD, ns)  # noqa: S102 — the same source the child runs
    g = ns["make_graph"]()
    calls = ns["mutation_calls"](g)
    assert e <= len(calls)
    twin = GraphStore.from_graph(g, degree_cap=64, device="cpu")
    twin.attach_index(IncrementalIndex())
    for op, edges, labs in calls[:e]:
        if op == "add_edges":
            twin.add_edges(edges, labs)
        else:
            twin.remove_edges(edges)
    assert twin.epoch == e
    same_edges(restored.store, twin)
    same_index(restored.store.index, twin.index)  # warm, bit for bit

    eng = SubgraphQueryEngine(twin.snapshot(), device="cpu")
    for seed in range(9, 15):
        q = port(random_walk_query(g, 4, seed=seed))
        want, _ = eng.query(q)
        if want.shape[0] > 0:
            break
    rid = restored.submit(q)
    done = {r: emb for r, emb, _ in restored.run_to_completion()}
    assert eset(done[rid]) == eset(want)
    restored.shutdown()


# ---------------------------------------------------------------------------
# roundtrips, against the reference
# ---------------------------------------------------------------------------


def test_roundtrip_after_mutations_matches_reference(tmp_path, monkeypatch):
    g = random_labeled_graph(50, 130, 4, n_edge_labels=2, seed=3)
    ref = RefStore.from_graph(g, degree_cap=64)
    ref.attach_index(RefIndex())
    got = port_store(g, degree_cap=64)
    first = [int(np.asarray(g.src)[0]), int(np.asarray(g.dst)[0])]
    for store in (ref, got):
        store.add_edges([[0, 17], [3, 44]])
        store.remove_edges([first])
    w_step = RefCheckpointer(str(tmp_path / "r"), async_write=False).save(ref)
    ck = ServiceCheckpointer(str(tmp_path / "p"), async_write=False)
    assert ck.save(got) == w_step == got.epoch
    w_manifest = json.loads((tmp_path / "r" / f"step_{w_step:09d}" /
                             "manifest.json").read_text())
    manifest = json.loads((tmp_path / "p" / f"step_{w_step:09d}" /
                           "manifest.json").read_text())
    assert manifest["extra"]["store"] == w_manifest["extra"]["store"]
    # the same leaves, but the exact digest: int64 cni for uint64 cni_u64
    swap = {"index/cni_u64": "index/cni"}
    assert manifest["extra"]["leaf_keys"] == sorted(
        swap.get(k, k) for k in w_manifest["extra"]["leaf_keys"])

    encodes = []
    monkeypatch.setattr(IncrementalIndex, "rebuild",
                        lambda self, store: encodes.append(store))
    step, restored = ck.restore_latest(device="cpu")
    assert step == got.epoch and restored.epoch == got.epoch
    assert not encodes  # warm: no rebuild, hence no cni_encode
    same_edges(restored, got)
    same_index(restored.index, got.index)
    q = random_walk_query(g, 4, seed=4)
    want, _ = SubgraphQueryEngine(got.snapshot(), device="cpu").query(port(q))
    emb, _ = SubgraphQueryEngine(restored.snapshot(), device="cpu").query(
        port(q))
    np.testing.assert_array_equal(emb, want)


def test_reference_snapshot_restores_to_a_scratch_equal_index(tmp_path):
    """State carried across: a directory the reference's service wrote
    restores in the port to the index a scratch rebuild gives."""
    g = random_labeled_graph(80, 260, 5, n_edge_labels=2, seed=12)
    store = RefStore.from_graph(g, degree_cap=32)
    store.attach_index(RefIndex())
    svc = RefService(store, RefConfig(
        max_slots=1, max_query_vertices=8, max_query_labels=8,
        checkpoint_dir=str(tmp_path), checkpoint_async=False))
    svc.add_edges([[0, 41], [5, 77]])
    svc.remove_edges([[int(np.asarray(g.src)[3]), int(np.asarray(g.dst)[3])]])
    svc.shutdown()

    restored = GraphQueryService.restore(str(tmp_path), device="cpu")
    st = restored.store
    assert st.epoch == store.epoch == 2
    for x, y in zip(st.alive_edges(), store.alive_edges()):
        np.testing.assert_array_equal(x, y)
    fresh = IncrementalIndex(d_max=st.index.d_max)
    fresh.rebuild(st)
    for name in ("counts", "deg", "cni"):
        assert torch.equal(getattr(st.index, name), getattr(fresh, name)), name
    # the log digests are the reference's float32 sums, within its own
    # tolerance of the port's (tests/test_incremental.py)
    torch.testing.assert_close(st.index.cni_log, fresh.cni_log, rtol=0,
                               atol=1e-5)
    ref_stats = store.index.graph_stats
    assert st.index.graph_stats.bucket == ref_stats.bucket
    np.testing.assert_array_equal(st.index.graph_stats.pair_counts,
                                  ref_stats.pair_counts)
    q = random_walk_query(g, 4, seed=6)
    svc2 = RefService(store, RefConfig(max_slots=1, max_query_vertices=8,
                                       max_query_labels=8))
    svc2.submit(q)
    (_, want, _), = svc2.run_to_completion()
    restored.submit(port(q))
    (_, emb, _), = restored.run_to_completion()
    np.testing.assert_array_equal(emb, np.asarray(want))
    restored.shutdown()


def test_restored_service_answers_as_the_original(tmp_path):
    g = random_labeled_graph(80, 260, 5, n_edge_labels=2, seed=14)
    store = port_store(g, degree_cap=32)
    cfg = GraphServiceConfig(max_slots=2, max_query_vertices=8,
                             max_query_labels=8, plan_queries=True,
                             enumerator="device",
                             checkpoint_dir=str(tmp_path))
    svc = GraphQueryService(store, cfg)
    svc.add_edges([[0, 41], [5, 77]])
    queries = [port(random_walk_query(g, 4 + i % 2, seed=20 + i))
               for i in range(4)]
    for q in queries:
        svc.submit(q)
    want = [emb for _, emb, _ in svc.run_to_completion()]
    svc.shutdown()
    restored = GraphQueryService.restore(str(tmp_path), cfg, device="cpu")
    assert restored.store.epoch == store.epoch
    same_index(restored.store.index, store.index)
    for q in queries:
        restored.submit(q)
    got = [emb for _, emb, _ in restored.run_to_completion()]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert restored.planner.stats.bucket == svc.planner.stats.bucket


def test_stats_checkpoint_roundtrip():
    g = port(random_labeled_graph(40, 100, 4, seed=2))
    st = GraphStats.from_graph(g, version=3)
    st.bucket, st._drift = 2, 17
    leaves, meta = st.checkpoint_state()
    back = GraphStats.from_checkpoint_state(leaves, meta)
    assert (back.bucket, back._drift, back.version) == (2, 17, 3)
    np.testing.assert_array_equal(back.pair_counts, st.pair_counts)
    with pytest.raises(CheckpointError, match="pair_counts"):
        GraphStats.from_checkpoint_state(
            {**leaves, "pair_counts": np.zeros((1, 1))}, meta)


# ---------------------------------------------------------------------------
# fail-closed reads: truncated / partial / torn snapshots
# ---------------------------------------------------------------------------


def _committed_service_dir(tmp_path):
    g = random_labeled_graph(40, 90, 3, seed=6)
    store = port_store(g, degree_cap=32)
    svc = GraphQueryService(store, GraphServiceConfig(
        max_slots=1, max_query_vertices=8, max_query_labels=8,
        checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_async=False))
    svc.add_edges([[0, 11]])
    svc.shutdown()
    d = tmp_path / "ckpt"
    steps = sorted(p for p in os.listdir(d) if p.startswith("step_"))
    return d, d / steps[-1]


def _edit_manifest(step_dir, edit):
    mpath = step_dir / "manifest.json"
    m = json.loads(mpath.read_text())
    edit(m["extra"])
    mpath.write_text(json.dumps(m))


class TestFailClosed:
    def test_restore_empty_dir_raises(self, tmp_path):
        with pytest.raises(CheckpointError, match="no committed"):
            GraphQueryService.restore(str(tmp_path / "nothing"), device="cpu")

    def test_truncated_leaf_fails_closed(self, tmp_path):
        d, step_dir = _committed_service_dir(tmp_path)
        leaf = step_dir / "leaf_00000.npy"
        data = leaf.read_bytes()
        leaf.write_bytes(data[: len(data) // 2])
        with pytest.raises(CheckpointError):
            GraphQueryService.restore(str(d), device="cpu")

    def test_missing_leaf_fails_closed(self, tmp_path):
        d, step_dir = _committed_service_dir(tmp_path)
        os.remove(step_dir / "leaf_00003.npy")
        with pytest.raises(CheckpointError, match="missing leaf"):
            GraphQueryService.restore(str(d), device="cpu")

    def test_leaf_keys_manifest_disagreement(self, tmp_path):
        d, step_dir = _committed_service_dir(tmp_path)
        _edit_manifest(step_dir, lambda m: m.__setitem__(
            "leaf_keys", m["leaf_keys"][:-1]))
        with pytest.raises(CheckpointError, match="leaf_keys"):
            GraphQueryService.restore(str(d), device="cpu")

    def test_torn_store_index_pair_fails_closed(self, tmp_path):
        d, step_dir = _committed_service_dir(tmp_path)
        _edit_manifest(step_dir, lambda m: m["index"].__setitem__(
            "epoch", m["index"]["epoch"] + 1))
        with pytest.raises(CheckpointError, match="epoch"):
            GraphQueryService.restore(str(d), device="cpu")

    @pytest.mark.parametrize("field,value,match", [
        ("kind", "bogus", "unknown store kind"),
        ("type", "BogusIndex", "unknown index type"),
    ])
    def test_unknown_kind_or_type_fails_closed(self, tmp_path, field, value,
                                               match):
        d, step_dir = _committed_service_dir(tmp_path)
        part = "store" if field == "kind" else "index"
        _edit_manifest(step_dir, lambda m: m[part].__setitem__(field, value))
        with pytest.raises(CheckpointError, match=match):
            GraphQueryService.restore(str(d), device="cpu")

    def test_tampered_edge_leaves_fail_closed(self):
        g = port(random_labeled_graph(20, 40, 3, seed=8))
        leaves, meta = GraphStore.from_graph(g, device="cpu").checkpoint_state()
        with pytest.raises(CheckpointError, match="missing leaf"):
            GraphStore.from_checkpoint_state({}, meta, device="cpu")
        twice = {**leaves, **{k: np.concatenate([leaves[k], leaves[k][:1]])
                              for k in ("edge_lo", "edge_hi", "edge_lab")}}
        with pytest.raises(CheckpointError, match="repeats"):
            GraphStore.from_checkpoint_state(twice, meta, device="cpu")
        flipped = {**leaves, "edge_lo": leaves["edge_hi"],
                   "edge_hi": leaves["edge_lo"]}
        with pytest.raises(CheckpointError, match="canonical"):
            GraphStore.from_checkpoint_state(flipped, meta, device="cpu")

    def test_warm_attach_validates_epoch(self):
        g = port(random_labeled_graph(30, 60, 3, seed=8))
        store = GraphStore.from_graph(g, degree_cap=32, device="cpu")
        with pytest.raises(ValueError, match="epoch"):
            store.attach_index(IncrementalIndex(), rebuild=False)


@pytest.mark.parametrize("kind,error,match", [
    ("ooc", CheckpointError, "missing leaf"),
    ("sharded", CheckpointError, "n_shards"),
], ids=["ooc", "sharded"])
def test_later_slice_store_kinds_raise(tmp_path, kind, error, match):
    """Both later-slice kinds are ported (the sharded one with ROADMAP
    A11): an in-memory snapshot relabelled ``sharded`` lacks its shard
    count, one relabelled ``ooc`` its overlay leaves, so each fails
    closed."""
    d, step_dir = _committed_service_dir(tmp_path)
    _edit_manifest(step_dir, lambda m: m["store"].__setitem__("kind", kind))
    with pytest.raises(error, match=match):
        ServiceCheckpointer(str(d)).restore_latest(device="cpu")
    with pytest.raises(CheckpointError, match="missing leaf"):
        ShardedGraphStore.from_checkpoint_state({}, {})


def test_warm_restore_launches_no_encode(tmp_path, monkeypatch):
    d, _ = _committed_service_dir(tmp_path)
    calls = []
    real = encode_ref.cni_encode_ref
    monkeypatch.setattr(encode_ref, "cni_encode_ref",
                        lambda *a: calls.append(a) or real(*a))
    restored = GraphQueryService.restore(str(d), device="cpu")
    assert restored.store.index is not None and not calls
