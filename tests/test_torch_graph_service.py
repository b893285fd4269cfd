"""The port's ``GraphQueryService`` and ``ReplicatedGraphService`` against
the reference's, on the patterns of ``tests/test_service_hardening.py``,
``tests/test_batch_engine.py`` (the service half) and
``tests/test_planner.py`` (one plan cache across ticks and epochs).

A twin drives both packages with the same calls on the same graph or
store (seeded request and mutation streams) and compares every outcome:
request ids, embeddings in row order (``max_embeddings`` prefixes too),
rejections, expirations, cancellations, the ``ServiceReport`` of each
result (all fields but the times), and every counter and gauge of
``metrics_snapshot`` (histograms by sample count, since a timing's bucket
is the clock's; the queue-depth histogram in full; the process RSS gauge
left out).  The port runs on the CPU (``device="cpu"``).
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import repro_torch
from repro.core.incremental import IncrementalIndex as RefIndex
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.generators import random_update_batches
from repro.graphs.store import GraphStore as RefStore
from repro.serve import AdmissionRejected as RefRejected
from repro.serve import DrainTimeout as RefDrainTimeout
from repro.serve import GraphQueryService as RefService
from repro.serve import GraphServiceConfig as RefConfig
from repro.serve import ReplicatedGraphService as RefReplicated
from repro_torch.core import IncrementalIndex, SubgraphQueryEngine
from repro_torch.graphs import GraphSnapshot, GraphStore, graph_from_numpy
from repro_torch.serve import (
    AdmissionRejected,
    DrainTimeout,
    GraphQueryService,
    GraphServiceConfig,
    ReplicatedGraphService,
)

_SRC = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def eset(emb):
    emb = np.asarray(emb)
    return set(map(tuple, emb.reshape(emb.shape[0], -1).tolist()))


@pytest.fixture(scope="module")
def graph():
    return random_labeled_graph(60, 150, 4, seed=3)


@pytest.fixture(scope="module")
def queries(graph):
    return [random_walk_query(graph, 4, seed=40 + i) for i in range(8)]


def twin_stores(g, **kwargs):
    ref = RefStore.from_graph(g, **kwargs)
    ref.attach_index(RefIndex())
    got = GraphStore.from_graph(port(g), device="cpu", **kwargs)
    got.attach_index(IncrementalIndex())
    return ref, got


def same_triples(want, got):
    """Finished triples equal: rids in order, embeddings in row order,
    search stats, and the ServiceReport but its queue time."""
    assert [r for r, _, _ in got] == [r for r, _, _ in want]
    for (_, w_emb, w_st), (_, emb, st) in zip(want, got):
        np.testing.assert_array_equal(emb, np.asarray(w_emb))
        for f in ("ilgf_iterations", "vertices_before", "vertices_after",
                  "candidate_pairs", "n_embeddings"):
            assert getattr(st, f) == getattr(w_st, f), f
        rep, w_rep = dict(st.extras["service"]), dict(w_st.extras["service"])
        rep.pop("queue_seconds")
        w_rep.pop("queue_seconds")
        assert rep == w_rep
        assert set(st.extras) == set(w_st.extras)
        if "plan" in w_st.extras:
            assert st.extras["plan"]["order"] == w_st.extras["plan"]["order"]
            assert st.extras["plan"]["source"] == w_st.extras["plan"]["source"]


def same_metrics(want: dict, got: dict):
    assert set(got) == set(want)
    for name, fam in want.items():
        assert got[name]["type"] == fam["type"], name
        assert got[name]["help"] == fam["help"], name
        if name == "repro_process_peak_rss_bytes":
            continue
        if fam["type"] != "histogram" or name.endswith("_depth_ticks"):
            assert got[name]["series"] == fam["series"], name
        else:  # a timing's bucket follows the clock: compare sample counts
            counts = {k: v["count"] for k, v in fam["series"].items()}
            assert {k: v["count"] for k, v in got[name]["series"].items()} \
                == counts, name


class Twin:
    """The reference's and the port's service (or router) fed the same
    calls; every call's outcome is compared."""

    def __init__(self, ref, got):
        self.ref, self.got = ref, got

    @classmethod
    def over(cls, data, *, replicas=None, **cfg):
        """``data``: a reference Graph, or a (reference, port) store pair."""
        kw = dict(max_slots=1, max_query_vertices=8, max_query_labels=8)
        kw.update(cfg)
        if replicas is not None:
            return cls(
                RefReplicated(data[0], RefConfig(**kw), n_replicas=replicas),
                ReplicatedGraphService(data[1], GraphServiceConfig(**kw),
                                       n_replicas=replicas))
        if isinstance(data[0], RefStore):
            return cls(RefService(data[0], RefConfig(**kw)),
                       GraphQueryService(data[1], GraphServiceConfig(**kw)))
        return cls(RefService(data, RefConfig(**kw)),
                   GraphQueryService(port(data), GraphServiceConfig(**kw),
                                     device="cpu"))

    def submit(self, q, *args, **kw):
        """Both admit with the same rid, or both reject alike."""
        try:
            want = self.ref.submit(q, *args, **kw)
        except RefRejected as err:
            with pytest.raises(AdmissionRejected) as got:
                self.got.submit(port(q), *args, **kw)
            assert (got.value.rid, got.value.reason, got.value.tenant) == (
                err.rid, err.reason, err.tenant)
            return None
        assert self.got.submit(port(q), *args, **kw) == want
        return want

    def call(self, name, *args, **kw):
        want = getattr(self.ref, name)(*args, **kw)
        got = getattr(self.got, name)(*args, **kw)
        return want, got

    def tick(self):
        want, got = self.call("tick")
        same_triples(want, got)
        return got

    def run(self, **kw):
        want, got = self.call("run_to_completion", **kw)
        same_triples(want, got)
        return got

    def shutdown(self, **kw):
        (w_fin, w_can), (fin, can) = self.call("shutdown", **kw)
        same_triples(w_fin, fin)
        assert [(c.rid, c.reason) for c in can] == [
            (c.rid, c.reason) for c in w_can]
        return fin, can

    def check_records(self):
        same_metrics(self.ref.metrics_snapshot(), self.got.metrics_snapshot())
        if isinstance(self.got, GraphQueryService):
            assert self.got.rejections == [tuple(r) for r in
                                           self.ref.rejections]
            assert [(c.rid, c.reason) for c in self.got.expired] == [
                (c.rid, c.reason) for c in self.ref.expired]


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_queue_full_rejects_typed(self, graph, queries):
        tw = Twin.over(graph, max_queue_depth=2)
        tw.submit(queries[0])
        tw.submit(queries[1])
        assert tw.submit(queries[2]) is None
        assert tw.got.rejections[-1].reason == "queue_full"
        fam = tw.got.metrics_snapshot()["repro_service_rejected_total"]
        assert fam["series"][(("reason", "queue_full"),)] == 1
        assert len(tw.got.queue) == 2
        tw.run()
        assert tw.submit(queries[2]) is not None
        tw.run()
        tw.check_records()

    def test_tenant_quota_isolates_tenants(self, graph, queries):
        tw = Twin.over(graph, tenant_quota=1)
        tw.submit(queries[0], tenant="a")
        assert tw.submit(queries[1], tenant="a") is None
        assert tw.got.rejections[-1].reason == "tenant_quota"
        tw.submit(queries[1], tenant="b")
        done = tw.run()
        assert {s.extras["service"]["tenant"] for _, _, s in done} == {"a", "b"}
        tw.check_records()

    def test_quota_counts_inflight_requests(self, graph, queries):
        tw = Twin.over(graph, tenant_quota=1, max_slots=2)
        tw.submit(queries[0], tenant="a")
        tw.tick()
        if tw.got.n_active:
            assert tw.submit(queries[1], tenant="a") is None
        tw.run()
        tw.check_records()

    def test_unbounded_when_disabled(self, graph, queries):
        tw = Twin.over(graph, max_queue_depth=None)
        for q in queries:
            tw.submit(q)
        assert len(tw.got.queue) == len(queries)
        tw.run()
        tw.check_records()

    def test_oversize_query_raises(self):
        g = random_labeled_graph(100, 300, 4, seed=1)
        svc = GraphQueryService(port(g), GraphServiceConfig(
            max_slots=2, max_query_vertices=4, max_query_labels=4),
            device="cpu")
        with pytest.raises(ValueError, match="vertices > service cap"):
            svc.submit(port(random_walk_query(g, 8, sparse=True, seed=2)))


# ---------------------------------------------------------------------------
# priority / deadline scheduling
# ---------------------------------------------------------------------------


class TestScheduling:
    def test_priority_order(self, graph, queries):
        tw = Twin.over(graph)
        rlo = tw.submit(queries[0], priority=0)
        rhi = tw.submit(queries[1], priority=5)
        order = [r for r, _, _ in tw.run()]
        assert order.index(rhi) < order.index(rlo)

    def test_deadline_breaks_priority_ties(self, graph, queries):
        tw = Twin.over(graph)
        r_late = tw.submit(queries[0], deadline_seconds=60.0)
        r_soon = tw.submit(queries[1], deadline_seconds=5.0)
        order = [r for r, _, _ in tw.run()]
        assert order.index(r_soon) < order.index(r_late)

    def test_lapsed_deadline_expires_before_admission(self, graph, queries):
        tw = Twin.over(graph)
        rex = tw.submit(queries[0], deadline_seconds=-1.0)
        rok = tw.submit(queries[1])
        assert [r for r, _, _ in tw.run()] == [rok]
        assert [c.rid for c in tw.got.expired] == [rex]
        reqs = tw.got.metrics_snapshot()["repro_service_requests_total"]
        assert reqs["series"][(("status", "expired"),)] == 1
        tw.check_records()

    def test_completed_late_flags_deadline_missed(self, graph, queries):
        tw = Twin.over(graph)
        rid = tw.submit(queries[0], deadline_seconds=30.0)
        tw.tick()
        for svc in (tw.ref, tw.got):  # lapse it mid-flight, in both
            req = next(r for r in svc.active if r is not None and r.rid == rid)
            req.deadline = time.perf_counter() - 1.0
        done = {r: s for r, _, s in tw.run()}
        assert done[rid].extras["service"]["deadline_missed"] is True
        tw.check_records()

    def test_report_carries_admission_fields(self, graph, queries):
        tw = Twin.over(graph)
        tw.submit(queries[0], tenant="t9", priority=3)
        (_, _, stats), = tw.run()
        rep = stats.extras["service"]
        assert (rep["tenant"], rep["priority"], rep["deadline_missed"]) == (
            "t9", 3, False)

    def test_max_embeddings_prefix(self, graph, queries):
        tw = Twin.over(graph, max_slots=2, enumerator="device")
        for q in queries[:4]:
            tw.submit(q, max_embeddings=1)
            tw.submit(q)
        done = tw.run()
        full = {r: e for r, e, _ in done if r % 2 == 0}
        for r, e, _ in done:
            if r % 2 == 1:
                np.testing.assert_array_equal(e, full[r + 1][:1])


# ---------------------------------------------------------------------------
# drain accounting (shutdown + DrainTimeout)
# ---------------------------------------------------------------------------


class TestDrainAccounting:
    def test_exhausted_drain_cancels_inflight(self, graph, queries):
        tw = Twin.over(graph, max_slots=2)
        rids = [tw.submit(q) for q in queries[:4]]
        tw.tick()
        fin, can = tw.shutdown(drain=True, max_ticks=0)
        assert {r for r, _, _ in fin} | {c.rid for c in can} == set(rids)
        assert "shutdown drain exhausted" in {c.reason for c in can}
        assert tw.got.n_active == 0 and not tw.got.queue
        tw.check_records()
        with pytest.raises(RuntimeError, match="shut down"):
            tw.got.submit(port(queries[0]))

    def test_run_to_completion_raises_drain_timeout(self, graph, queries):
        tw = Twin.over(graph)
        rids = [tw.submit(q) for q in queries[:3]]
        with pytest.raises(RefDrainTimeout) as w_exc:
            tw.ref.run_to_completion(max_ticks=1)
        with pytest.raises(DrainTimeout) as exc:
            tw.got.run_to_completion(max_ticks=1)
        same_triples(w_exc.value.finished, exc.value.finished)
        rest = tw.run()
        got = {r for r, _, _ in exc.value.finished} | {r for r, _, _ in rest}
        assert got == set(rids)
        tw.check_records()


# ---------------------------------------------------------------------------
# d_max invariant: a real error, not an assert
# ---------------------------------------------------------------------------


_DEGREE_GUARD = textwrap.dedent("""
    import numpy as np
    from repro_torch.graphs import GraphStore, random_labeled_graph
    from repro_torch.serve import GraphQueryService, GraphServiceConfig

    assert False is True or True  # asserts are stripped under -O
    g = random_labeled_graph(60, 150, 4, seed=3, device="cpu")
    store = GraphStore.from_graph(g, device="cpu")
    svc = GraphQueryService(store, GraphServiceConfig(
        max_slots=1, max_query_vertices=8, max_query_labels=8))
    store.degree_cap = svc.d_max + 64
    hub = int(np.argmax(store.degrees()))
    extra = [v for v in range(store.n_vertices)
             if v != hub and not store.has_edge(hub, v)]
    need = svc.d_max - int(store.degrees()[hub]) + 1
    try:
        svc.add_edges([[hub, v] for v in extra[:need]])
    except RuntimeError as err:
        print("GUARD_HELD" if "static d_max" in str(err)
              else f"WRONG_ERROR {err}")
    else:
        print("GUARD_VANISHED")
""")


class TestDegreeInvariant:
    def test_widened_cap_raises_runtime_error(self, graph):
        _, store = twin_stores(graph)
        svc = GraphQueryService(store, GraphServiceConfig(
            max_slots=1, max_query_vertices=8, max_query_labels=8))
        assert store.degree_cap == svc.d_max  # the service imposes its cap
        with pytest.raises(ValueError, match="degree_cap"):
            hub = int(np.argmax(store.degrees()))
            svc.add_edges([[hub, v] for v in range(store.n_vertices)
                           if v != hub and not store.has_edge(hub, v)])
        store.degree_cap = svc.d_max + 64
        hub = int(np.argmax(store.degrees()))
        extra = [v for v in range(store.n_vertices)
                 if v != hub and not store.has_edge(hub, v)]
        need = svc.d_max - int(store.degrees()[hub]) + 1
        with pytest.raises(RuntimeError, match="static d_max"):
            svc.add_edges([[hub, v] for v in extra[:need]])

    def test_invariant_survives_python_O(self):
        out = subprocess.run(
            [sys.executable, "-O", "-c", _DEGREE_GUARD],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": _SRC},
        )
        assert out.returncode == 0, out.stderr
        assert "GUARD_HELD" in out.stdout, (out.stdout, out.stderr)


# ---------------------------------------------------------------------------
# the graph service on a static graph and on a mutating store
# ---------------------------------------------------------------------------


def test_graph_service_matches_sequential():
    """tests/test_batch_engine.py's service case, against the reference
    service and the port's sequential engine."""
    g = random_labeled_graph(200, 700, 5, n_edge_labels=2, seed=13)
    rng = np.random.default_rng(17)
    queries = [random_walk_query(g, int(rng.integers(4, 8)),
                                 sparse=bool(i % 2), seed=800 + i)
               for i in range(10)]
    tw = Twin.over(g, max_slots=3)
    rids = [tw.submit(q) for q in queries]
    done = {rid: emb for rid, emb, _ in tw.run()}
    assert sorted(done) == sorted(rids)
    seq = SubgraphQueryEngine(port(g), device="cpu")
    for rid, q in zip(rids, queries):
        assert eset(seq.query(port(q))[0]) == eset(done[rid])
    tw.check_records()


@pytest.mark.parametrize("enumerator", ["host", "device"])
def test_store_service_stream_with_mutations(enumerator):
    """A seeded request and mutation stream on an indexed store: two
    tenants, priorities, deadlines, waves between ticks, mutations that
    leave two pinned epochs in one tick; every outcome equal."""
    g = random_labeled_graph(120, 420, 5, n_edge_labels=2, seed=11)
    tw = Twin.over(twin_stores(g, degree_cap=32), max_slots=3,
                   enumerator=enumerator, plan_queries=True,
                   max_queue_depth=6, tenant_quota=5)
    rng = np.random.default_rng(5)
    batches = random_update_batches(g, 4, 10, delete_frac=0.35,
                                    n_edge_labels=2, seed=7)
    rounds = tw.got.metrics.counter("repro_service_rounds_total")

    def rounds_of(tick):
        before = rounds.value()
        tick()
        return rounds.value() - before

    two_epochs = False
    for wave, batch in enumerate(batches):
        for i in range(6):
            q = random_walk_query(g, int(rng.integers(3, 7)),
                                  sparse=bool(i % 2), seed=100 * wave + i)
            tw.submit(q, tenant=f"t{i % 2}", priority=int(i % 3 == 0),
                      deadline_seconds=(30.0 if i % 4 == 1 else None),
                      max_embeddings=(5 if i == 5 else None))
        two_epochs |= rounds_of(tw.tick) > 1
        ins = np.asarray(batch.insert) & np.asarray(batch.valid)
        dele = ~np.asarray(batch.insert) & np.asarray(batch.valid)
        edges = np.stack([np.asarray(batch.src), np.asarray(batch.dst)], 1)
        if dele.any():
            tw.call("remove_edges", edges[dele].tolist())
        if ins.any():
            tw.call("add_edges", edges[ins].tolist(),
                    np.asarray(batch.elabels)[ins].tolist())
        two_epochs |= rounds_of(tw.tick) > 1
    tw.run()
    assert two_epochs  # a tick dispatched two pinned epochs
    assert tw.ref.store.epoch == tw.got.store.epoch
    assert tw.got.rejections  # the waves overran the queue or a quota
    tw.check_records()
    tw.shutdown()


class TestPlanCacheAcrossTicks:
    """tests/test_planner.py's service cases on the port, with the
    reference's cache counters."""

    def test_service_shares_cache_across_ticks_and_slots(self):
        g = random_labeled_graph(200, 700, 6, seed=19)
        stores = twin_stores(g, degree_cap=64)
        on = Twin.over(stores, max_slots=3, plan_queries=True)
        off = GraphQueryService(stores[1], GraphServiceConfig(
            max_slots=3, max_query_vertices=8, max_query_labels=8))
        queries = [random_walk_query(g, 5, seed=50 + i) for i in range(4)]
        rids_on = [on.submit(q) for q in queries for _ in range(3)]
        done_on = {rid: emb for rid, emb, _ in on.run()}
        assert set(done_on) == set(rids_on)
        rids_off = [off.submit(port(q)) for q in queries]
        done_off = {rid: emb for rid, emb, _ in off.run_to_completion()}
        for i in range(len(queries)):
            for k in range(3):
                assert eset(done_on[rids_on[3 * i + k]]) == eset(
                    done_off[rids_off[i]])
        cache, ref_cache = on.got.planner.cache, on.ref.planner.cache
        assert (cache.hits, cache.misses) == (ref_cache.hits, ref_cache.misses)
        assert cache.misses <= len(queries)
        assert cache.hits >= 2 * len(queries)

    def test_service_planning_survives_mutation_epochs(self):
        g = random_labeled_graph(200, 700, 6, seed=21)
        tw = Twin.over(twin_stores(g, degree_cap=64), max_slots=2,
                       plan_queries=True)
        queries = [random_walk_query(g, 5, seed=60 + i) for i in range(4)]
        rids = [tw.submit(q) for q in queries[:2]]
        done = tw.tick()
        tw.call("add_edges", [[0, 150], [1, 151]])
        rids += [tw.submit(q) for q in queries[2:]]
        done += tw.run()
        assert {rid for rid, _, _ in done} == set(rids)
        store = tw.got.store
        for rid, emb, stats in done:
            if stats.extras["service"]["epoch"] == store.epoch:
                ref, _ = SubgraphQueryEngine(store, device="cpu").query(
                    port(queries[rids.index(rid)]))
                assert eset(emb) == eset(ref)
        cache, ref_cache = tw.got.planner.cache, tw.ref.planner.cache
        assert (cache.hits, cache.misses) == (ref_cache.hits, ref_cache.misses)


# ---------------------------------------------------------------------------
# replica routing
# ---------------------------------------------------------------------------


class TestReplicas:
    def _router(self, graph, n_replicas=3, **kw):
        stores = twin_stores(graph, degree_cap=64)
        kw.setdefault("max_slots", 2)
        return stores[1], Twin.over(stores, replicas=n_replicas, **kw)

    def test_requires_mutable_store(self, graph):
        with pytest.raises(TypeError, match="BaseGraphStore"):
            ReplicatedGraphService(port(graph))

    def test_submit_spreads_load_and_rids_are_global(self, graph, queries):
        store, tw = self._router(graph)
        rids = [tw.submit(q) for q in queries[:6]]
        assert len(set(rids)) == 6
        assert sum(1 for r in tw.got.replicas if r.queue or r.n_active) == 3
        assert {r for r, _, _ in tw.run()} == set(rids)
        tw.shutdown()

    def test_results_match_single_service_with_mutations(self, graph,
                                                         queries):
        store, tw = self._router(graph)
        rids = [tw.submit(q) for q in queries[:6]]
        done = {r: (e, s) for r, e, s in tw.tick()}
        tw.call("add_edges", [[i, (i + 13) % 60] for i in range(0, 30, 3)])
        done.update({r: (e, s) for r, e, s in tw.run()})
        assert sorted(done) == sorted(rids)
        latest = store.snapshot().graph
        for rid, q in zip(rids, queries[:6]):
            emb, st = done[rid]
            if st.extras["service"]["epoch"] == store.epoch:
                single = GraphQueryService(latest, GraphServiceConfig(
                    max_slots=2, max_query_vertices=8, max_query_labels=8),
                    device="cpu")
                single.submit(port(q))
                (_, want, _), = single.run_to_completion()
                assert eset(emb) == eset(want)
        same_metrics(tw.ref.metrics_snapshot()["replica_1"],
                     tw.got.metrics_snapshot()["replica_1"])
        tw.shutdown()

    def test_read_replicas_reject_direct_mutation(self, graph):
        store, tw = self._router(graph)
        with pytest.raises(RuntimeError, match="read replica"):
            tw.got.replicas[1].add_edges([[0, 1]])
        e0 = tw.got.epoch
        tw.call("add_edges", [[0, 7]])
        assert tw.got.epoch == tw.ref.epoch == e0 + 1
        assert all(r.store.epoch == tw.got.epoch for r in tw.got.replicas)
        tw.shutdown()

    def test_inflight_queries_pin_epochs_across_replicas(self, graph,
                                                         queries):
        store, tw = self._router(graph, max_slots=1)
        for q in queries[:3]:
            tw.submit(q)
        tw.tick()
        pinned = store.epoch
        tw.call("add_edges", [[1, 44]])
        assert any(pinned in r._epochs for r in tw.got.replicas) or all(
            r.n_active == 0 for r in tw.got.replicas)
        tw.run()
        for r in tw.got.replicas:
            assert set(r._epochs) <= {store.epoch}
        tw.shutdown()

    def test_shutdown_translates_rids(self, graph, queries):
        store, tw = self._router(graph, n_replicas=2, max_slots=1)
        rids = [tw.submit(q) for q in queries[:4]]
        first = tw.tick()
        fin, can = tw.shutdown(drain=False)
        assert {r for r, _, _ in first + fin} | {c.rid for c in can} == \
            set(rids)

    def test_single_replica_degenerates_to_service(self, graph, queries):
        store, tw = self._router(graph, n_replicas=1)
        rid = tw.submit(queries[0])
        assert {r for r, _, _ in tw.run()} == {rid}
        assert tw.got.writer is tw.got.replicas[0]
        tw.shutdown()

    def test_metrics_keyed_per_replica(self, graph, queries):
        store, tw = self._router(graph, n_replicas=2)
        tw.submit(queries[0])
        tw.run()
        snap, want = tw.got.metrics_snapshot(), tw.ref.metrics_snapshot()
        assert set(snap) == {"replica_0", "replica_1"}
        for key in snap:
            same_metrics(want[key], snap[key])
        tw.shutdown()


# ---------------------------------------------------------------------------
# the port's own rules: device, later slices
# ---------------------------------------------------------------------------


def test_device_default_and_later_slices(monkeypatch, graph, queries):
    """The mesh (ROADMAP A11) raised until that slice; a meshed service
    now answers as the reference's unmeshed one.  The device rules."""
    from repro_torch.core import device_mesh

    g = port(graph)
    tw = Twin(RefService(graph, RefConfig(max_slots=2, max_query_vertices=8,
                                          max_query_labels=8,
                                          enumerator="device")),
              GraphQueryService(g, GraphServiceConfig(
                  max_slots=2, max_query_vertices=8, max_query_labels=8,
                  enumerator="device", mesh=device_mesh(2, devices="cpu")),
                  device="cpu"))
    for q in queries[:4]:
        tw.submit(q)
    tw.run()
    with pytest.raises(TypeError, match="ShardMesh"):
        GraphQueryService(g, GraphServiceConfig(mesh=object()), device="cpu")
    with pytest.raises(ValueError, match="incremental index"):
        GraphQueryService(GraphSnapshot(0, g, None, ooc=object()),
                          device="cpu")
    store = GraphStore.from_graph(g, device="cpu")
    with pytest.raises(ValueError, match="store's device"):
        GraphQueryService(store, device="cuda")
    svc = GraphQueryService(store)  # a store-backed service runs on its own
    assert svc._ords.device.type == "cpu"
    with pytest.raises(RuntimeError, match="immutable Graph"):
        GraphQueryService(g, device="cpu").add_edges([[0, 1]])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphQueryService(g)
