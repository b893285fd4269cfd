"""The port's observability (``repro_torch.obsv``) against the reference's,
on the patterns of ``tests/test_obsv.py``: the tracer's span trees, the
metrics registry and its Prometheus text (the same operations give the
same text in both packages), the ``ServiceReport`` schema, and the graph
service's traces and metrics on an in-memory ``GraphStore`` (the
reference's out-of-core version of those tests waits for ROADMAP A10).
"""

import gc
import json
import time

import numpy as np
import pytest
import torch

from repro import obsv as ref_obsv
from repro.core.incremental import IncrementalIndex as RefIndex
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.store import GraphStore as RefStore
from repro.serve import GraphQueryService as RefService
from repro.serve import GraphServiceConfig as RefConfig
from repro_torch import obsv
from repro_torch.core import IncrementalIndex, device_join_search
from repro_torch.core import distributed as dist
from repro_torch.graphs import GraphStore, graph_from_numpy
from repro_torch.serve import GraphQueryService, GraphServiceConfig


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


class TestTracer:
    def test_nesting_and_trace_ids(self):
        tr = obsv.Tracer()
        with tr.span("a") as a:
            with tr.span("b") as b:
                assert b.parent_id == a.span_id
                assert b.trace_id == a.trace_id
        with tr.span("c") as c:
            assert c.parent_id is None
            assert c.trace_id != a.trace_id
        assert not tr.open_spans
        assert [s.name for s in tr.roots()] == ["a", "c"]
        assert tr.children_of(a) == [b]
        assert all(s.closed and s.duration_ns >= 0 for s in tr.spans)

    def test_detached_root_spans_many_scopes(self):
        tr = obsv.Tracer()
        root = tr.start_span("request", detached=True, rid=7)
        assert not tr.open_spans
        with tr.activate(root):
            with tr.span("tick1") as t1:
                pass
        with tr.activate(root):
            with tr.span("tick2") as t2:
                pass
        tr.end_span(root)
        assert t1.parent_id == t2.parent_id == root.span_id
        assert {s.trace_id for s in tr.spans} == {root.trace_id}

    def test_span_at_retroactive(self):
        tr = obsv.Tracer()
        t0 = time.perf_counter()
        with tr.span("parent") as p:
            s = tr.span_at("queued", t0, t0 + 0.25, rid=1)
        assert s.parent_id == p.span_id and s.closed
        assert abs(s.duration_ns - 0.25e9) < 1e4
        detached = tr.start_span("root", detached=True)
        child = tr.span_at("late", t0, t0 + 0.1, parent=detached)
        assert child.parent_id == detached.span_id

    def test_out_of_order_end_tolerated(self):
        tr = obsv.Tracer()
        a = tr.start_span("a")
        b = tr.start_span("b")
        tr.end_span(a)
        tr.end_span(b)
        assert not tr.open_spans
        with pytest.raises(ValueError, match="already ended"):
            tr.end_span(a)

    def test_chrome_trace_export(self, tmp_path):
        tr = obsv.Tracer()
        with tr.span("q", n=3):
            with tr.span("q.inner", arr=np.arange(2), t=torch.ones(1)):
                pass
        events = json.loads(json.dumps(tr.to_chrome_trace()))["traceEvents"]
        assert len(events) == 2 and all(e["ph"] == "X" for e in events)
        assert events == sorted(events, key=lambda e: e["ts"])
        by_name = {e["name"]: e for e in events}
        assert by_name["q"]["args"]["n"] == 3
        assert isinstance(by_name["q.inner"]["args"]["arr"], str)
        assert by_name["q.inner"]["pid"] == by_name["q"]["pid"]
        assert by_name["q.inner"]["cat"] == "q"
        path = tmp_path / "trace.json"
        tr.write_chrome_trace(str(path))
        assert json.loads(path.read_text())["traceEvents"]

    def test_disabled_module_helpers_are_noops(self):
        assert not obsv.enabled()
        assert obsv.span("anything", k=1) is obsv.NOOP_SPAN
        assert obsv.span_at("x", 0.0, 1.0) is None
        assert obsv.start_detached("x") is None
        with obsv.activate(None) as s:
            assert s is None
        obsv.end(None)

    def test_tracing_scope_installs_and_restores(self):
        assert obsv.get_tracer() is None
        with obsv.tracing() as tr:
            assert obsv.get_tracer() is tr
            with obsv.span("inside"):
                pass
            with obsv.tracing() as inner:
                assert obsv.get_tracer() is inner
            assert obsv.get_tracer() is tr
        assert obsv.get_tracer() is None
        assert tr.names() == {"inside"}


# ---------------------------------------------------------------------------
# metrics: the same operations give the same text in both packages
# ---------------------------------------------------------------------------


def _fill(pkg):
    reg = pkg.MetricsRegistry()
    c = reg.counter("repro_c_total", 'escaping "quotes" and \\ ok')
    c.inc()
    c.inc(2, path="a\\b", msg='say "hi"')
    c.inc(4, status="ok")
    reg.gauge("repro_g", "a gauge").set(-1.5)
    reg.gauge("repro_g", "a gauge").inc(0.25, shard="1")
    h = reg.histogram("repro_h_seconds", "hist", start=1e-3, factor=10.0,
                      count=3)
    for v in (5e-4, 5e-3, 5e-2, 5.0, 0.02):
        h.observe(v, stage="x")
    h.observe(123.0)
    reg.histogram("repro_empty_seconds", "never observed")
    return reg


class TestMetrics:
    def test_same_operations_same_exposition(self):
        got, want = _fill(obsv), _fill(ref_obsv)
        assert got.render_prometheus() == want.render_prometheus()
        assert got.snapshot() == want.snapshot()
        assert obsv.parse_prometheus(got.render_prometheus()) == \
            ref_obsv.parse_prometheus(want.render_prometheus())

    def test_counter_and_labels(self):
        reg = obsv.MetricsRegistry()
        c = reg.counter("repro_test_total", "help text")
        c.inc()
        c.inc(4, status="ok")
        snap = reg.snapshot()["repro_test_total"]
        assert snap["series"][()] == 1
        assert snap["series"][(("status", "ok"),)] == 4
        with pytest.raises(ValueError):
            c.inc(-1)
        assert reg.counter("repro_test_total", "help text") is c
        with pytest.raises(ValueError):
            reg.gauge("repro_test_total", "different kind")
        with pytest.raises(ValueError, match="invalid metric name"):
            reg.counter("0bad name")

    def test_histogram_bucketing(self):
        h = obsv.MetricsRegistry().histogram(
            "repro_lat_seconds", "latency", start=1e-3, factor=10.0, count=3)
        for v in (5e-4, 5e-3, 5e-2, 5.0):
            h.observe(v)
        snap = h.snapshot()[()]
        assert snap["cumulative"] == [1, 2, 3, 4]
        assert snap["count"] == 4 == h.count()
        assert snap["sum"] == pytest.approx(5e-4 + 5e-3 + 5e-2 + 5.0)

    @pytest.mark.parametrize("bad", [
        "no help or type\nrepro_x 1\n",
        "# HELP repro_x h\n# TYPE repro_x counter\nrepro_x notanumber\n",
        ("# HELP repro_h h\n# TYPE repro_h histogram\n"
         'repro_h_bucket{le="1.0"} 1\nrepro_h_bucket{le="+Inf"} 1\n'
         "repro_h_sum 1.0\nrepro_h_count 2\n"),
        ("# HELP repro_h h\n# TYPE repro_h histogram\n"
         'repro_h_bucket{le="1.0"} 3\nrepro_h_bucket{le="2.0"} 2\n'
         'repro_h_bucket{le="+Inf"} 3\n'
         "repro_h_sum 1.0\nrepro_h_count 3\n"),
    ])
    def test_parser_rejects_malformed_exposition(self, bad):
        with pytest.raises(ValueError):
            obsv.parse_prometheus(bad)
        with pytest.raises(ValueError):
            ref_obsv.parse_prometheus(bad)


# ---------------------------------------------------------------------------
# reports
# ---------------------------------------------------------------------------


class TestServiceReport:
    def test_scalars_normalized_and_keys_match_reference(self):
        kw = dict(slot=np.int32(2), epoch=torch.tensor(0),
                  queue_seconds=np.float64(0.5), trace_id=np.int64(3))
        rep = obsv.ServiceReport(**kw).validate()
        assert type(rep["slot"]) is int and type(rep["epoch"]) is int
        assert json.loads(json.dumps(rep.to_dict()))["trace_id"] == 3
        want = ref_obsv.ServiceReport(slot=2, epoch=0, queue_seconds=0.5,
                                      trace_id=3)
        assert list(rep) == list(want.keys())
        assert rep.to_dict() == want.to_dict()

    def test_validate_rejects_wrong_types(self):
        with pytest.raises(ValueError, match="trace_id"):
            obsv.ServiceReport(slot=0, epoch=0, queue_seconds=0.0,
                               trace_id="x").validate()
        with pytest.raises(ValueError, match="unknown"):
            obsv.ServiceReport.from_dict({"slot": 0, "epoch": 0,
                                          "queue_seconds": 0.0, "bogus": 1})

    def test_validate_extras_flags_untyped_reports(self):
        obsv.validate_extras({"enum": obsv.EnumReport.empty(), "shards": 2})
        with pytest.raises(ValueError, match="service"):
            obsv.validate_extras({"service": {"slot": 0}})


# ---------------------------------------------------------------------------
# the graph service: one trace per request, metrics, tracing observational
# ---------------------------------------------------------------------------


def _twin_service(g, **cfg):
    ref = RefStore.from_graph(g, degree_cap=32)
    ref.attach_index(RefIndex())
    got = GraphStore.from_graph(port(g), degree_cap=32, device="cpu")
    got.attach_index(IncrementalIndex())
    kw = dict(enumerator="device", plan_queries=True)
    kw.update(cfg)
    return RefService(ref, RefConfig(**kw)), GraphQueryService(
        got, GraphServiceConfig(**kw))


def test_service_single_trace_and_metrics():
    g = random_labeled_graph(150, 500, 4, seed=7)
    q = random_walk_query(g, 4, seed=8)
    ref, svc = _twin_service(g)
    traces = {}
    for name, s, query in (("ref", ref, q), ("port", svc, port(q))):
        with (ref_obsv if name == "ref" else obsv).tracing() as tr:
            rid = s.submit(query)
            (rid2, emb, stats), = s.run_to_completion()
        assert rid2 == rid and not tr.open_spans
        traces[name] = (tr, stats, emb)
    tr, stats, emb = traces["port"]
    rep = stats.extras["service"]
    assert isinstance(rep, obsv.ServiceReport)
    assert rep["queue_seconds"] >= 0 and rep["rounds"] >= 1
    obsv.validate_extras(stats.extras)
    roots = [s for s in tr.roots() if s.name == "service.request"]
    assert len(roots) == 1 and roots[0].trace_id == rep["trace_id"]
    in_trace = {s.name for s in tr.spans if s.trace_id == roots[0].trace_id}
    assert {"service.request", "service.queue_wait", "service.admit",
            "service.epoch_pin", "service.filter_round", "service.finalize",
            "query.plan", "query.enumerate", "enum.count",
            "enum.emit"} <= in_trace
    # the reference's trace of the same request has every span name of
    # the port's but the port's own finer spans (and a collection's, when
    # the collector ran inside the scope)
    ref_tr = traces["ref"][0]
    assert ref_tr.names() <= tr.names()
    assert tr.names() - ref_tr.names() == PORT_SPANS | (
        {"runtime.gc"} & tr.names())
    events = json.loads(json.dumps(tr.to_chrome_trace()))["traceEvents"]
    assert events and all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)

    snap = svc.metrics_snapshot()
    assert snap["repro_service_requests_total"]["series"][
        (("status", "completed"),)] == 1
    assert snap["repro_service_embeddings_total"]["series"][()] == len(emb)
    fams = obsv.parse_prometheus(svc.metrics_text())
    assert set(fams) == set(ref_obsv.parse_prometheus(ref.metrics_text()))
    assert fams["repro_service_queue_wait_seconds"]["type"] == "histogram"
    assert fams["repro_service_stage_seconds"]["type"] == "histogram"
    assert fams["repro_process_peak_rss_bytes"]["type"] == "gauge"
    assert not svc.shutdown()[1]


def test_service_untraced_results_identical():
    """Tracing is observational: the same rows with and without it."""
    g = random_labeled_graph(150, 500, 4, seed=7)
    qs = [port(random_walk_query(g, 4, seed=8 + i)) for i in range(3)]

    def run():
        _, svc = _twin_service(g, max_slots=2)
        for q in qs:
            svc.submit(q)
        return [emb for _, emb, _ in svc.run_to_completion()]

    plain = run()
    with obsv.tracing() as tr:
        traced = run()
    assert "service.request" in tr.names()
    for a, b in zip(plain, traced):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the port's own spans: the join's stages, compaction, read-back, the host
# ords, the collector
# ---------------------------------------------------------------------------

# span names the port opens that the reference's taxonomy lacks
PORT_SPANS = {"enum.build", "enum.stage", "enum.assemble", "query.compact",
              "service.readback", "service.ords"}


def _one_traced_request(g, q):
    _, svc = _twin_service(g)
    with obsv.tracing() as tr:
        rid = svc.submit(port(q))
        (rid2, emb, stats), = svc.run_to_completion()
    assert rid2 == rid
    svc.shutdown()
    return tr, rid, emb, stats


def test_service_trace_holds_the_port_spans_under_their_parents():
    g = random_labeled_graph(150, 500, 4, seed=7)
    q = random_walk_query(g, 5, seed=9)
    tr, rid, emb, stats = _one_traced_request(g, q)
    assert not tr.open_spans and all(s.closed for s in tr.spans)
    by_id = {s.span_id: s for s in tr.spans}

    def parent(s):
        return by_id[s.parent_id].name

    def only(name):
        found = [s for s in tr.spans if s.name == name]
        assert len(found) == 1, (name, found)
        return found[0]

    readback = only("service.readback")
    assert parent(readback) == "service.request"
    assert readback.attrs["rid"] == rid
    assert parent(only("service.ords")) == "service.admit"
    compact = only("query.compact")
    assert parent(compact) == "service.finalize"
    assert compact.attrs["n_alive"] == stats.vertices_after > 0
    build, assemble = only("enum.build"), only("enum.assemble")
    stages = sorted((s for s in tr.spans if s.name == "enum.stage"),
                    key=lambda s: s.start_ns)
    counts = sorted((s for s in tr.spans if s.name == "enum.count"),
                    key=lambda s: s.start_ns)
    levels = stats.extras["enum"]["levels"]
    assert len(stages) == len(levels) == q.n_vertices - 1 and len(emb) >= 1
    for s in (build, assemble, *stages):
        assert parent(s) == "query.enumerate"
    # build, then each level's stage before its count, then the assembly
    assert build.end_ns <= stages[0].start_ns
    for stage, count in zip(stages, counts):
        assert stage.end_ns <= count.start_ns
    assert counts[-1].end_ns <= assemble.start_ns


def _label_join(seed, n_q):
    g = random_labeled_graph(120, 420, 3, seed=seed)
    q = random_walk_query(g, n_q, seed=seed + 1)
    data, query = port(g), port(q)
    vl, ql = np.asarray(g.vlabels), np.asarray(q.vlabels)
    cand = vl[:, None] == ql[None, :]
    return data, query, cand


@pytest.mark.parametrize("seed", [3, 4])
def test_join_h2d_bytes_are_the_uploaded_tensors(seed):
    data, query, cand = _label_join(seed, 5)
    order = list(range(query.n_vertices))
    with obsv.tracing() as tr:
        emb = device_join_search(data, query, cand, order=order, report={},
                                 device="cpu")
    assert emb.shape[0] >= 1
    src, dst = np.asarray(query.src), np.asarray(query.dst)
    # one int32 buffer: the seeds, the data graph's edge list (src, dst,
    # labels), then each level's candidates and matched neighbours'
    # positions and labels
    want = 4 * int(cand[:, order[0]].sum())
    want += 4 * 3 * int(np.asarray(data.src).size)
    for t in range(1, len(order)):
        j = len({int(w) for v, w in zip(src, dst) if v == order[t] and w < t})
        want += 4 * (int(cand[:, order[t]].sum()) + 2 * j)
    got = sum(s.attrs.get("h2d_bytes", 0) for s in tr.spans
              if s.name in ("enum.build", "enum.stage"))
    assert got == want
    build, = (s for s in tr.spans if s.name == "enum.build")
    assert build.attrs["h2d_bytes"] == want  # all of it in one upload


def test_gc_collections_are_spans_only_while_tracing():
    def port_hooks():
        return [cb for cb in gc.callbacks
                if getattr(cb, "__module__", "").startswith("repro_torch")]

    assert not port_hooks()
    with obsv.tracing() as tr:
        assert port_hooks()
        with obsv.span("outer") as outer:
            gc.collect()
    assert not port_hooks()
    spans = [s for s in tr.spans if s.name == "runtime.gc"]
    assert spans and all(s.closed and s.duration_ns >= 0 for s in spans)
    assert any(s.parent_id == outer.span_id for s in spans)
    gc.collect()  # no tracer: nothing recorded, nothing raised
    assert len([s for s in tr.spans if s.name == "runtime.gc"]) == len(spans)


def test_collections_inside_span_bookkeeping_keep_span_ids_unique():
    """A collection can start inside ``start_span`` (its allocations trigger
    it): the ``runtime.gc`` span it records must not take the id of the
    span being opened."""
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        with obsv.tracing() as tr:
            for i in range(300):
                with obsv.span("outer", i=i, pad=[i]):
                    obsv.span_at("inner", 0.0, 0.0, i=i, pad={"i": i})
    finally:
        gc.set_threshold(*threshold)
    ids = [s.span_id for s in tr.spans]
    assert sum(s.name == "runtime.gc" for s in tr.spans) > 0
    assert len(ids) == len(set(ids))
    by_id = {s.span_id: s for s in tr.spans}
    for s in tr.spans:
        if s.name == "inner":
            assert by_id[s.parent_id].name == "outer"


def test_emit_syncs_only_when_traced(monkeypatch):
    data, query, cand = _label_join(5, 5)
    calls = []
    monkeypatch.setattr(dist, "sync", lambda mesh: calls.append(mesh))
    report: dict = {}
    untraced = device_join_search(data, query, cand, report=report,
                                  device="cpu")
    assert calls == []
    with obsv.tracing() as tr:
        traced = device_join_search(data, query, cand, report={},
                                    device="cpu")
    emitted = [s for s in tr.spans if s.name == "enum.emit"]
    assert len(calls) == len(emitted) == sum(
        1 for lv in report["levels"] if sum(lv["emit_rows"]) > 0) >= 1
    np.testing.assert_array_equal(untraced, traced)


def test_stage_histogram_reads_the_request():
    g = random_labeled_graph(150, 500, 4, seed=7)
    _, svc = _twin_service(g)
    t_submit = time.perf_counter()
    svc.submit(port(random_walk_query(g, 4, seed=8)))
    (_, _, stats), = svc.run_to_completion()
    elapsed = time.perf_counter() - t_submit
    series = svc.metrics_snapshot()["repro_service_stage_seconds"]["series"]
    filt, total = series[(("stage", "filter"),)], series[(("stage", "total"),)]
    assert filt["count"] == total["count"] == 1
    assert 0 < filt["sum"] < total["sum"] <= elapsed
    assert total["sum"] > stats.search_seconds
    svc.shutdown()
