"""CPU tests of the readers of the program's spans inside a query
(``cnib/descent.py`` and the metrics it serves), on synthetic span lists:
descent through ``service.finalize`` -> ``query.enumerate``, queries
outside the window, and None where the program records no such span."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

from cnib import descent, main, spec  # noqa: E402

from repro_torch.obsv import Span  # noqa: E402

NEW = ("join_build_ms.per_query", "join_stage_ms.per_query",
       "join_h2d_mib.per_query", "induce_ms.per_query",
       "filtered_vertices.per_query", "readback_ms.per_query",
       "ords_ms.per_query", "gc_ms.per_query")
READ = {name: spec.load_module("metrics", name).read for name in NEW}
T_OPEN, T_CLOSE = 1.0, 2.0  # the window, seconds


class Trees:
    """Builds finished spans; times in ms from the window's opening."""

    def __init__(self):
        self.spans, self.next_id = [], 1

    def add(self, name, parent, t0_ms, t1_ms, **attrs):
        s = Span(name, 1, self.next_id,
                 None if parent is None else parent.span_id,
                 round(T_OPEN * 1e9 + t0_ms * 1e6), attrs)
        s.end_ns = round(T_OPEN * 1e9 + t1_ms * 1e6)
        self.next_id += 1
        self.spans.append(s)
        return s

    def query(self, rid, at, *, build, stages, compact, n_alive, readback,
              ords, mib=(1, 2)):
        """One request's tree starting at ``at`` ms: admit > ords, then
        readback, finalize > compact, enumerate > build, stages, count."""
        req = self.add("service.request", None, at, at + 50, rid=rid)
        admit = self.add("service.admit", req, at, at + 1)
        self.add("service.ords", admit, at, at + ords)
        self.add("service.readback", req, at + 2, at + 2 + readback, rid=rid)
        fin = self.add("service.finalize", req, at + 3, at + 40, rid=rid,
                       rounds=2)
        self.add("query.compact", fin, at + 3, at + 3 + compact,
                 n_alive=n_alive)
        enum = self.add("query.enumerate", fin, at + 5, at + 39)
        self.add("enum.build", enum, at + 5, at + 5 + build,
                 h2d_bytes=mib[0] * 2**20)
        t = at + 5 + build
        for k, dur in enumerate(stages):
            st = self.add("enum.stage", enum, t, t + dur,
                          h2d_bytes=(mib[1] * 2**20 if k == 0 else 0))
            if k == 0:  # a collection inside a stage nests under it
                self.add("runtime.gc", st, t, t + 0.5)
            self.add("enum.count", enum, t + dur, t + dur + 0.1, level=k + 1)
            t += dur + 0.2
        return fin


def completed(*rids):
    return [main.Completed(rid, 0, T_OPEN, T_CLOSE - 0.01, 3,
                           np.zeros((1, 3), np.int64)) for rid in rids]


def readings(spans, done):
    return main.Readings(1.0, T_OPEN, T_CLOSE, done, spans, None, {}, None)


@pytest.fixture
def two_queries():
    tr = Trees()
    tr.query(1, 10, build=1.0, stages=(2.0, 1.0), compact=0.5, n_alive=800,
             readback=0.1, ords=0.4)
    tr.query(2, 100, build=3.0, stages=(4.0, 2.0, 1.0), compact=1.5,
             n_alive=1200, readback=0.3, ords=0.6, mib=(3, 4))
    # finalized in the trace, but returned after the window: not counted
    tr.query(3, 900, build=50.0, stages=(50.0,), compact=30.0, n_alive=9999,
             readback=9.0, ords=0.8, mib=(90, 90))
    # collections: one inside, one across the opening, one after the close
    tr.add("runtime.gc", None, 500, 502)
    tr.add("runtime.gc", None, -3, 1)
    tr.add("runtime.gc", None, 1500, 1510)
    return tr.spans


def test_readers_descend_through_finalize_and_enumerate(two_queries):
    r = readings(two_queries, completed(1, 2))
    got = {name: read(r) for name, read in READ.items()}
    assert got["join_build_ms.per_query"] == pytest.approx(2.0)
    assert got["join_stage_ms.per_query"] == pytest.approx((3.0 + 7.0) / 2)
    assert got["join_h2d_mib.per_query"] == pytest.approx((3 + 7) / 2)
    assert got["induce_ms.per_query"] == pytest.approx(1.0)
    assert got["filtered_vertices.per_query"] == pytest.approx(1000)
    assert got["readback_ms.per_query"] == pytest.approx(0.2)
    # every admission in the trace counts, as admit_ms.per_query's do
    assert got["ords_ms.per_query"] == pytest.approx(0.6)
    # inside the window: 3 x 0.5 under the stages, 2 at 500 ms, 1 of the
    # one across the opening; over the 2 completed queries
    assert got["gc_ms.per_query"] == pytest.approx((1.5 + 2 + 1) / 2)


def test_a_query_outside_the_window_is_not_read(two_queries):
    only_first = readings(two_queries, completed(1))
    assert READ["join_build_ms.per_query"](only_first) == pytest.approx(1.0)
    assert READ["induce_ms.per_query"](only_first) == pytest.approx(0.5)
    assert READ["readback_ms.per_query"](only_first) == pytest.approx(0.1)
    assert READ["filtered_vertices.per_query"](only_first) == 800


def test_a_query_without_a_join_counts_zero(two_queries):
    tr = Trees()
    req = tr.add("service.request", None, 300, 301, rid=4)
    tr.add("service.finalize", req, 300, 300.5, rid=4, rounds=1)
    r = readings(two_queries + tr.spans, completed(1, 2, 4))
    assert READ["join_build_ms.per_query"](r) == pytest.approx(4.0 / 3)
    assert READ["filtered_vertices.per_query"](r) == pytest.approx(2000 / 3)


def test_every_reader_returns_none_without_its_spans():
    # what a program without these spans records: the request, finalize
    # and enumerate spans only
    tr = Trees()
    req = tr.add("service.request", None, 10, 60, rid=1)
    admit = tr.add("service.admit", req, 10, 11)
    fin = tr.add("service.finalize", req, 13, 50, rid=1, rounds=2)
    enum = tr.add("query.enumerate", fin, 15, 49)
    tr.add("enum.count", enum, 16, 17, level=1, rows=4)
    del admit
    for spans in (tr.spans, []):
        r = readings(spans, completed(1))
        assert {name: read(r) for name, read in READ.items()} == dict.fromkeys(NEW)


def test_under_stops_at_the_nearest_root():
    tr = Trees()
    a = tr.add("service.finalize", None, 0, 10, rid=1)
    b = tr.add("query.enumerate", a, 1, 9)
    c = tr.add("enum.build", b, 1, 2)
    stray = tr.add("enum.build", None, 3, 4)
    found = descent.under(tr.spans, [a], {"enum.build"})
    assert found == {a.span_id: [c]} and stray not in found[a.span_id]


def test_benchmark_lists_the_new_metrics_for_the_cell():
    bench = spec.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["moves"] == "queries_per_s"
        assert m["workloads"] == ["human-gnm.sparse10-14.c32"]
        assert m["source"] in ("program_span", "program_counter")


def test_a_traced_cpu_run_reports_every_new_metric():
    sys.path.insert(0, str(BENCH / "tests"))
    import test_cnibench_harness as harness

    cell = harness.tiny_cell(harness.CELLS[0])
    res = main.run_cell(cell, 2**31 + 77, 1.0, True, "cpu", log=harness.quiet)
    assert res["correct"], res
    missing = [name for name in NEW if name not in res["metrics"]]
    assert not missing, res["metrics"]
    assert res["metrics"]["join_h2d_mib.per_query"]["value"] > 0
