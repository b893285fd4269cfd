"""CPU tests of ``join_copies.per_query``, the reader of the ``copies``
counters on the join's spans, on synthetic span trees built with
``test_cnibench_tracing``'s helpers: it sums them per completed query and
reads None where no span carries the counter, as a program that does not
count copies records its spans."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))

from test_cnibench_tracing import Trees, completed, readings  # noqa: E402

from cnib import spec  # noqa: E402

COPIES = spec.load_module("metrics", "join_copies.per_query").read


def _copies_tree(tr, rid, at, levels):
    """One query's join spans as the port records them: one upload in the
    build, one read a level's count, one at the assembly."""
    req = tr.add("service.request", None, at, at + 50, rid=rid)
    fin = tr.add("service.finalize", req, at + 3, at + 40, rid=rid, rounds=2)
    enum = tr.add("query.enumerate", fin, at + 5, at + 39)
    tr.add("enum.build", enum, at + 5, at + 6, h2d_bytes=4096, copies=1)
    t = at + 6
    for k in range(levels):
        tr.add("enum.stage", enum, t, t + 0.1, copies=0)
        tr.add("enum.count", enum, t + 0.1, t + 0.2, level=k + 1, copies=1)
        tr.add("enum.scan", enum, t + 0.2, t + 0.3, level=k + 1, copies=0)
        tr.add("enum.emit", enum, t + 0.3, t + 0.4, level=k + 1, copies=0)
        t += 0.5
    tr.add("enum.assemble", enum, t, t + 0.1, copies=1)


def test_join_copies_sums_the_join_spans_and_reads_none_without_them():
    tr = Trees()
    _copies_tree(tr, 1, 10, 2)
    _copies_tree(tr, 2, 100, 4)
    _copies_tree(tr, 3, 900, 9)  # returned after the window: not read
    r = readings(tr.spans, completed(1, 2))
    assert COPIES(r) == pytest.approx(((1 + 2 + 1) + (1 + 4 + 1)) / 2)
    # the same spans without the attribute, as a program that does not
    # count copies records them: no reading, not 0
    for s in tr.spans:
        s.attrs.pop("copies", None)
    assert COPIES(r) is None
    assert COPIES(readings([], completed(1))) is None


def test_benchmark_lists_join_copies_for_the_cell():
    m, = (m for m in spec.load_benchmark()["per_layer"]
          if m["name"] == "join_copies.per_query")
    assert (m["layer"], m["moves"], m["source"]) == (
        "join", "queries_per_s", "program_counter")
    assert m["workloads"] == ["human-gnm.sparse10-14.c32"]
