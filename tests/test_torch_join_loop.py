"""The device join's level loop (``core/search.py::_partitioned_join``) on
the CPU, against the reference's joins.

The loop uploads one packed buffer a query, fills the (N, N) edge-label
matrix from the uploaded edge list, reads one total a level and lets the
emit write the next table.  Its rows, their order, its ``max_embeddings``
prefixes and its ``EnumReport`` fields must equal the reference's
``device_join_search`` and ``bfs_join_search`` (one shard) and
``sharded_device_join_search`` (three shards, run once in a subprocess with
three host devices) bit for bit: on a filtered walk query, with the
rebalancer firing, on a level that empties, on a one-vertex query and on a
data graph whose repeated (src, dst) pair carries two labels.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import ilgf
from repro.core.search import bfs_join_search as r_bfs
from repro.core.search import device_join_search as r_device_join
from repro.graphs import Graph as RefGraph
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.csr import build_graph, induced_subgraph
from repro_torch import obsv
from repro_torch.core import (
    device_join_search,
    device_mesh,
    empty_enum_report,
    sharded_device_join_search,
)
from repro_torch.core.search import _dense_edge_labels, _edge_label_matrix
from repro_torch.graphs import graph_from_numpy
from repro_torch.kernels.embed_join import ref

_SRC = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
TIMINGS = ("count_seconds", "scan_seconds", "emit_seconds",
           "rebalance_seconds")
THRESHOLDS = (1.25, 1.05)


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def label_cands(g, q):
    return np.asarray(g.vlabels)[:, None] == np.asarray(q.vlabels)[None, :]


def dup_graph():
    """A data graph whose (0, 1) and (1, 0) pairs each appear twice, with
    label 0 first and label 1 last."""
    g = build_graph(6, [0, 0, 1, 1, 2, 2],
                    [(0, 2), (1, 3), (2, 4), (3, 5), (0, 4), (1, 5)])
    src = np.concatenate([np.asarray(g.src), [0, 1, 0, 1]]).astype(np.int32)
    dst = np.concatenate([np.asarray(g.dst), [1, 0, 1, 0]]).astype(np.int32)
    elab = np.concatenate([np.asarray(g.elabels), [0, 0, 1, 1]])
    return RefGraph(np.asarray(g.vlabels), src, dst, elab.astype(np.int32))


def make_cases():
    """name -> (data graph, query, candidates, order), as numpy-backed
    reference graphs; the reference's subprocess builds them by importing
    this module."""
    g = random_labeled_graph(300, 1000, 5, n_edge_labels=2, seed=11)
    q = random_walk_query(g, 5, sparse=True, seed=13)
    res = ilgf(g, q)
    alive = np.asarray(res.alive)
    sub, _ = induced_subgraph(g, alive)
    small = random_labeled_graph(48, 150, 3, n_edge_labels=2, seed=5)
    labs = np.asarray(small.vlabels)
    # the edge (1, 2) asks for a label no data edge has: level 2 empties
    q_empty = build_graph(4, labs[:4], [(0, 1), (1, 2), (2, 3)], [0, 5, 0])
    q_one = build_graph(1, labs[:1], np.zeros((0, 2), np.int64))
    dup = dup_graph()
    q_dup = build_graph(2, [0, 0], [(0, 1)], [1])
    return {
        "walk": (sub, q, np.asarray(res.candidates)[alive], None),
        "empties": (small, q_empty, label_cands(small, q_empty),
                    [0, 1, 2, 3]),
        "one_vertex": (small, q_one, label_cands(small, q_one), None),
        "dup": (dup, q_dup, label_cands(dup, q_dup), None),
    }


def truncations(total: int) -> list:
    return sorted({1, max(1, total // 2), max(1, total), total + 3})


_REFERENCE_SCRIPT = textwrap.dedent("""
    import json, sys
    import jax, numpy as np
    from repro.core import sharded_device_join_search
    from repro.core.distributed import device_mesh

    assert len(jax.devices()) == 3, jax.devices()
    tests_dir, timings, thresholds = json.loads(sys.argv[1])
    sys.path.insert(0, tests_dir)
    import test_torch_join_loop as cases_module

    out = {}
    mesh = device_mesh(3)
    for name, (g, q, cand, order) in cases_module.make_cases().items():
        for th in thresholds:
            rep = {}
            rows = np.asarray(sharded_device_join_search(
                g, q, cand, mesh=mesh, order=order, report=rep,
                rebalance_threshold=th))
            out[f"{name}/{th}"] = {
                "rows": rows.tolist(),
                "caps": {str(c): np.asarray(sharded_device_join_search(
                    g, q, cand, mesh=mesh, order=order, max_embeddings=c,
                    rebalance_threshold=th)).tolist()
                    for c in cases_module.truncations(rows.shape[0])},
                "report": cases_module._fields(rep),
            }
    print("RESULT " + json.dumps(out))
""")


def _levels(rep) -> list:
    return [[int(lv["level"]), [int(x) for x in lv["emit_rows"]],
             bool(lv["rebalanced"])] for lv in rep["levels"]]


def _fields(rep) -> dict:
    """The report without its timings and its ``scan_path`` (the
    reference's CPU route scans on the host; the port's join always on the
    device), in a form JSON keeps."""
    out = {k: int(v) for k, v in rep.items()
           if k not in TIMINGS and k not in ("levels", "scan_path")}
    out["levels"] = _levels(rep)
    return out


@pytest.fixture(scope="module")
def cases():
    return make_cases()


@pytest.fixture(scope="module")
def sharded_reference():
    """The reference's three-shard join on every case, run once."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=3"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = _SRC
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SCRIPT,
         json.dumps([os.path.dirname(os.path.abspath(__file__)),
                     list(TIMINGS), list(THRESHOLDS)])],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line, = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def one_shard_reference(cases):
    """The reference's one-device join and host join on every case, with
    their truncation prefixes."""
    out = {}
    for name, (g, q, cand, order) in cases.items():
        rep = {}
        rows = np.asarray(r_device_join(g, q, cand, order=order, report=rep,
                                        use_kernel=False))
        caps = truncations(rows.shape[0])
        out[name] = {
            "rows": rows,
            "bfs": np.asarray(r_bfs(g, q, cand, order=order)),
            "caps": {c: np.asarray(r_device_join(
                g, q, cand, order=order, max_embeddings=c,
                use_kernel=False)) for c in caps},
            "report": _fields(rep),
        }
    return out


CASE_NAMES = ["walk", "empties", "one_vertex", "dup"]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_one_shard_equals_reference(cases, one_shard_reference, name):
    g, q, cand, order = cases[name]
    want = one_shard_reference[name]
    rep = {}
    got = device_join_search(port(g), port(q), cand, order=order, report=rep,
                             device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want["rows"])
    np.testing.assert_array_equal(got, want["bfs"])
    assert set(rep) == set(empty_enum_report())
    assert rep["scan_path"] == "device"
    assert _fields(rep) == want["report"]
    obsv.EnumReport.from_dict(rep)
    for cap, rows in want["caps"].items():
        np.testing.assert_array_equal(
            device_join_search(port(g), port(q), cand, order=order,
                               max_embeddings=cap, device="cpu"), rows)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_three_shards_equal_reference(cases, sharded_reference, name,
                                      threshold):
    g, q, cand, order = cases[name]
    want = sharded_reference[f"{name}/{threshold}"]
    mesh = device_mesh(3, devices="cpu")
    rep = {}
    got = sharded_device_join_search(port(g), port(q), cand, mesh=mesh,
                                     order=order, report=rep,
                                     rebalance_threshold=threshold)
    np.testing.assert_array_equal(got, np.asarray(want["rows"], np.int64)
                                  .reshape(-1, q.n_vertices))
    assert _fields(rep) == want["report"]
    for cap, rows in want["caps"].items():
        np.testing.assert_array_equal(
            sharded_device_join_search(port(g), port(q), cand, mesh=mesh,
                                       order=order, max_embeddings=int(cap),
                                       rebalance_threshold=threshold),
            np.asarray(rows, np.int64).reshape(-1, q.n_vertices))


def test_the_cases_reach_what_they_name(cases, one_shard_reference,
                                        sharded_reference):
    walk = sharded_reference["walk/1.05"]["report"]
    assert walk["rebalance_rounds"] > 0  # the rebalancer fires
    empties = one_shard_reference["empties"]["report"]
    assert empties["levels"][-1][1] == [0] and empties["device_rounds"] == 2
    assert one_shard_reference["one_vertex"]["rows"].shape[0] > 0
    assert one_shard_reference["one_vertex"]["report"]["device_rounds"] == 0
    # the repeated pair keeps its last label, 1: the query edge labelled 1
    # matches it both ways, and only there
    dup = one_shard_reference["dup"]["rows"]
    assert {tuple(r) for r in dup.tolist()} == {(0, 1), (1, 0)}


@pytest.mark.parametrize("name", ["walk", "dup"])
def test_matrix_filled_from_the_edge_list_equals_the_host_build(cases, name):
    g = port(cases[name][0])
    n = g.n_vertices
    got = _edge_label_matrix(g.src, g.dst, g.elabels, n)
    assert got.dtype == torch.int32 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), _dense_edge_labels(g, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_table_emit_equals_the_emit_then_its_decode(seed):
    rng = np.random.default_rng(seed)
    r, t, c, n, j = 97, 4, 150, 120, 3
    table = torch.as_tensor(rng.integers(0, n, size=(r, t)), dtype=torch.int32)
    row_valid = torch.as_tensor(rng.random(r) < 0.8)
    cand = torch.as_tensor(np.sort(rng.choice(n, size=c - 30, replace=False)
                                   ).tolist() + [0] * 30, dtype=torch.int32)
    cand_valid = torch.arange(c) < c - 30
    elab = torch.as_tensor(np.where(rng.random((n, n)) < 0.4,
                                    rng.integers(0, 2, size=(n, n)), -1),
                           dtype=torch.int32)
    q_pos = torch.as_tensor(rng.integers(0, t, size=j), dtype=torch.int32)
    q_lab = torch.as_tensor(rng.integers(0, 2, size=j), dtype=torch.int32)
    q_valid = torch.tensor([True, True, False])
    args = (table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid)
    counts = ref.embed_join_count_ref(*args).long()
    total = int(counts.sum())
    assert total > 0
    base = 11  # the rows' slots start past an earlier slice's
    row_off = base + counts.cumsum(0) - counts
    idx = ref.embed_join_emit_ref(torch.zeros(base + total, dtype=torch.int64),
                                  *args, row_off, 0)[base:]
    r_idx, c_idx = idx // c, idx % c
    decoded = torch.cat([table[r_idx], cand[c_idx][:, None]], dim=1)
    out = torch.zeros((base + total + 7, t + 1), dtype=torch.int32)
    ref.embed_join_emit_table_ref(out, *args, row_off)
    assert torch.equal(out[base : base + total], decoded)
    assert not out[:base].any() and not out[base + total:].any()
    # a short output drops the slots past its end
    short = torch.zeros((base + total // 2, t + 1), dtype=torch.int32)
    ref.embed_join_emit_table_ref(short, *args, row_off)
    assert torch.equal(short[base:], decoded[: total // 2])


@pytest.mark.parametrize("name", ["walk", "empties", "one_vertex"])
def test_traced_join_spans_count_their_copies(cases, name):
    g, q, cand, order = cases[name]
    rep = {}
    with obsv.tracing() as tr:
        emb = device_join_search(port(g), port(q), cand, order=order,
                                 report=rep, device="cpu")
    spans = [s for s in tr.spans if s.name.startswith("enum.")]
    assert spans and all("copies" in s.attrs for s in spans)
    per_name = {}
    for s in spans:
        per_name[s.name] = per_name.get(s.name, 0) + s.attrs["copies"]
    levels_run = rep["device_rounds"]
    # one upload, one read a level run, the assembly's read of the rows
    assert per_name["enum.build"] == 1
    assert per_name.get("enum.count", 0) == levels_run
    assert sum(per_name.values()) == 1 + levels_run + (1 if len(emb) else 0)
    if name == "walk":
        assert levels_run == q.n_vertices - 1 and len(emb) > 0
        assert sum(per_name.values()) == 1 + levels_run + 1
