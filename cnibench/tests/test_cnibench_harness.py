"""CPU tests of the benchmark harness (``python -m pytest cnibench/tests``).

They check the cells resolve to their files, the generators and the
reference at tiny sizes, the result line's keys, the control and the
faults that the comparison must catch, and which modules a run loads.
Tests marked ``gpu`` need the card and skip without one.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from itertools import permutations
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT / "src"))

from cnib import checks, main, queries, spec, sub_seed  # noqa: E402

import control  # noqa: E402

REF = spec.load_module("references", "subgraph_join")
GNM = spec.load_module("generators", "gnm")
BENCHMARK = spec.load_benchmark()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
TINY = {  # sizes at which a CPU run takes seconds
    "human-gnm": {},
}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def tiny_cell(name: str, pool: int = 64) -> spec.Cell:
    cell = spec.load_cell(name)
    cfg = dict(cell.config, reference_device="cpu")
    cfg["graph"] = dict(cfg["graph"], **TINY[cfg["name"]])
    traffic = dict(cell.traffic, pool=pool, profile={"start_s": 0.2, "seconds": 1.0})
    return cell._replace(config=cfg, traffic=traffic)


def quiet(msg):
    pass


# -- the cells and BENCHMARK.json ---------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCHMARK["workloads"] if w["name"] == name)
    spec.load_module("generators", cell.config["generator"])
    spec.load_module("references", cell.config["reference"])
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.load_module("metrics", m["name"]).read)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "queries_per_s"}
    assert cell.per_layer
    assert int(cell.traffic["pool"]) > 0 and int(cell.traffic["clients"]) > 0


def test_benchmark_json_keeps_the_contract_shape():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"][:2] == ["python3", "cnibench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in b[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for group, want in keys.items():
        for x in b[group]:
            assert set(x) == want
            assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
    for c in b["configs"]:
        assert len(c["source"]) <= 200
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("cnibench/")
        assert c["reduced"] == spec.read_json(ROOT / c["file"])["reduced"]
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {m["layer"] for m in b["per_layer"]}
    assert layers == {"service", "filter round", "compaction", "join", "kernels",
                      "device"}


# -- generators ----------------------------------------------------------------


def _tiny_graph(seed, n=300, m=2_000, labels=7):
    return GNM.make_graph({"n_vertices": n, "n_edges": m, "n_labels": labels},
                          seed, "cpu")


def test_graph_generator_is_deterministic_and_keeps_the_invariants():
    a, b, c = _tiny_graph(5), _tiny_graph(5), _tiny_graph(6)
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["src"], c["src"])
    src, dst = a["src"], a["dst"]
    assert src.dtype == dst.dtype == torch.int64
    assert a["vlabels"].dtype == a["elabels"].dtype == torch.int32
    assert src.numel() == 2 * 2_000 and bool((src != dst).all())
    key = src * 300 + dst
    assert bool((key[1:] > key[:-1]).all())  # sorted by src, then dst; no repeat
    rev = torch.sort(dst * 300 + src).values
    assert torch.equal(rev, key)  # both directions of every edge
    assert int(a["vlabels"].min()) >= 0 and int(a["vlabels"].max()) < 7
    assert not bool(a["elabels"].any())  # one edge label


def test_query_generator_is_deterministic_and_plants_its_walk():
    g = _tiny_graph(9)
    for shape in ("dense", "sparse"):
        p1 = queries.draw_pool(g, shape, [4, 5, 6], 30, 11)
        p2 = queries.draw_pool(g, shape, [4, 5, 6], 30, 11)
        assert all(np.array_equal(x.edges, y.edges) and np.array_equal(
            x.planted, y.planted) for x, y in zip(p1, p2))
        assert sorted(len(q.vlabels) for q in p1) == [4] * 10 + [5] * 10 + [6] * 10
        keys = set((g["src"] * 300 + g["dst"]).tolist())
        vl = g["vlabels"].numpy()
        for q in p1:
            assert len(set(q.planted.tolist())) == len(q.planted)
            assert np.array_equal(vl[q.planted], q.vlabels)
            for i, j in q.edges:
                assert int(q.planted[i]) * 300 + int(q.planted[j]) in keys
            if shape == "sparse":
                assert q.edges.shape[0] <= max(len(q.vlabels) - 1,
                                               int(1.5 * len(q.vlabels)))


# -- the reference -------------------------------------------------------------


def brute_force(g, q) -> np.ndarray:
    n = int(g["vlabels"].numel())
    vl = g["vlabels"].numpy()
    edges = set((g["src"] * n + g["dst"]).tolist())
    cands = [np.nonzero(vl == lab)[0] for lab in q.vlabels]
    rows = []

    def extend(partial):
        u = len(partial)
        if u == len(q.vlabels):
            rows.append(list(partial))
            return
        for v in cands[u]:
            if v in partial:
                continue
            ok = all(int(partial[a]) * n + int(v) in edges
                     for a, b in q.edges if b == u and a < u) and all(
                int(partial[b]) * n + int(v) in edges
                for a, b in q.edges if a == u and b < u)
            if ok:
                extend(partial + [int(v)])

    extend([])
    return REF.sort_rows(np.asarray(rows, np.int64).reshape(-1, len(q.vlabels)))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_equals_brute_force_on_tiny_graphs(seed):
    g = GNM.make_graph({"n_vertices": 40, "n_edges": 160, "n_labels": 3}, seed, "cpu")
    idx = REF.build_index(g, "cpu")
    for shape in ("dense", "sparse"):
        for q in queries.draw_pool(g, shape, [3, 4, 5], 9, seed):
            got = REF.embeddings(idx, q.vlabels, q.edges, q.elabels)
            assert np.array_equal(got, brute_force(g, q))
            assert checks.contains_row(got, q.planted)


def test_reference_finds_the_planted_walk_of_every_query():
    for name in CELLS:
        cell = tiny_cell(name)
        graph, pool = main.make_data(cell, 2**31 + 5, "cpu")
        idx = REF.build_index(graph, "cpu")
        for q in pool[:40]:
            assert checks.contains_row(
                REF.embeddings(idx, q.vlabels, q.edges, q.elabels), q.planted)


def test_reference_counts_automorphic_embeddings():
    # a triangle of one label in a triangle: 3! embeddings
    g = {"vlabels": torch.zeros(3, dtype=torch.int32),
         "src": torch.tensor([0, 0, 1, 1, 2, 2]), "dst": torch.tensor([1, 2, 0, 2, 0, 1]),
         "elabels": torch.zeros(6, dtype=torch.int32)}
    idx = REF.build_index(g, "cpu")
    got = REF.embeddings(idx, np.zeros(3, np.int32), np.array([[0, 1], [0, 2], [1, 2]]),
                         np.zeros(3, np.int32))
    assert sorted(map(tuple, got.tolist())) == sorted(permutations(range(3)))


# -- a run on the CPU ----------------------------------------------------------

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cpu_rehearsal_gives_the_contract_line(name, trace):
    cell = tiny_cell(name)
    res = main.run_cell(cell, 3_000_000_017, 2.0, trace, "cpu", log=quiet)
    want = RESULT_KEYS[:-1] + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= names
    if not trace:
        assert set(res["metrics"]) == names
    else:
        assert {"admit_ms.per_query", "rounds_per_query", "join_ms.per_query",
                "compact_ms.per_query", "join_levels.per_query"} <= set(res["metrics"])
        assert "busy_s" in res["device"] and "window_s" in res["device"]
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert list(res["checks"]) == ["wrong", "failed", "planted_missing", "compared"]
    json.dumps(res)


def test_run_without_a_card_fails_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
sys.path.insert(0, {str(BENCH / 'tests')!r})
import test_cnibench_harness as t
from cnib import main
res = main.run_cell(t.tiny_cell({CELLS[0]!r}), 7, 1.0, True, "cpu", log=t.quiet)
assert res["correct"], res
bad = main.forbidden_modules()
print("BAD" if bad else "CLEAN", bad)
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "CLEAN" in proc.stdout, proc.stdout


def test_the_reference_loads_nothing_of_the_program():
    code = f"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location(
    "ref", {str(BENCH / 'references' / 'subgraph_join.py')!r})
mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
tops = {{m.split('.')[0] for m in sys.modules}}
print(sorted(tops & {{'repro_torch', 'repro', 'jax', 'cnib'}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "[]"


# -- the control and the faults ------------------------------------------------


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    out = control.control_checks(tiny_cell(name), 2**31 + 9, 30, "cpu")
    assert out["correct"] is False and out["wrong"] > 0
    assert out["planted_missing"] == 0


def _alter_one_id(orig):
    def search_filtered(data, query, *args, **kwargs):
        emb = orig(data, query, *args, **kwargs)
        if emb.size:
            emb = emb.copy()
            emb[0, 0] = (emb[0, 0] + 1) % data.n_vertices
        return emb
    return search_filtered


def _drop_half_the_slots(orig):
    def batched_ilgf_round(g, qb, alive, **kwargs):
        alive = alive.clone()
        alive[alive.shape[0] // 2:] = False
        return orig(g, qb, alive, **kwargs)
    return batched_ilgf_round


def _state_unchanged(orig):
    # the round hands its input mask back as converged and computes no
    # candidate columns
    def batched_ilgf_round(g, qb, alive, **kwargs):
        u = qb.digest.ord_label.shape[-1]
        return alive, torch.zeros(alive.shape + (u,), dtype=torch.bool,
                                  device=alive.device), torch.zeros(
            alive.shape[0], dtype=torch.bool, device=alive.device)
    return batched_ilgf_round


FAULTS = {
    "answer_altered": ("search_filtered", _alter_one_id),
    "half_the_batch_left_out": ("batched_ilgf_round", _drop_half_the_slots),
    "state_returned_unchanged": ("batched_ilgf_round", _state_unchanged),
}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_makes_correct_false(name, fault, monkeypatch):
    from repro_torch.serve import graph_service

    attr, make = FAULTS[fault]
    monkeypatch.setattr(graph_service, attr, make(getattr(graph_service, attr)))
    res = main.run_cell(tiny_cell(name), 2**31 + 21, 2.0, False, "cpu", log=quiet)
    assert res["correct"] is False
    assert res["failed"] > 0


# -- on the card ---------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    profile = spec.load_cell(name).traffic["profile"]
    seconds = float(profile["start_s"]) + float(profile["seconds"]) + 1  # past the traced stretch
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name, "--seed",
         str(sub_seed(1, name)), "--seconds", str(seconds), "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
