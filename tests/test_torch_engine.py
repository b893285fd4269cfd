"""The port end to end against the reference engine, and its boundaries.

* the quickstart configuration (``khop=2``) with both enumerators;
* the generators, seed for seed;
* no entry point runs on the CPU unless asked: ``device=None`` means CUDA;
* the port imports neither ``jax`` nor anything of ``repro``.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import SubgraphQueryEngine as RefEngine
from repro.graphs import paper_dataset as r_paper_dataset
from repro.graphs import power_law_graph as r_power_law
from repro.graphs import random_labeled_graph as r_random_graph
from repro.graphs import random_walk_query as r_walk
from repro_torch import obsv
from repro_torch.core import (
    SubgraphQueryEngine,
    bfs_join_search,
    device_join_search,
    ilgf,
)
from repro_torch.graphs import (
    graph_from_numpy,
    paper_dataset,
    power_law_graph,
    random_labeled_graph,
    random_walk_query,
)

ROOT = Path(__file__).resolve().parents[1]


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def assert_same_graph(port_graph, ref_graph):
    for name, got, want in zip(ref_graph._fields, port_graph, ref_graph):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


@pytest.mark.parametrize("enumerator", ["host", "device"])
def test_quickstart_configuration(enumerator):
    data = r_random_graph(2_000, 8_000, n_labels=8, n_edge_labels=2, seed=42)
    query = r_walk(data, 6, sparse=True, seed=7)
    want, r_stats = RefEngine(data, filter_variant="cni", khop=2,
                              enumerator=enumerator).query(query)
    engine = SubgraphQueryEngine(port(data), filter_variant="cni", khop=2,
                                 enumerator=enumerator, device="cpu")
    got, stats = engine.query(port(query))
    np.testing.assert_array_equal(got, want)
    assert got.shape[0] > 0
    for field in ("ilgf_iterations", "vertices_before", "vertices_after",
                  "candidate_pairs", "n_embeddings"):
        assert getattr(stats, field) == getattr(r_stats, field), field
    if enumerator == "device":
        assert set(stats.extras["enum"]) == set(r_stats.extras["enum"])
        assert stats.extras["enum"]["levels"] == r_stats.extras["enum"]["levels"]
    # truncation keeps the reference's prefix
    got_cap, _ = engine.query(port(query), max_embeddings=3)
    np.testing.assert_array_equal(got_cap, want[:3])


def test_filter_killed_query_records_empty_report():
    data = r_random_graph(200, 600, 4, seed=1)
    query = graph_from_numpy(np.array([90, 91], np.int32), np.array([0, 1]),
                             np.array([1, 0]), np.zeros(2, np.int32), device="cpu")
    engine = SubgraphQueryEngine(port(data), enumerator="device", device="cpu")
    emb, stats = engine.query(query)
    assert emb.shape == (0, 2)
    assert stats.vertices_after == 0
    assert stats.extras["enum"] == obsv.EnumReport.empty()


def test_spans_when_tracing_and_silence_when_not():
    data = random_labeled_graph(300, 900, 4, seed=3, device="cpu")
    query = random_walk_query(data, 4, seed=5, device="cpu")
    engine = SubgraphQueryEngine(data, enumerator="device", device="cpu")
    with obsv.tracing() as tracer:
        engine.query(query)
    assert {"query", "query.filter", "query.enumerate", "enum.count",
            "enum.scan", "enum.emit"} <= tracer.names()
    assert obsv.span("x") is obsv.trace.NOOP_SPAN
    assert obsv.span_at("x", 0.0, 1.0) is None


@pytest.mark.parametrize("kwargs", [
    {"n_edge_labels": 1, "label_dist": "uniform", "seed": 0},
    {"n_edge_labels": 3, "label_dist": "gaussian", "seed": 4},
    {"n_edge_labels": 2, "label_dist": "zipf", "seed": 9},
])
def test_generators_seed_for_seed(kwargs):
    want = r_random_graph(500, 1800, 12, **kwargs)
    got = random_labeled_graph(500, 1800, 12, device="cpu", **kwargs)
    assert_same_graph(got, want)
    for n_q, sparse in ((6, True), (8, False)):
        assert_same_graph(
            random_walk_query(got, n_q, sparse=sparse, seed=kwargs["seed"],
                              device="cpu"),
            r_walk(want, n_q, sparse=sparse, seed=kwargs["seed"]),
        )
    assert_same_graph(power_law_graph(400, 6.0, 5, device="cpu", **kwargs),
                      r_power_law(400, 6.0, 5, **kwargs))


@pytest.mark.parametrize("name", ["HUMAN", "LIVEJOURNAL"])
def test_paper_dataset_seed_for_seed(name):
    assert_same_graph(paper_dataset(name, scale=0.002, device="cpu"),
                      r_paper_dataset(name, scale=0.002))


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a card, device=None raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = random_labeled_graph(50, 120, 3, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SubgraphQueryEngine(g)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_labeled_graph(50, 120, 3, seed=0)
    q = random_walk_query(g, 3, seed=1, device="cpu")
    cand = ilgf(g, q).candidates.numpy()  # runs where its graph lives
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_join_search(g, q, cand)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bfs_join_search(g, q, cand)


@pytest.mark.parametrize("case,slice_item", [
    ("mesh", "11"),
    ("sharded_store", "11"),
])
def test_later_slices_raise(case, slice_item):
    """The cases of ROADMAP item ``slice_item`` (A11, multi-device) raised
    until that slice was ported; a meshed engine, and an engine over a
    sharded store, now answer as the reference's unmeshed engine does."""
    from repro_torch.core import device_mesh
    from repro_torch.graphs import ShardedGraphStore

    assert slice_item == "11"
    g_ref = r_random_graph(50, 120, 3, seed=0)
    g = graph_from_numpy(*(np.asarray(x) for x in g_ref), device="cpu")
    if case == "mesh":
        eng = SubgraphQueryEngine(g, mesh=device_mesh(2, devices="cpu"),
                                  enumerator="device", device="cpu")
    else:
        eng = SubgraphQueryEngine(ShardedGraphStore.from_graph(
            g, n_shards=2, device="cpu"), device="cpu")
    ref = RefEngine(g_ref)
    for seed in range(3):
        q = r_walk(g_ref, 3, seed=seed)
        want, w_stats = ref.query(q)
        got, stats = eng.query(graph_from_numpy(
            *(np.asarray(x) for x in q), device="cpu"))
        np.testing.assert_array_equal(got, np.asarray(want))
        assert stats.ilgf_iterations == w_stats.ilgf_iterations
    with pytest.raises(TypeError, match="ShardMesh"):
        SubgraphQueryEngine(g, mesh=object(), device="cpu")


def test_store_input_raises():
    """An out-of-core snapshot without its store's index raises, and a
    store of the reference package is no port input."""
    from repro.graphs import GraphStore
    from repro_torch.graphs import GraphSnapshot

    g = random_labeled_graph(50, 120, 3, seed=0, device="cpu")
    with pytest.raises(ValueError, match="incremental index"):
        SubgraphQueryEngine(GraphSnapshot(0, g, None, ooc=object()),
                            device="cpu")
    with pytest.raises(TypeError, match="repro_torch Graph"):
        SubgraphQueryEngine(GraphStore(4, np.zeros(4, np.int64)), device="cpu")


def test_import_loads_neither_jax_nor_repro():
    """Importing every module of the port pulls in no jax and no repro.*."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                                               'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 15 else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(ROOT / "src"),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_repro_import_in_port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, path
