"""The port's three searchers against the reference's, on the CPU.

``device_join_search`` runs the same count → scan → emit loop on the CPU
(with the kernels' plain versions) that it runs on the card.  Its rows,
and those of the port's ``bfs_join_search`` and ``host_dfs_search``, must
equal the reference's ``device_join_search`` bit for bit — row order and
``max_embeddings`` prefixes included — on the reference differential
suite's seed sweep and corners.
"""

import numpy as np
import pytest

from repro.core import device_join_search as r_device_join
from repro.graphs import random_labeled_graph as r_random_graph
from repro.graphs.csr import build_graph as r_build_graph
from repro_torch.core import (
    bfs_join_search,
    device_join_search,
    empty_enum_report,
    host_dfs_search,
)
from repro_torch.graphs import graph_from_numpy
from strategies import label_candidates, seeded_graph_and_query

# the reference differential suite's shape and seeds
_V, _E, _L, _EL, _U = 36, 90, 3, 2, 4
_SEEDS = [0, 1, 2, 3, 4, 5]


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def port_results(g, q, cand, **kw):
    tg, tq = port(g), port(q)
    return {
        "device_join": device_join_search(tg, tq, cand, device="cpu", **kw),
        "bfs_join": bfs_join_search(tg, tq, cand, device="cpu", **kw),
        "dfs": host_dfs_search(tg, tq, cand, **kw),
    }


def assert_all_equal(want, results):
    for name, got in results.items():
        assert got.dtype == np.int64, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seed", _SEEDS)
def test_seed_sweep_bit_identical(seed):
    g, q = seeded_graph_and_query(seed, n_vertices=_V, n_edges=_E, n_labels=_L,
                                  n_edge_labels=_EL, query_vertices=_U)
    cand = label_candidates(g, q)
    want = r_device_join(g, q, cand, use_kernel=False)
    assert_all_equal(want, port_results(g, q, cand))


def test_truncation_prefixes_bit_identical():
    g, q = seeded_graph_and_query(2, n_vertices=_V, n_edges=_E, n_labels=_L,
                                  n_edge_labels=_EL, query_vertices=_U)
    cand = label_candidates(g, q)
    total = r_device_join(g, q, cand, use_kernel=False).shape[0]
    assert total >= 3
    for cap in (1, total - 1, total, total + 5):
        want = r_device_join(g, q, cand, use_kernel=False, max_embeddings=cap)
        assert_all_equal(want, port_results(g, q, cand, max_embeddings=cap))


def test_reference_kernel_route_agrees():
    """One small case against the reference's Pallas kernels, run in
    interpret mode as the reference's own tests run them on the CPU."""
    g, q = seeded_graph_and_query(1, n_vertices=24, n_edges=60, n_labels=3,
                                  n_edge_labels=2, query_vertices=3)
    cand = label_candidates(g, q)
    want = r_device_join(g, q, cand, use_kernel=True)
    assert_all_equal(want, port_results(g, q, cand))


def test_all_pruned():
    g = r_random_graph(_V, _E, _L, n_edge_labels=_EL, seed=7)
    q = r_build_graph(3, [97, 98, 99], [(0, 1), (1, 2)])
    cand = label_candidates(g, q)
    report = {}
    got = device_join_search(port(g), port(q), cand, device="cpu", report=report)
    assert got.shape == (0, 3)
    assert_all_equal(r_device_join(g, q, cand, use_kernel=False),
                     port_results(g, q, cand))
    assert set(report) == set(empty_enum_report())
    assert report["device_rounds"] == 0 and report["levels"] == []


def test_single_vertex_query():
    g = r_random_graph(30, 80, 3, seed=11)
    lab = int(np.asarray(g.vlabels)[0])
    q = r_build_graph(1, [lab], np.zeros((0, 2), np.int64))
    cand = label_candidates(g, q)
    for cap in (None, 2):
        want = r_device_join(g, q, cand, use_kernel=False, max_embeddings=cap)
        assert want.shape[0] > 0
        assert_all_equal(want, port_results(g, q, cand, max_embeddings=cap))


def test_explicit_order_and_report_schema():
    """A caller-supplied order gives the same rows as the reference under
    that order, and the report keeps the reference's schema and counters."""
    g, q = seeded_graph_and_query(4, n_vertices=_V, n_edges=_E, n_labels=_L,
                                  n_edge_labels=_EL, query_vertices=_U)
    cand = label_candidates(g, q)
    order = [3, 2, 1, 0]
    r_report, t_report = {}, {}
    want = r_device_join(g, q, cand, order=order, use_kernel=True,
                         report=r_report)
    got = device_join_search(port(g), port(q), cand, order=order,
                             device="cpu", report=t_report)
    np.testing.assert_array_equal(got, want)
    assert set(t_report) == set(r_report)
    timings = ("count_seconds", "scan_seconds", "emit_seconds")
    for key in set(r_report) - set(timings):
        assert t_report[key] == r_report[key], key
    with pytest.raises(ValueError, match="permutation"):
        device_join_search(port(g), port(q), cand, order=[0, 0, 1, 2],
                           device="cpu")


def test_multi_slice_levels():
    """Levels wider than one 4096-row slice: counts from several slices
    concatenate, and each slice emits at its row_base into one buffer."""
    g = r_random_graph(300, 3000, 1, seed=3)
    q = r_build_graph(3, [0, 0, 0], [(0, 1), (1, 2)])
    cand = label_candidates(g, q)
    report = {}
    got = device_join_search(port(g), port(q), cand, device="cpu", report=report)
    assert report["levels"][0]["emit_rows"][0] > 4096  # level 2 is sliced
    np.testing.assert_array_equal(got, r_device_join(g, q, cand, use_kernel=False))
    np.testing.assert_array_equal(
        got[:1000], bfs_join_search(port(g), port(q), cand, device="cpu",
                                    max_embeddings=1000))
