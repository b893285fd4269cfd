"""The port's single-pass stream filter (Algorithm 6) against the reference.

On the patterns of ``tests/test_search_stream.py``: the same edge files
and chunk iterators go through ``repro.core.stream`` and
``repro_torch.core.stream``, and everything they return must be equal —
``StreamStats`` field for field (the peak retained count included, which
the port computes from each vertex's pruning chunk where the reference
recounts every retained chunk after every chunk), the prefilter mask, the
retained graph's arrays and the ILGF result (alive mask, candidate
columns, rounds).  ``scan_filter`` equals the reference's and the one-shot
filter at every chunk size.
"""

import os

import numpy as np
import pytest

from repro.core import ilgf as r_ilgf
from repro.core import one_shot_filter as r_one_shot
from repro.core import stream as rs
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs import write_edge_file as r_write_edge_file
from repro.graphs.csr import max_degree
from repro.graphs.store import EdgeBatch as RefEdgeBatch
from repro_torch.core import stream as ps
from repro_torch.graphs import EdgeBatch, graph_from_numpy
from strategies import graph_chunks


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def assert_same_stream(got, want):
    assert tuple(got.stats) == tuple(want.stats)
    assert got.prefilter_alive.dtype == np.bool_
    np.testing.assert_array_equal(got.prefilter_alive, want.prefilter_alive)
    for name, x, y in zip(got.retained._fields, got.retained, want.retained):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), name)
    np.testing.assert_array_equal(got.ilgf_result.alive.numpy(),
                                  np.asarray(want.ilgf_result.alive))
    np.testing.assert_array_equal(got.ilgf_result.candidates.numpy(),
                                  np.asarray(want.ilgf_result.candidates))
    assert got.ilgf_result.iterations == int(want.ilgf_result.iterations)


def both(source_ref, source_port, g, q, **kw):
    want = rs.stream_filter_file(source_ref, np.asarray(g.vlabels), q,
                                 d_max=max_degree(g), **kw)
    got = ps.stream_filter_file(source_port, np.asarray(g.vlabels), port(q),
                                d_max=max_degree(g), device="cpu", **kw)
    assert_same_stream(got, want)
    return got, want


@pytest.mark.parametrize("chunk", [7, 64, 4096, 100_000])
def test_scan_filter_equals_reference_and_one_shot(chunk):
    g = random_labeled_graph(300, 1000, 5, seed=8)
    q = random_walk_query(g, 5, sparse=True, seed=9)
    got = ps.scan_filter(port(g), port(q), chunk_edges=chunk, device="cpu")
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, rs.scan_filter(g, q, chunk_edges=chunk))
    np.testing.assert_array_equal(got, np.asarray(r_one_shot(g, q).alive))


@pytest.mark.parametrize("sorted_stream", [True, False])
def test_stream_file_equals_reference(tmp_path, sorted_stream):
    g = random_labeled_graph(350, 1200, 5, n_edge_labels=2, seed=10)
    q = random_walk_query(g, 5, sparse=True, seed=11)
    path = str(tmp_path / "g.bin")
    r_write_edge_file(path, g, sorted_by_src=sorted_stream)
    got, _ = both(path, path, g, q, chunk_edges=256,
                  sorted_stream=sorted_stream)
    np.testing.assert_array_equal(got.ilgf_result.alive.numpy(),
                                  np.asarray(r_ilgf(g, q).alive))
    assert got.stats.total_edges_seen == g.n_directed_edges


def test_sorted_stream_prunes_early_as_the_reference(tmp_path):
    g = random_labeled_graph(400, 1400, 6, seed=12)
    q = random_walk_query(g, 6, sparse=True, seed=13)
    path = str(tmp_path / "g.bin")
    r_write_edge_file(path, g, sorted_by_src=True)
    got, _ = both(path, path, g, q, chunk_edges=128, sorted_stream=True)
    assert got.stats.pruned_during_stream > 0
    # pruning bounds the peak below the label-filter total
    assert got.stats.peak_retained_edges > got.stats.final_retained_edges


def test_single_edge_chunks_equal_reference(tmp_path):
    g = random_labeled_graph(60, 180, 3, n_edge_labels=2, seed=22)
    q = random_walk_query(g, 4, sparse=True, seed=23)
    path = str(tmp_path / "g.bin")
    r_write_edge_file(path, g, sorted_by_src=True)
    got, _ = both(path, path, g, q, chunk_edges=1, sorted_stream=True)
    assert got.stats.n_chunks == g.n_directed_edges


def test_empty_and_invalid_chunks_are_no_ops():
    g = random_labeled_graph(150, 500, 4, n_edge_labels=2, seed=20)
    q = random_walk_query(g, 4, sparse=True, seed=21)
    chunks = graph_chunks(g, 64)
    empty = (np.zeros(0, np.int32),) * 3 + (np.zeros(0, bool),)
    invalid = (np.zeros(16, np.int32),) * 3 + (np.zeros(16, bool),)
    spiked = [empty, chunks[0], invalid] + chunks[1:] + [empty]
    got, _ = both(spiked, spiked, g, q, sorted_stream=False)
    np.testing.assert_array_equal(got.ilgf_result.alive.numpy(),
                                  np.asarray(r_ilgf(g, q).alive))
    assert got.stats.total_edges_seen == g.n_directed_edges


@pytest.mark.parametrize("sorted_stream", [True, False])
def test_iterator_sources_equal_reference(sorted_stream):
    """Shuffled legacy tuples, ``EdgeBatch``es and a whole graph: the same
    fixed point, the same statistics."""
    g = random_labeled_graph(200, 700, 5, n_edge_labels=2, seed=24)
    q = random_walk_query(g, 5, sparse=True, seed=25)
    order = np.random.default_rng(3).permutation(g.n_directed_edges)
    chunks = graph_chunks(g, 100, order=order)
    both(chunks, chunks, g, q, chunk_edges=100, sorted_stream=sorted_stream)
    ones = [np.ones(c[0].size, bool) for c in chunks]
    ref_batches = [RefEdgeBatch(*c[:3], insert=i, valid=c[3])
                   for c, i in zip(chunks, ones)]
    port_batches = [EdgeBatch(*b) for b in ref_batches]
    both(ref_batches, port_batches, g, q, chunk_edges=100,
         sorted_stream=sorted_stream)
    got, _ = both(g, port(g), g, q, chunk_edges=100,
                  sorted_stream=sorted_stream)
    assert got.stats.n_chunks == -(-g.n_directed_edges // 100)


def test_without_ilgf_returns_the_prefilter(tmp_path):
    g = random_labeled_graph(150, 500, 4, seed=30)
    q = random_walk_query(g, 4, sparse=True, seed=31)
    path = str(tmp_path / "g.bin")
    r_write_edge_file(path, g, sorted_by_src=True)
    got, _ = both(path, path, g, q, chunk_edges=64, run_ilgf=False)
    np.testing.assert_array_equal(got.ilgf_result.alive.numpy(),
                                  got.prefilter_alive)
    assert got.ilgf_result.candidates.shape == (g.n_vertices, q.n_vertices)
    assert not got.ilgf_result.candidates.any()
    assert os.path.getsize(path) == 16 + 8 * g.n_vertices \
        + 24 * g.n_directed_edges
