"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips with a reason where no CUDA device is
present.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import SubgraphQueryEngine, device_join_search
from repro_torch.graphs import random_labeled_graph, random_walk_query, to_host
from repro_torch.kernels.embed_join import ops, ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def random_level(r, t, c, n, j, seed, device):
    rng = np.random.default_rng(seed)
    cand = np.sort(rng.choice(n, size=min(c, n), replace=False))
    arrays = (
        rng.integers(0, n, size=(r, t)).astype(np.int32),
        rng.random(r) < 0.8,
        np.pad(cand, (0, c - cand.size)).astype(np.int32),
        (np.arange(c) < cand.size) & (rng.random(c) < 0.9),
        np.where(rng.random((n, n)) < 0.3, rng.integers(0, 3, size=(n, n)),
                 -1).astype(np.int32),
        rng.integers(0, t, size=j).astype(np.int32),
        rng.integers(0, 3, size=j).astype(np.int32),
        rng.random(j) < 0.7,
    )
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


SHAPES = [(64, 3, 32, 50, 2), (100, 1, 33, 40, 1), (1013, 5, 640, 700, 3),
          (301, 16, 200, 90, 4), (4096, 2, 1024, 1100, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_equal_plain_versions(cuda, shape):
    args = random_level(*shape, seed=sum(shape), device=cuda)
    before = ops.launch_counts()
    grid = ops.embed_join(*args)
    counts = ops.embed_join_count(*args)
    torch.testing.assert_close(grid, ref.embed_join_grid_ref(*args), rtol=0, atol=0)
    torch.testing.assert_close(counts, ref.embed_join_count_ref(*args), rtol=0, atol=0)
    row_off = counts.cumsum(0) - counts
    total = int(counts.sum())
    for row_base in (0, 777):
        fill = torch.full((total + 9,), -7, dtype=torch.int64, device=cuda)
        got = ops.embed_join_emit(fill.clone(), *args, row_off, row_base)
        want = ref.embed_join_emit_ref(fill.clone(), *args, row_off, row_base)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    after = ops.launch_counts()
    assert after["embed_join_grid"] - before["embed_join_grid"] == 1
    assert after["embed_join_count"] - before["embed_join_count"] == 1
    assert after["embed_join_emit"] - before["embed_join_emit"] == 2


def test_device_join_on_card_equals_cpu(cuda):
    g = random_labeled_graph(3000, 12000, 6, n_edge_labels=2, seed=5, device="cpu")
    q = random_walk_query(g, 5, sparse=True, seed=9, device="cpu")
    cand = (to_host(g).vlabels[:, None] == to_host(q).vlabels[None, :])
    want = device_join_search(g, q, cand, device="cpu", max_embeddings=5000)
    got = device_join_search(g, q, cand, device=cuda, max_embeddings=5000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("enumerator", ["device", "host"])
def test_engine_on_card_equals_cpu(cuda, enumerator):
    g = random_labeled_graph(2000, 8000, 8, n_edge_labels=2, seed=42, device="cpu")
    q = random_walk_query(g, 6, sparse=True, seed=7, device="cpu")
    want, s_cpu = SubgraphQueryEngine(g, khop=2, enumerator=enumerator,
                                      device="cpu").query(q)
    got, s_gpu = SubgraphQueryEngine(g, khop=2, enumerator=enumerator).query(q)
    np.testing.assert_array_equal(got, want)
    assert s_gpu.ilgf_iterations == s_cpu.ilgf_iterations
    assert s_gpu.candidate_pairs == s_cpu.candidate_pairs
