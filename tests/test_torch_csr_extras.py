"""The reference's public leftovers in the port (ROADMAP A13):
``PaddedGraph``, ``to_padded``, ``adjacency_bitmap`` and
``edge_label_lookup`` (``repro_torch.graphs``) equal the reference's bit for
bit, fields, dtypes and pad value included, on seeded graphs with
``d_max=None`` and an explicit ``d_max``; ``cni_exact_py``
(``repro_torch.core``) equals the reference's, and the port's int64 exact
digest equals it on every row whose value fits below ``SAT64``, over the
label lists of the reference's bijection test (``tests/test_cni.py``).
"""

import itertools

import numpy as np
import pytest
import torch

from repro import graphs as rg
from repro.core import cni_exact_py as r_cni_exact_py
from repro_torch import graphs as pg
from repro_torch.core import SAT64, cni_exact_py, cni_from_counts
from repro_torch.core.cni import cni_from_counts_np, default_max_p

GRAPHS = {  # name -> (n, m, labels, edge labels, seed)
    "small": (12, 20, 3, 2, 0),
    "medium": (200, 900, 5, 4, 1),
    "sparse": (300, 150, 8, 1, 2),   # isolated vertices
    "edgeless": (7, 0, 2, 1, 3),
}


def pair(name):
    n, m, nl, ne, seed = GRAPHS[name]
    rng = np.random.default_rng(seed)
    vl = rng.integers(1, nl + 1, size=n).astype(np.int32)
    edges = rng.integers(0, n, size=(m, 2))
    el = rng.integers(0, ne, size=m)
    return (rg.build_graph(n, vl, edges, el),
            pg.build_graph(n, vl, edges, el, device="cpu"))


@pytest.mark.parametrize("d_max", [None, 3, 64])
@pytest.mark.parametrize("name", GRAPHS)
def test_to_padded_equals_reference(name, d_max):
    r_g, g = pair(name)
    want = rg.to_padded(r_g, d_max)
    got = pg.to_padded(g, d_max)
    assert isinstance(got, pg.PaddedGraph)
    assert got._fields == want._fields
    for f in want._fields:
        w, x = np.asarray(getattr(want, f)), getattr(got, f)
        assert x.device.type == "cpu" and x.dtype == torch.int32, f
        np.testing.assert_array_equal(x.numpy(), w, err_msg=f)
    assert got.max_degree == want.max_degree
    assert got.n_vertices == want.n_vertices
    assert int(got.nbr.min()) >= -1


@pytest.mark.parametrize("name", GRAPHS)
def test_adjacency_bitmap_and_edge_labels_equal_reference(name):
    r_g, g = pair(name)
    want = np.asarray(rg.adjacency_bitmap(r_g))
    got = pg.adjacency_bitmap(g)
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    from repro.graphs.csr import edge_label_lookup as r_lookup
    assert pg.edge_label_lookup(g) == r_lookup(r_g)
    # a numpy-backed graph (the search stages' form) gives the same tables
    host = pg.to_host(g)
    np.testing.assert_array_equal(pg.adjacency_bitmap(host, device="cpu")
                                  .numpy(), want)
    assert torch.equal(pg.to_padded(host, device="cpu").nbr,
                       pg.to_padded(g).nbr)


# the label lists of the reference's bijection test: counts of labels 1-4,
# each 0-3, at d_max 12 and 4 labels
COUNTS = list(itertools.product(range(4), repeat=4))


def test_cni_exact_py_equals_reference():
    for counts in COUNTS[::7] + [(0, 0, 0, 0), (3, 3, 3, 3)]:
        labels = [l for l, c in enumerate(counts, start=1) for _ in range(c)]
        assert cni_exact_py(labels) == r_cni_exact_py(labels)
    big = list(range(1, 40)) * 3  # far past 2^62: no saturation in the oracle
    assert cni_exact_py(big) == r_cni_exact_py(big) > SAT64
    assert cni_exact_py([0, -2, 5]) == r_cni_exact_py([0, -2, 5]) == 5


def test_int64_digest_equals_the_oracle_below_saturation():
    L, D = 4, 12
    max_p = default_max_p(D, L)
    counts = np.array(COUNTS, dtype=np.int32)
    got = cni_from_counts(torch.as_tensor(counts), D, max_p).numpy()
    host, _, _ = cni_from_counts_np(counts, D, max_p)
    checked = 0
    for row, c in enumerate(COUNTS):
        labels = [l for l, n in enumerate(c, start=1) for _ in range(n)]
        want = cni_exact_py(labels)
        if want < SAT64:
            assert int(got[row]) == int(host[row]) == want, c
            checked += 1
    assert checked == len(COUNTS)
