"""The port's filter half against the JAX reference, on the same numpy inputs.

Counts matrices, exact CNI digests (int64 in the port, two uint32 limbs in
the reference), float32 log digests, and the ILGF fixed point of every
filter variant.  Exact outputs must be equal; the log digest is held to
1e-5 absolute, because XLA and PyTorch reduce its logsumexp in different
orders in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cni as r_cni
from repro.core import filters as r_flt
from repro.core.ilgf import ilgf as r_ilgf, one_shot_filter as r_one_shot
from repro.core import labels as r_labels
from repro.graphs.csr import build_graph
from repro_torch.core import cni as t_cni
from repro_torch.core import filters as t_flt
from repro_torch.core.ilgf import ilgf as t_ilgf, one_shot_filter as t_one_shot
from repro_torch.core import labels as t_labels
from repro_torch.graphs import graph_from_numpy
from strategies import seeded_graph_and_query

VARIANTS = ["cni", "cni_log", "nlf", "label_degree", "mnd_nlf"]


def port(g):
    """A reference graph's fields carried into the port, on the CPU."""
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def ref_u64(cni_value) -> np.ndarray:
    return r_cni.limb_to_u64_np(cni_value.hi, cni_value.lo).astype(np.int64)


def random_counts(rng, n_rows, n_labels, d_max, *, hubs=0):
    """Count rows with row sums <= d_max; ``hubs`` rows sit at d_max with
    their mass on the highest labels, which drives the digest to SAT64."""
    counts = np.zeros((n_rows, n_labels), np.int32)
    for i in range(n_rows):
        deg = rng.integers(0, d_max + 1)
        counts[i] = rng.multinomial(deg, np.ones(n_labels) / n_labels)
    for i in range(hubs):
        counts[i] = 0
        counts[i, -2:] = [d_max // 2, d_max - d_max // 2]
    return counts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_alive", [False, True])
def test_counts_matrix(seed, with_alive):
    g, q = seeded_graph_and_query(seed, n_vertices=80, n_edges=300, n_labels=4)
    tg, tq = port(g), port(q)
    alive = np.random.default_rng(seed).random(g.n_vertices) < 0.7
    lm_r = r_labels.build_label_map(q)
    lm_t = t_labels.build_label_map(tq)
    want = r_labels.counts_matrix(g, lm_r, jnp.asarray(alive) if with_alive else None)
    got = t_labels.counts_matrix(tg, lm_t, torch.as_tensor(alive) if with_alive else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        t_labels.ord_of(lm_t, tg.vlabels).numpy(),
        np.asarray(r_labels.ord_of(lm_r, g.vlabels)),
    )


def test_counts_matrix_batched():
    """A leading batch of queries over one graph equals per-query rows."""
    g, _ = seeded_graph_and_query(3, n_vertices=60, n_edges=200, n_labels=4)
    tg = port(g)
    rng = np.random.default_rng(3)
    ords = rng.integers(0, 4, size=(3, g.n_vertices)).astype(np.int32)
    alive = rng.random((3, g.n_vertices)) < 0.8
    want = r_labels.counts_matrix_from_ords(g, jnp.asarray(ords), 3, jnp.asarray(alive))
    got = t_labels.counts_matrix_from_ords(tg, torch.as_tensor(ords), 3,
                                           torch.as_tensor(alive))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d_max,n_labels,hubs", [
    (8, 3, 0),      # small, far below saturation
    (64, 2, 4),     # the saturated star-centre regime (degree 39-64, 2 labels)
    (64, 6, 6),     # saturated hubs among ordinary rows, more labels
    (200, 4, 3),    # long rows: many terms at SAT64 (int64 overflow bait)
])
def test_exact_and_log_digests(d_max, n_labels, hubs):
    rng = np.random.default_rng(d_max + n_labels)
    counts = random_counts(rng, 40, n_labels, d_max, hubs=hubs)
    max_p = r_cni.default_max_p(d_max, n_labels)
    want = ref_u64(r_cni.cni_from_counts(jnp.asarray(counts), d_max, max_p))
    got = t_cni.cni_from_counts(torch.as_tensor(counts), d_max, max_p).numpy()
    np.testing.assert_array_equal(got, want)
    if hubs:
        assert (want[:hubs] == int(r_cni.SAT64)).all()  # the corner is hit
    want_log = np.asarray(r_cni.cni_log_from_counts(jnp.asarray(counts), d_max, max_p))
    got_log = t_cni.cni_log_from_counts(torch.as_tensor(counts), d_max, max_p).numpy()
    np.testing.assert_allclose(got_log, want_log, rtol=0, atol=1e-5)


def test_saturated_star_centre_digest():
    """The corner of the reference's saturated-CNI differential test: a
    star whose centre has 39 leaves of one label, encoded at d_max = 64."""
    n = 64
    vlab = np.zeros(n, np.int64)
    vlab[1:] = 2
    g = build_graph(n, vlab, [[0, i] for i in range(1, 40)])
    q = build_graph(3, [0, 2, 2], [(0, 1), (0, 2)])
    lm = r_labels.build_label_map(q)
    counts = np.asarray(r_labels.counts_matrix(g, lm))
    max_p = r_cni.default_max_p(64, lm.n_labels)
    want = ref_u64(r_cni.cni_from_counts(jnp.asarray(counts), 64, max_p))
    got = t_cni.cni_from_counts(torch.tensor(counts), 64, max_p).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == t_cni.SAT64


def test_match_grids_and_mnd():
    """cni_match, cni_match_log, nlf and mnd grids on shared digests,
    saturated rows included."""
    rng = np.random.default_rng(5)
    d_max, n_labels = 64, 3
    max_p = r_cni.default_max_p(d_max, n_labels)
    cd = random_counts(rng, 50, n_labels, d_max, hubs=5)
    cq = random_counts(rng, 6, n_labels, d_max, hubs=1)
    od = rng.integers(0, n_labels + 1, size=50).astype(np.int32)
    oq = rng.integers(1, n_labels + 1, size=6).astype(np.int32)
    rd = r_flt.make_digest(jnp.asarray(cd), jnp.asarray(od), d_max, max_p)
    rq = r_flt.make_digest(jnp.asarray(cq), jnp.asarray(oq), d_max, max_p)
    td = t_flt.make_digest(torch.as_tensor(cd), torch.as_tensor(od), d_max, max_p)
    tq = t_flt.make_digest(torch.as_tensor(cq), torch.as_tensor(oq), d_max, max_p)
    for r_fn, t_fn in ((r_flt.cni_match, t_flt.cni_match),
                       (r_flt.cni_match_log, t_flt.cni_match_log),
                       (r_flt.label_match, t_flt.label_match),
                       (r_flt.degree_match, t_flt.degree_match)):
        np.testing.assert_array_equal(t_fn(td, tq).numpy(), np.asarray(r_fn(rd, rq)))
    np.testing.assert_array_equal(
        t_flt.nlf_match(torch.as_tensor(cd), torch.as_tensor(cq),
                        torch.as_tensor(od), torch.as_tensor(oq)).numpy(),
        np.asarray(r_flt.nlf_match(jnp.asarray(cd), jnp.asarray(cq),
                                   jnp.asarray(od), jnp.asarray(oq))),
    )
    g, _ = seeded_graph_and_query(4, n_vertices=50, n_edges=150)
    tg = port(g)
    deg = rng.integers(0, 9, size=50).astype(np.int32)
    alive = rng.random(50) < 0.7
    np.testing.assert_array_equal(
        t_flt.mnd_values(None, torch.as_tensor(deg), tg.src, tg.dst, 50,
                         torch.as_tensor(alive)).numpy(),
        np.asarray(r_flt.mnd_values(None, jnp.asarray(deg), g.src, g.dst, 50,
                                    jnp.asarray(alive))),
    )


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_alive0", [False, True])
def test_ilgf_fixed_point(variant, seed, with_alive0):
    g, q = seeded_graph_and_query(seed, n_vertices=120, n_edges=420, n_labels=4)
    tg, tq = port(g), port(q)
    alive0 = None
    if with_alive0:
        alive0 = np.random.default_rng(seed).random(g.n_vertices) < 0.9
    want = r_ilgf(g, q, variant=variant, alive0=alive0)
    got = t_ilgf(tg, tq, variant=variant, alive0=alive0)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_array_equal(got.candidates.numpy(), np.asarray(want.candidates))
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_shot_filter(variant):
    g, q = seeded_graph_and_query(2, n_vertices=120, n_edges=420, n_labels=4)
    want = r_one_shot(g, q, variant=variant)
    got = t_one_shot(port(g), port(q), variant=variant)
    np.testing.assert_array_equal(got.alive.numpy(), np.asarray(want.alive))
    np.testing.assert_array_equal(got.candidates.numpy(), np.asarray(want.candidates))
