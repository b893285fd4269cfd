"""The port's candidate_filter (plain version on the CPU) against the JAX
reference, on the same digests.

Digests come from the reference's host encode ``cni_from_counts_np`` on
seeded numpy counts (split into uint32 limbs for the reference, int64 for
the port), so both sides compare the same values:

* exact mode against ``repro.core.filters.cni_match``: equal;
* log mode against ``cni_match_log``: equal;
* log mode against the reference's Pallas ``candidate_filter`` in interpret
  mode, on unsaturated digests: equal.  On saturated digests the Pallas
  kernel lacks the ``LOG_SAT64`` pass-through of ``cni_match_log``; the
  port follows ``cni_match_log``, and the grids differ exactly at the cells
  that pass-through admits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cni as r_cni
from repro.core import filters as r_flt
from repro.kernels.candidate_filter.ops import candidate_filter as r_candidate_filter
from repro_torch.kernels.candidate_filter import ops, ref
from test_torch_filters import random_counts


def digests(seed, lead, n_data, n_query, n_labels, d_max, *, hubs=0,
            deg_cap=None):
    """Reference digests of seeded counts: data (*lead, V), query (*lead, U);
    row degrees at most ``deg_cap`` (default d_max) apart from the hubs."""
    rng = np.random.default_rng(seed)
    max_p = r_cni.default_max_p(d_max, n_labels)
    b = int(np.prod(lead)) if lead else 1

    def side(n, ords_lo, n_hubs):
        counts = np.stack([
            random_counts(rng, n, n_labels, deg_cap or d_max, hubs=n_hubs)
            for _ in range(b)]).reshape(lead + (n, n_labels))
        ords = rng.integers(ords_lo, n_labels + 1,
                            size=lead + (n,)).astype(np.int32)
        u64, cni_log, deg = r_cni.cni_from_counts_np(
            counts.reshape(-1, n_labels), d_max, max_p)
        return r_flt.VertexDigest(
            ord_label=jnp.asarray(ords),
            deg=jnp.asarray(deg.reshape(lead + (n,))),
            cni=r_cni.CniValue(
                hi=jnp.asarray((u64 >> np.uint64(32)).astype(np.uint32)
                               .reshape(lead + (n,))),
                lo=jnp.asarray((u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
                               .reshape(lead + (n,)))),
            cni_log=jnp.asarray(cni_log.reshape(lead + (n,))),
        )

    return side(n_data, 0, hubs), side(n_query, 1, min(hubs, 1))


def port_args(digest, mode):
    cni = (r_cni.limb_to_u64_np(digest.cni.hi, digest.cni.lo).astype(np.int64)
           if mode == "exact" else np.asarray(digest.cni_log))
    return [torch.as_tensor(np.array(x)) for x in
            (digest.ord_label, digest.deg, cni)]


def port_grid(data, query, mode):
    return ops.candidate_filter(*port_args(data, mode), *port_args(query, mode),
                                mode=mode).numpy()


CASES = [  # (seed, lead, V, U, n_labels, d_max, hubs)
    (0, (), 60, 6, 3, 8, 0),
    (1, (), 50, 5, 2, 64, 5),
    (2, (3,), 40, 8, 3, 64, 4),
    (3, (), 45, 4, 4, 200, 3),
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", ["exact", "log"])
def test_grid_equals_reference_match(case, mode):
    seed, lead, v, u, n_labels, d_max, hubs = case
    data, query = digests(seed, lead, v, u, n_labels, d_max, hubs=hubs)
    fn = r_flt.cni_match if mode == "exact" else r_flt.cni_match_log
    want = np.asarray(fn(data, query))
    got = port_grid(data, query, mode)
    assert got.shape == lead + (v, u)
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()  # the grid is not trivial


@pytest.mark.parametrize("seed,d_max", [(0, 8), (1, 64), (3, 200)])
def test_log_grid_equals_pallas_kernel_on_unsaturated_digests(seed, d_max):
    data, query = digests(seed, (), 48, 6, 4, d_max, deg_cap=8)
    for d in (data, query):
        assert (np.asarray(d.cni_log) < r_flt._LOG_SAT_THRESH).all()
    want = np.asarray(r_candidate_filter(
        data.ord_label, data.deg, data.cni_log,
        query.ord_label, query.deg, query.cni_log, block_v=16))
    np.testing.assert_array_equal(port_grid(data, query, "log"), want)
    assert want.any()


def test_pallas_kernel_differs_exactly_at_the_saturation_pass_through():
    """ROADMAP C3: on saturated rows the port's log grid admits the cells
    that the pass-through admits and the Pallas kernel does not; every other
    cell agrees."""
    data, query = digests(7, (), 60, 6, 2, 64, hubs=8)
    got = port_grid(data, query, "log")
    pallas = np.asarray(r_candidate_filter(
        data.ord_label, data.deg, data.cni_log,
        query.ord_label, query.deg, query.cni_log, block_v=16))
    cv = np.asarray(data.cni_log)[:, None]
    cu = np.asarray(query.cni_log)[None, :]
    dv = np.asarray(data.deg)[:, None]
    du = np.asarray(query.deg)[None, :]
    od = np.asarray(data.ord_label)[:, None]
    lab = (od == np.asarray(query.ord_label)[None, :]) & (od > 0)
    sat = (cv >= ref.LOG_SAT_THRESH) | (cu >= ref.LOG_SAT_THRESH)
    admitted_by_sat_only = lab & sat & (dv >= du) & ~pallas
    assert admitted_by_sat_only.any()  # the corner is hit
    np.testing.assert_array_equal(got != pallas, admitted_by_sat_only)
    assert not (pallas & ~got).any()  # the port only ever admits more


def test_wrapper_rejects_what_the_kernel_does_not_take():
    data, query = digests(0, (), 10, 3, 3, 8)
    d_args, q_args = port_args(data, "exact"), port_args(query, "exact")
    with pytest.raises(ValueError, match="mode"):
        ops.candidate_filter(*d_args, *q_args, mode="fuzzy")
    with pytest.raises(TypeError, match="cni_d"):
        ops.candidate_filter(*d_args, *q_args, mode="log")
    with pytest.raises(ValueError, match="leading shape"):
        ops.candidate_filter(*(x[None] for x in d_args), *q_args)
    with pytest.raises(ValueError, match="no candidate_filter kernel"):
        ops.candidate_filter(*(x.to("meta") for x in d_args),
                             *(x.to("meta") for x in q_args))
    before = ops.candidate_filter.launches
    ops.candidate_filter(*d_args, *q_args)
    assert ops.candidate_filter.launches == before  # the plain version is no launch
