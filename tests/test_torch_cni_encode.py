"""The port's cni_encode (plain version on the CPU) against the JAX
reference, on the same numpy count rows.

* exact digests against ``repro.core.cni.cni_from_counts`` (two uint32
  limbs joined with ``limb_to_u64_np``): equal;
* log digests against ``cni_log_from_counts`` and against the reference's
  Pallas ``cni_encode`` run in interpret mode: 1e-5 absolute, because XLA
  and PyTorch reduce the float32 logsumexp in different orders;
* the host twin ``cni_from_counts_np`` against the reference's: equal.

The corners are those of ``test_torch_filters.py``: saturated hubs, long
rows whose terms sit at SAT64, rows of degree 0, and rows whose degree
exceeds d_max (a query row's can).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cni as r_cni
from repro.kernels.cni_encode.ops import cni_encode as r_cni_encode
from repro_torch.core import cni as t_cni
from repro_torch.kernels.cni_encode import ops, ref
from test_torch_filters import random_counts

CASES = [  # (d_max, n_labels, hubs)
    (8, 3, 0),      # small, far below saturation
    (64, 2, 4),     # the saturated star-centre regime
    (64, 6, 6),     # saturated hubs among ordinary rows, more labels
    (200, 4, 3),    # long rows: many terms at SAT64 (int64 overflow bait)
]


def counts_for(d_max, n_labels, hubs, n_rows=40):
    rng = np.random.default_rng(d_max + n_labels + 17)
    counts = random_counts(rng, n_rows, n_labels, d_max, hubs=hubs)
    counts[hubs] = 0                     # a row of degree 0
    counts[hubs + 1, 0] = d_max + 3      # degree past d_max
    return counts


def ref_u64(cni_value) -> np.ndarray:
    return r_cni.limb_to_u64_np(cni_value.hi, cni_value.lo).astype(np.int64)


@pytest.mark.parametrize("d_max,n_labels,hubs", CASES)
def test_encode_equals_reference_digests(d_max, n_labels, hubs):
    counts = counts_for(d_max, n_labels, hubs)
    max_p = r_cni.default_max_p(d_max, n_labels)
    deg, cni, cni_log = ops.cni_encode(torch.as_tensor(counts), d_max, max_p)
    assert deg.dtype == torch.int32 and cni.dtype == torch.int64
    assert cni_log.dtype == torch.float32
    np.testing.assert_array_equal(deg.numpy(), counts.sum(1))
    want = ref_u64(r_cni.cni_from_counts(jnp.asarray(counts), d_max, max_p))
    np.testing.assert_array_equal(cni.numpy(), want)
    want_log = np.asarray(r_cni.cni_log_from_counts(jnp.asarray(counts), d_max,
                                                    max_p))
    np.testing.assert_allclose(cni_log.numpy(), want_log, rtol=0, atol=1e-5)
    assert cni[hubs] == 0 and np.isneginf(cni_log[hubs].item())
    if hubs:
        assert (want[:hubs] == t_cni.SAT64).all()  # the corner is hit


@pytest.mark.parametrize("d_max,n_labels,hubs", CASES)
def test_encode_equals_pallas_kernel_in_interpret_mode(d_max, n_labels, hubs):
    counts = counts_for(d_max, n_labels, hubs, n_rows=24)
    max_p = r_cni.default_max_p(d_max, n_labels)
    want_log, want_deg = r_cni_encode(jnp.asarray(counts), d_max=d_max,
                                      max_p=max_p, block_v=8)
    deg, _, cni_log = ops.cni_encode(torch.as_tensor(counts), d_max, max_p)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    np.testing.assert_allclose(cni_log.numpy(), np.asarray(want_log), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("d_max,n_labels,hubs", CASES)
def test_host_twin_equals_reference(d_max, n_labels, hubs):
    counts = counts_for(d_max, n_labels, hubs)
    max_p = r_cni.default_max_p(d_max, n_labels)
    want = r_cni.cni_from_counts_np(counts, d_max, max_p)
    got = t_cni.cni_from_counts_np(counts, d_max, max_p)
    assert got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0].astype(np.int64))
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    # and the host twin agrees with the device encode's plain version
    _, cni, _ = ref.cni_encode_ref(torch.as_tensor(counts), d_max, max_p)
    np.testing.assert_array_equal(got[0], cni.numpy())


def test_leading_batch_is_row_wise():
    counts = counts_for(64, 3, 2, n_rows=60)
    max_p = r_cni.default_max_p(64, 3)
    flat = ops.cni_encode(torch.as_tensor(counts), 64, max_p)
    batched = ops.cni_encode(torch.as_tensor(counts.reshape(3, 20, 3)), 64,
                             max_p)
    for f, b in zip(flat, batched):
        assert b.shape == (3, 20)
        torch.testing.assert_close(b.reshape(-1), f, rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="int32"):
        ops.cni_encode(torch.zeros((4, 3), dtype=torch.int64), 8, 24)
    with pytest.raises(ValueError, match="no cni_encode kernel"):
        ops.cni_encode(torch.zeros((4, 3), dtype=torch.int32, device="meta"),
                       8, 24)
    before = ops.cni_encode.launches
    ops.cni_encode(torch.zeros((4, 3), dtype=torch.int32), 8, 24)
    assert ops.cni_encode.launches == before  # the plain version is no launch
