"""The port's cni_update (plain version on the CPU) against the JAX
reference, on the same numpy frontier rows and deltas.

* new rows and degrees against the reference's ``cni_update_ref`` and its
  Pallas ``cni_update`` in interpret mode: equal;
* log digests against both: 1e-5 absolute (XLA and PyTorch reduce the
  float32 logsumexp in different orders);
* exact digests against ``repro.core.cni.cni_from_counts`` of the new rows
  (the reference keeps them on the host): equal;
* within the port, the update equals ``cni_encode`` of the new rows bit for
  bit, which is what keeps an incremental index equal to a scratch one.

Deltas are zero (the reference index's call) or real (the port index's),
over saturated hubs, rows that drop to degree 0 and rows past d_max.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cni as r_cni
from repro.kernels.cni_update.ops import cni_update as r_cni_update
from repro.kernels.cni_update.ref import cni_update_ref as r_cni_update_ref
from repro_torch.kernels._build import _local_includes
from repro_torch.kernels.cni_encode import ops as enc_ops
from repro_torch.kernels.cni_update import ops, ref
from test_torch_cni_encode import counts_for, ref_u64

CASES = [  # (d_max, n_labels, hubs)
    (8, 3, 0),
    (64, 2, 4),
    (64, 6, 6),
    (200, 4, 3),
]


def rows_and_delta(d_max, n_labels, hubs, real: bool, n_rows=40):
    """Frontier rows and a delta that keeps every count >= 0: rows gain
    and lose neighbours, one row drops to degree 0, hubs stay saturated."""
    rows = counts_for(d_max, n_labels, hubs, n_rows=n_rows)
    rng = np.random.default_rng(d_max * 7 + n_labels)
    if not real:
        return rows, np.zeros_like(rows)
    delta = rng.integers(-2, 3, size=rows.shape).astype(np.int32)
    delta = np.maximum(delta, -rows)
    delta[-1] = -rows[-1]  # this row loses every neighbour
    return rows, delta


@pytest.mark.parametrize("real", [False, True], ids=["zero_delta", "real_delta"])
@pytest.mark.parametrize("d_max,n_labels,hubs", CASES)
def test_update_equals_reference(d_max, n_labels, hubs, real):
    rows, delta = rows_and_delta(d_max, n_labels, hubs, real)
    max_p = r_cni.default_max_p(d_max, n_labels)
    new_rows, deg, cni, cni_log = ops.cni_update(
        torch.as_tensor(rows), torch.as_tensor(delta), d_max, max_p)
    assert new_rows.dtype == deg.dtype == torch.int32
    assert cni.dtype == torch.int64 and cni_log.dtype == torch.float32
    want_rows, want_log, want_deg = r_cni_update_ref(
        jnp.asarray(rows), jnp.asarray(delta), d_max, max_p)
    np.testing.assert_array_equal(new_rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    np.testing.assert_allclose(cni_log.numpy(), np.asarray(want_log), rtol=0,
                               atol=1e-5)
    want = ref_u64(r_cni.cni_from_counts(jnp.asarray(rows + delta), d_max,
                                         max_p))
    np.testing.assert_array_equal(cni.numpy(), want)
    if real:
        assert deg[-1] == 0 and np.isneginf(cni_log[-1].item())
    if hubs:
        assert (cni[:hubs] == 1 << 62).any()  # the saturated corner is hit


@pytest.mark.parametrize("real", [False, True], ids=["zero_delta", "real_delta"])
@pytest.mark.parametrize("d_max,n_labels,hubs", CASES[:3])
def test_update_equals_pallas_kernel_in_interpret_mode(d_max, n_labels, hubs,
                                                       real):
    rows, delta = rows_and_delta(d_max, n_labels, hubs, real, n_rows=24)
    max_p = r_cni.default_max_p(d_max, n_labels)
    want_rows, want_log, want_deg = r_cni_update(
        jnp.asarray(rows), jnp.asarray(delta), d_max=d_max, max_p=max_p,
        block_f=16)
    new_rows, deg, _, cni_log = ops.cni_update(
        torch.as_tensor(rows), torch.as_tensor(delta), d_max, max_p)
    np.testing.assert_array_equal(new_rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    np.testing.assert_allclose(cni_log.numpy(), np.asarray(want_log), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("d_max,n_labels,hubs", CASES)
def test_update_equals_encode_of_new_rows_bit_for_bit(d_max, n_labels, hubs):
    rows, delta = rows_and_delta(d_max, n_labels, hubs, real=True)
    max_p = r_cni.default_max_p(d_max, n_labels)
    new_rows, *digests = ops.cni_update(torch.as_tensor(rows),
                                        torch.as_tensor(delta), d_max, max_p)
    for got, want in zip(digests, enc_ops.cni_encode(new_rows, d_max, max_p)):
        assert torch.equal(got, want)
    for got, want in zip(digests[1:], ref.cni_update_ref(
            torch.as_tensor(rows), torch.as_tensor(delta), d_max, max_p)[2:]):
        assert torch.equal(got, want)


def test_wrapper_checks_and_counts_no_plain_launch():
    z = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        ops.cni_update(z.long(), z, 8, 24)
    with pytest.raises(TypeError, match=r"\(F, L\)"):
        ops.cni_update(z[0], z[0], 8, 24)
    with pytest.raises(ValueError, match="must match"):
        ops.cni_update(z, z[:3], 8, 24)
    with pytest.raises(ValueError, match="no cni_update kernel"):
        m = torch.zeros((4, 3), dtype=torch.int32, device="meta")
        ops.cni_update(m, m, 8, 24)
    before = ops.cni_update.launches
    new_rows, deg, cni, cni_log = ops.cni_update(z[:0], z[:0], 8, 24)
    assert new_rows.shape == (0, 3) and deg.shape == cni.shape == (0,)
    ops.cni_update(z, z, 8, 24)
    assert ops.cni_update.launches == before  # the plain version is no launch
    assert ops.launch_counts() == {"cni_update": before}


def test_build_hash_covers_the_shared_row_walk(tmp_path):
    """Both kernels' sources name the one shared row-walk header, so an edit
    to it rebuilds both; headers that include each other are scanned once."""
    kernels = Path(ops.__file__).resolve().parents[1]
    shared = kernels / "common" / "cni_row.cuh"
    for src in ("cni_encode/csrc/cni_encode.cu", "cni_update/csrc/cni_update.cu"):
        assert _local_includes(kernels / src) == [shared]
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include "b.cuh"\n')
    assert sorted(p.name for p in _local_includes(tmp_path / "k.cu")) == \
        ["a.cuh", "b.cuh"]
