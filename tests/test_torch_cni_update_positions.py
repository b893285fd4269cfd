"""The cni_update kernel's order in plain form
(``ref.cni_update_by_position``) against the port's plain version and the
JAX reference, on the same numpy frontier rows and deltas.

The CUDA kernel gives a row to a group of G lanes (8, 16 or 32, from L):
lane g takes positions g, g + G, ..., gathers their terms, and folds the
exact ones with the saturating add; a butterfly folds the lanes, m is the
largest log term, and the float32 sum of exp(t - m) runs in position
order.  These tests hold that order to the plain versions for d_max 0, 8,
64 and 256, L 1, 8 and 200, every lane count, saturated hubs, rows that
drop to degree 0 and rows past d_max:

* new rows, degrees and exact digests: equal;
* log digests: 1e-5 absolute, as ``test_torch_cni_update.py`` states,
  because the plain versions reduce the float32 logsumexp in another
  order;
* the saturating butterfly never forms 2^62 + 2^62: two saturated halves
  fold to exactly 1 << 62.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cni as r_cni
from repro.kernels.cni_update.ops import cni_update as r_cni_update
from repro.kernels.cni_update.ref import cni_update_ref as r_cni_update_ref
from repro_torch.core import cni as t_cni
from repro_torch.core.cni import SAT64, default_max_p
from repro_torch.kernels.cni_encode import ops as enc_ops
from repro_torch.kernels.cni_update import ops, ref
from test_torch_cni_encode import ref_u64

D_MAX = [0, 8, 64, 256]
N_LABELS = [1, 8, 200]


def frontier(d_max, n_labels, n_rows=40, hubs=3):
    """Frontier rows and a delta that keeps every count >= 0: ordinary rows
    gain and lose neighbours, ``hubs`` rows hold d_max neighbours on the top
    labels (gains only), one row past d_max, and every seventh row emptied
    by its delta."""
    rng = np.random.default_rng(d_max * 31 + n_labels)
    top = max(d_max, 4)
    rows = np.stack([rng.multinomial(rng.integers(0, top + 1),
                                     np.ones(n_labels) / n_labels)
                     for _ in range(n_rows)]).astype(np.int32)
    rows[:hubs] = 0
    rows[:hubs, -1] = d_max - d_max // 2
    rows[:hubs, max(n_labels - 2, 0)] += d_max // 2
    rows[hubs, -1] = d_max + 5  # past d_max on the top label
    delta = np.maximum(rng.integers(-2, 3, size=rows.shape), -rows)
    delta[:hubs] = np.abs(delta[:hubs])
    delta[hubs + 1::7] = -rows[hubs + 1::7]
    return rows, delta.astype(np.int32)


def update_by_position(rows, delta, d_max, max_p, lanes=None):
    return ref.cni_update_by_position(torch.as_tensor(rows),
                                      torch.as_tensor(delta), d_max, max_p,
                                      lanes)


@pytest.mark.parametrize("lanes", [None, 8, 16, 32])
@pytest.mark.parametrize("n_labels", N_LABELS)
@pytest.mark.parametrize("d_max", D_MAX)
def test_by_position_equals_plain_version(d_max, n_labels, lanes):
    rows, delta = frontier(d_max, n_labels)
    max_p = default_max_p(d_max, n_labels)
    got = update_by_position(rows, delta, d_max, max_p, lanes)
    want = ops.cni_update(torch.as_tensor(rows), torch.as_tensor(delta),
                          d_max, max_p)
    for name, g, w in zip(("new_rows", "deg", "cni"), got[:3], want[:3]):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert got[3].dtype == torch.float32
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-5)
    deg, cni, log = got[1:]
    zero = deg == 0
    assert bool(zero.any()) and bool(torch.isneginf(log[zero]).all())
    assert bool((cni[zero] == 0).all())
    assert int(deg[3]) > d_max  # the row past d_max
    if d_max >= 64 and n_labels > 1:
        assert bool((cni[:3] == SAT64).all())  # the saturated hubs


@pytest.mark.parametrize("n_labels", N_LABELS)
@pytest.mark.parametrize("d_max", D_MAX[1:])
def test_by_position_equals_jax_reference(d_max, n_labels):
    rows, delta = frontier(d_max, n_labels)
    max_p = default_max_p(d_max, n_labels)
    new_rows, deg, cni, log = update_by_position(rows, delta, d_max, max_p)
    want_rows, want_log, want_deg = r_cni_update_ref(
        jnp.asarray(rows), jnp.asarray(delta), d_max, max_p)
    np.testing.assert_array_equal(new_rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    np.testing.assert_allclose(log.numpy(), np.asarray(want_log), rtol=0,
                               atol=1e-5)
    want = ref_u64(r_cni.cni_from_counts(jnp.asarray(rows + delta), d_max,
                                         max_p))
    np.testing.assert_array_equal(cni.numpy(), want)


@pytest.mark.parametrize("d_max,n_labels", [(8, 1), (8, 8), (64, 1), (64, 8)])
def test_by_position_equals_pallas_kernel_in_interpret_mode(d_max, n_labels):
    rows, delta = frontier(d_max, n_labels, n_rows=24)
    max_p = default_max_p(d_max, n_labels)
    want_rows, want_log, want_deg = r_cni_update(
        jnp.asarray(rows), jnp.asarray(delta), d_max=d_max, max_p=max_p,
        block_f=16)
    new_rows, deg, _, log = update_by_position(rows, delta, d_max, max_p)
    np.testing.assert_array_equal(new_rows.numpy(), np.asarray(want_rows))
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    np.testing.assert_allclose(log.numpy(), np.asarray(want_log), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("d_max,n_labels", [(8, 8), (64, 200), (256, 8)])
def test_by_position_exact_digest_equals_cni_encode(d_max, n_labels):
    """The kernel's exact digest and degree equal ``cni_encode``'s of the
    new rows (the log digest, summed in the same position order on the
    card, is held bit for bit there)."""
    rows, delta = frontier(d_max, n_labels)
    max_p = default_max_p(d_max, n_labels)
    new_rows, deg, cni, _ = update_by_position(rows, delta, d_max, max_p)
    deg_e, cni_e, _ = enc_ops.cni_encode(new_rows, d_max, max_p)
    assert torch.equal(deg, deg_e) and torch.equal(cni, cni_e)


@pytest.mark.parametrize("lanes", [8, 16, 32])
def test_saturated_halves_fold_to_exactly_sat64(lanes):
    """Two saturated halves of a row's lanes fold to 1 << 62: the butterfly
    adds ``min(b, SAT64 - a)``, never a raw a + b, which would wrap."""
    full = np.full(lanes, SAT64, dtype=np.int64)
    with np.errstate(over="ignore"):
        assert full[0] + full[1] < 0  # the raw sum wraps int64
    assert ref.sat_tree(full) == SAT64
    half = full.copy()
    half[lanes // 2:] = 0
    assert ref.sat_tree(half) == SAT64
    rng = np.random.default_rng(lanes)
    small = rng.integers(0, 1 << 40, size=(5, lanes))
    np.testing.assert_array_equal(ref.sat_tree(small), small.sum(1))
    big = np.array([[SAT64 - 1] + [1] * (lanes - 1)], dtype=np.int64)
    assert ref.sat_tree(big)[0] == SAT64


def test_saturated_row_folds_to_exactly_sat64():
    """A hub row whose every lane saturates: the kernel's order gives
    exactly 1 << 62 at each lane count, as the plain version does."""
    d_max, n_labels = 256, 200
    rows = np.zeros((2, n_labels), np.int32)
    rows[:, -1] = d_max  # every lane's terms sit at SAT64
    delta = np.zeros_like(rows)
    max_p = default_max_p(d_max, n_labels)
    for lanes in (8, 16, 32):
        _, _, cni, _ = update_by_position(rows, delta, d_max, max_p, lanes)
        assert cni.tolist() == [SAT64, SAT64]


def test_plan_lanes_follows_n_labels():
    assert [ref.plan_lanes(n) for n in (1, 8, 9, 44, 200, 2048, 2049)] == \
        [8, 8, 16, 16, 16, 16, 32]


@pytest.mark.parametrize("d_max,n_labels", [(0, 1), (8, 8), (64, 200)])
def test_term_table_packs_both_terms(d_max, n_labels):
    """The kernel's table holds each index's Pascal term (two int32 halves,
    low first) and the bits of its log term, side by side."""
    max_p = default_max_p(d_max, n_labels)
    table = ops.term_table(d_max, max_p, torch.device("cpu"))
    pascal = t_cni._pascal_table(d_max, max_p, torch.device("cpu")).reshape(-1)
    log_t = t_cni._log_hbar(d_max, max_p, torch.device("cpu")).reshape(-1)
    assert table.dtype == torch.int32 and table.shape == (pascal.numel(), 4)
    lo = table[:, 0].long() & 0xFFFFFFFF
    assert torch.equal((table[:, 1].long() << 32) | lo, pascal)
    assert torch.equal(table[:, 2].view(torch.float32).view(torch.int32),
                       log_t.view(torch.int32))
    assert not bool(table[:, 3].any())
