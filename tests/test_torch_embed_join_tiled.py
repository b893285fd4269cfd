"""The count and emit kernels' algorithm in its plain form
(``ref.embed_join_count_tiled`` / ``ref.embed_join_emit_tiled``) against
the port's plain versions and the reference's count and emit pass, on the
same numpy inputs.  Everything here is exact.

The CUDA kernels give a block ``rows`` consecutive rows and split the
candidate list over its warps: per pass, warp w takes 32 * K candidates, a
lane K of them 32 apart, one ballot each.  The count kernel sums each
warp's ballots and folds the warps in order.  The emit kernel keeps a
window of passes' ballot words in shared memory, in candidate order, and a
warp per row scans them 32 words at a time: a survivor's slot is its row's
offset plus what earlier windows and words hold plus the set lanes below
its own.  These tests hold that order to the flat row-major order for
several (warps, K, rows, window) choices, candidate lists that end inside
a ballot, a warp or a pass, and more than one pass and window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embed_join.ops import embed_join_emit as r_emit
from repro.kernels.embed_join.ref import embed_join_count_ref as r_count
from repro_torch.kernels.embed_join import ref

from test_torch_embed_join import as_ref, as_torch, random_level

# (warps, K, rows, window): the launch shapes the kernels pick, and others
CONFIGS = [(4, 1, 1, 2), (8, 1, 3, 1), (5, 2, 1, 2), (8, 4, 8, 2), (8, 8, 16, 1),
           (4, 8, 2, 2), (8, 4, 4, 3)]

SHAPES = [  # (R, T, C, N, J), seed: every level has survivors
    ((40, 3, 100, 120, 2), 0),    # C ends inside a ballot
    ((37, 5, 1100, 1200, 3), 1),  # one pass of (8, 4), three of (4, 1)
    ((19, 16, 300, 90, 2), 4),    # T = 16, C > N: tail all padding
    ((1, 2, 2100, 2200, 1), 0),   # one row, two passes (and windows) at (8, 8)
]


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES)
def test_tiled_emit_matches_plain_and_reference(shape, config):
    warps, k, rows, window = config
    shape, seed = shape
    args = random_level(*shape, seed=sum(shape) + seed)
    counts = np.asarray(r_count(*as_ref(args)))
    row_off = np.cumsum(counts) - counts
    total = int(counts.sum())
    assert total > 0
    row_base = 3
    fill = np.full(total + 5, -7, np.int64)
    t_args = as_torch(args)
    got = ref.embed_join_emit_tiled(
        torch.tensor(fill), *t_args, torch.as_tensor(row_off), row_base,
        warps=warps, k=k, rows=rows, window=window).numpy()
    plain = ref.embed_join_emit_ref(torch.tensor(fill), *t_args,
                                    torch.as_tensor(row_off), row_base).numpy()
    want = np.asarray(r_emit(
        jnp.asarray(fill.astype(np.int32)), *as_ref(args),
        jnp.asarray(row_off.astype(np.int32)), jnp.asarray(row_base, jnp.int32),
        use_kernel=False,
    ))
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_array_equal(got, want)
    assert (fill == -7).all()  # each version wrote its own copy
    np.testing.assert_array_equal(
        ref.embed_join_count_tiled(*t_args, warps=warps, k=k, rows=rows).numpy(),
        counts)


@pytest.mark.parametrize("config", CONFIGS)
def test_tiled_emit_drops_slots_past_the_buffer(config):
    """A buffer shorter than the total keeps the first survivors in order
    and drops the rest, as the plain version does."""
    warps, k, rows, window = config
    args = as_torch(random_level(50, 3, 700, 800, 2, seed=21))
    counts = ref.embed_join_count_ref(*args)
    row_off = counts.cumsum(0) - counts
    cap = int(counts.sum()) // 2
    got = ref.embed_join_emit_tiled(torch.full((cap,), -7), *args, row_off,
                                    0, warps=warps, k=k, rows=rows,
                                    window=window)
    want = ref.embed_join_emit_ref(torch.full((cap,), -7), *args, row_off, 0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tiled_count_with_dead_rows_and_inert_constraints():
    """Dead rows count 0 and an inert constraint leaves injectivity only,
    under every configuration."""
    table, row_valid, *rest = random_level(64, 4, 333, 400, 2, seed=5)
    row_valid = row_valid.copy()
    row_valid[10:30] = False
    rest[-1] = np.zeros(2, bool)
    args = as_torch((table, row_valid, *rest))
    want = ref.embed_join_count_ref(*args)
    assert int(want[10:30].abs().sum()) == 0
    for warps, k, rows, _ in CONFIGS:
        got = ref.embed_join_count_tiled(*args, warps=warps, k=k, rows=rows)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
