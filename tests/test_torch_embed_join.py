"""The embed-join entry points on the CPU (their plain versions) against the
reference's oracles ``repro.kernels.embed_join.ref`` and emit pass.

The port reads the (N, N) edge-label matrix at ``cand[c]``; the reference
takes the candidate-restricted view ``elab[:, cand]``.  Inputs are drawn
from one numpy generator and handed to both.  Everything here is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embed_join.ops import embed_join_emit as r_emit
from repro.kernels.embed_join.ref import (
    embed_join_count_ref,
    embed_join_ref,
    emit_slots_ref,
)
from repro_torch.kernels.embed_join import ops, ref


def random_level(r, t, c, n, j, seed):
    """One join level's operands as numpy arrays (port layout)."""
    rng = np.random.default_rng(seed)
    table = rng.integers(0, n, size=(r, t)).astype(np.int32)
    row_valid = rng.random(r) < 0.8
    cand = np.sort(rng.choice(n, size=min(c, n), replace=False)).astype(np.int32)
    cand = np.pad(cand, (0, c - cand.size))  # padded slots hold vertex 0
    cand_valid = np.arange(c) < min(c, n)
    cand_valid &= rng.random(c) < 0.9
    elab = np.where(rng.random((n, n)) < 0.3, rng.integers(0, 3, size=(n, n)),
                    -1).astype(np.int32)
    q_pos = rng.integers(0, t, size=j).astype(np.int32)
    q_lab = rng.integers(0, 3, size=j).astype(np.int32)
    q_valid = rng.random(j) < 0.7
    return table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid


def as_torch(args):
    return tuple(torch.as_tensor(a) for a in args)


def as_ref(args):
    """The reference's operands: elab restricted to the candidate columns."""
    table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid = args
    return tuple(map(jnp.asarray, (table, row_valid, cand, cand_valid,
                                   elab[:, cand], q_pos, q_lab, q_valid)))


SHAPES = [
    (64, 3, 32, 50, 2),     # aligned
    (100, 1, 33, 40, 1),    # ragged R and C, one column
    (37, 5, 128, 130, 4),   # C = 128 padded tail, N > C
    (301, 16, 200, 90, 3),  # T = 16 (C > N: candidate tail all padding)
]


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_and_count_match_reference(shape):
    args = random_level(*shape, seed=sum(shape))
    want = np.asarray(embed_join_ref(*as_ref(args)))
    got = ops.embed_join(*as_torch(args))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ops.embed_join_count(*as_torch(args)).numpy(),
        np.asarray(embed_join_count_ref(*as_ref(args))),
    )


def test_inert_constraint_leaves_injectivity_only():
    """A J = 1 constraint with q_valid False never constrains the join."""
    args = list(random_level(32, 2, 16, 20, 1, seed=3))
    args[7] = np.zeros(1, bool)
    got = ops.embed_join(*as_torch(args)).numpy()
    table, row_valid, cand, cand_valid = args[:4]
    inj = (table[:, :, None] != cand[None, None, :]).all(axis=1)
    np.testing.assert_array_equal(got, inj & row_valid[:, None] & cand_valid[None, :])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("row_base", [0, 100])
def test_emit_matches_reference_emit(shape, row_base):
    """Slot k holds the k-th survivor in flat row-major order, the cell id
    is offset by row_base rows, and slack slots keep their fill."""
    args = random_level(*shape, seed=sum(shape) + 1)
    grid = np.asarray(embed_join_ref(*as_ref(args)))
    counts = grid.sum(axis=1)
    row_off = np.cumsum(counts) - counts
    total = int(counts.sum())
    assert total > 0
    fill = np.full(total + 5, -7, np.int64)
    got = ops.embed_join_emit(torch.as_tensor(fill), *as_torch(args),
                              torch.as_tensor(row_off), row_base).numpy()
    want = np.asarray(r_emit(
        jnp.asarray(fill.astype(np.int32)), *as_ref(args),
        jnp.asarray(row_off.astype(np.int32)), jnp.asarray(row_base, jnp.int32),
        use_kernel=False,
    ))
    np.testing.assert_array_equal(got, want)
    ri, ci = np.nonzero(grid)
    np.testing.assert_array_equal(got[:total], (ri + row_base) * shape[2] + ci)
    np.testing.assert_array_equal(got[total:], -7)
    # the slot of each survivor is the reference's emit_slots_ref
    slots = np.asarray(emit_slots_ref(jnp.asarray(grid), jnp.asarray(row_off)))
    np.testing.assert_array_equal(np.sort(slots[grid]), np.arange(total))


def test_emit_slices_compose_into_one_buffer():
    """Two row slices, each with its slice of the global row_off and its
    row_base, fill one buffer exactly as one emit over all rows."""
    args = random_level(96, 3, 64, 70, 2, seed=11)
    t_args = as_torch(args)
    counts = ops.embed_join_count(*t_args)
    row_off = counts.cumsum(0) - counts
    total = int(counts.sum())
    whole = ops.embed_join_emit(torch.zeros(total, dtype=torch.int64), *t_args,
                                row_off, 0)
    parts = torch.zeros(total, dtype=torch.int64)
    for lo, hi in ((0, 40), (40, 96)):
        sliced = (t_args[0][lo:hi], t_args[1][lo:hi]) + t_args[2:]
        ops.embed_join_emit(parts, *sliced, row_off[lo:hi], lo)
    np.testing.assert_array_equal(parts.numpy(), whole.numpy())


def test_cpu_route_runs_plain_versions_and_counts_nothing():
    args = as_torch(random_level(64, 3, 32, 50, 2, seed=0))
    ops.reset_launches()
    grid = ops.embed_join(*args)
    np.testing.assert_array_equal(grid.numpy(), ref.embed_join_grid_ref(*args).numpy())
    ops.embed_join_count(*args)
    table, _, cand, _, elab, q_pos, q_lab, _ = args
    counts = ops.count_live(torch.empty(64, dtype=torch.int32), table, cand,
                            elab, q_pos, q_lab)
    ops.emit_table_live(torch.zeros((int(counts.sum()), 4), dtype=torch.int32),
                        table, cand, elab, q_pos, q_lab,
                        counts.cumsum(0) - counts)
    assert ops.launch_counts() == {"embed_join_grid": 0, "embed_join_count": 0,
                                   "embed_join_emit": 0,
                                   "embed_join_emit_table": 0}


@pytest.mark.parametrize("field,bad", [
    (0, lambda x: x.to(torch.int64)),       # table must be int32
    (1, lambda x: x.to(torch.int32)),       # row_valid must be bool
    (4, lambda x: x[:, :-1]),               # elab must be square
    (4, lambda x: x.t()),                   # elab must be contiguous
    (6, lambda x: x[:-1]),                  # q_lab length != q_pos length
])
def test_operand_checks_raise(field, bad):
    args = list(as_torch(random_level(16, 3, 16, 20, 2, seed=1)))
    args[field] = bad(args[field])
    with pytest.raises((TypeError, ValueError)):
        ops.embed_join_count(*args)


def test_unsupported_device_raises():
    args = as_torch(random_level(8, 2, 8, 10, 1, seed=2))
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no embed-join kernel"):
        ops.embed_join_count(*meta)
