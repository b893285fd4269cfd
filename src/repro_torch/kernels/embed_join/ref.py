"""Plain PyTorch versions of the embed-join kernels.

One BFS-join expansion asks, for every (partial-embedding row r, candidate
c) pair, whether appending ``cand[c]`` to row r is still a valid partial
embedding:

    row_valid[r] ∧ cand_valid[c]
      ∧ ∀ j < J with q_valid[j]: elab[table[r, q_pos[j]], cand[c]] == q_lab[j]
      ∧ ∀ t < T: table[r, t] != cand[c]

``elab`` is the (N, N) dense edge-label matrix of the filtered data graph
(−1 = no edge).  The reference passes the candidate-restricted view
``elab[:, cand]`` instead; indexing ``elab`` at ``cand[c]`` is the same
function.  These versions run on any device: the CPU tests use them, and
the card compares each kernel with them.  ``embed_join_emit_table_ref``
is the plain version of the emit kernel's next-table variant.
``embed_join_count_tiled`` and ``embed_join_emit_tiled`` are for the tests
only: they compute counts and slots in the order the count and emit
kernels do.
"""

from __future__ import annotations

import torch


def embed_join_grid_ref(table, row_valid, cand, cand_valid, elab,
                        q_pos, q_lab, q_valid) -> torch.Tensor:
    """(R, C) bool validity grid."""
    mapped = table[:, q_pos.long()].long()                       # (R, J)
    got = elab[mapped[:, :, None], cand.long()[None, None, :]]   # (R, J, C)
    lab_ok = (got == q_lab[None, :, None]) | ~q_valid[None, :, None]
    adj_ok = lab_ok.all(1)                                       # (R, C)
    inj_ok = (table[:, :, None] != cand[None, None, :]).all(1)
    return adj_ok & inj_ok & row_valid[:, None] & cand_valid[None, :]


def embed_join_count_ref(table, row_valid, cand, cand_valid, elab,
                         q_pos, q_lab, q_valid) -> torch.Tensor:
    """(R,) int32 per-row survivor counts — the row sums of the grid."""
    grid = embed_join_grid_ref(table, row_valid, cand, cand_valid, elab,
                               q_pos, q_lab, q_valid)
    return grid.sum(1, dtype=torch.int32)


def embed_join_emit_ref(idx_map, table, row_valid, cand, cand_valid, elab,
                        q_pos, q_lab, q_valid, row_off, row_base) -> torch.Tensor:
    """Scatter each survivor's flat cell id into its output slot, in place.

    Survivor (r, c) lands at ``row_off[r] + |{c' < c : valid[r, c']}|`` —
    with ``row_off`` the exclusive scan of the counts, the flat row-major
    survivor order — and holds ``(row_base + r) * C + c``.  Invalid cells,
    and slots past the end of ``idx_map``, are dropped; other slots keep
    their contents.  Returns ``idx_map``.
    """
    grid = embed_join_grid_ref(table, row_valid, cand, cand_valid, elab,
                               q_pos, q_lab, q_valid)
    r, c = grid.shape
    vi = grid.to(torch.int64)
    slots = row_off.to(torch.int64)[:, None] + vi.cumsum(1) - vi
    rows = int(row_base) + torch.arange(r, device=grid.device, dtype=torch.int64)
    cells = rows[:, None] * c + torch.arange(c, device=grid.device)[None, :]
    keep = grid & (slots < idx_map.shape[0])
    idx_map[slots[keep]] = cells[keep]
    return idx_map


def embed_join_emit_table_ref(out, table, row_valid, cand, cand_valid, elab,
                              q_pos, q_lab, q_valid, row_off) -> torch.Tensor:
    """The emit pass that writes the next table: survivor (r, c) lands at
    row ``row_off[r] + |{c' < c : valid[r, c']}|`` of ``out`` ((cap, T + 1)
    int32), the slot ``embed_join_emit_ref`` gives its cell id, and holds
    ``[*table[r], cand[c]]``: the row the cell id decodes to.  Slots past
    ``cap`` are dropped; other rows keep their contents.  Returns ``out``.
    """
    grid = embed_join_grid_ref(table, row_valid, cand, cand_valid, elab,
                               q_pos, q_lab, q_valid)
    vi = grid.to(torch.int64)
    slots = row_off.to(torch.int64)[:, None] + vi.cumsum(1) - vi
    keep = grid & (slots < out.shape[0])
    r_idx, c_idx = torch.nonzero(keep, as_tuple=True)
    out[slots[keep]] = torch.cat([table[r_idx], cand[c_idx][:, None]], dim=1)
    return out


WARP = 32


def _lane_bits(grid, warps: int, k: int):
    """The grid as the kernels' ballot words: (R, Q, 32) with word q =
    pass * warps * k + warp * k + kk holding candidates 32 q + lane, so the
    words of a row run in candidate order; the tail past C is 0."""
    r, c = grid.shape
    per_pass = warps * WARP * k
    passes = max(1, -(-c // per_pass))
    bits = torch.zeros((r, passes * per_pass), dtype=torch.int64,
                       device=grid.device)
    bits[:, :c] = grid
    return bits.view(r, passes * warps * k, WARP), passes


def _count_tiled(grid, warps: int, k: int):
    """Per-row counts as the count kernel sums them: each warp's ballots
    over its passes, then the warps folded in warp order."""
    words, passes = _lane_bits(grid, warps, k)
    per_warp = words.view(grid.shape[0], passes, warps, k, WARP).sum((1, 3, 4))
    return per_warp.sum(1)


def _emit_ranks(grid, warps: int, k: int, window: int):
    """Each cell's in-row rank as the emit kernel forms it.  A window of
    ``window`` passes holds a row's ballot words in shared memory; a warp
    scans them 32 words at a time (exclusive sum of their popcounts, plus
    what earlier windows and word groups wrote), and a set lane's rank adds
    the set lanes below it in its word."""
    words, passes = _lane_bits(grid, warps, k)
    popc = words.sum(2)                                  # (R, Q)
    below = words.cumsum(2) - words                      # lanes below
    rank = torch.empty_like(words)
    done = torch.zeros(grid.shape[0], dtype=torch.int64, device=grid.device)
    per_pass = warps * k                                 # words a pass
    for p0 in range(0, passes, window):
        hi = min(passes, p0 + window) * per_pass
        for q0 in range(p0 * per_pass, hi, WARP):
            seg = popc[:, q0:min(q0 + WARP, hi)]
            first = done[:, None] + seg.cumsum(1) - seg
            rank[:, q0:q0 + seg.shape[1]] = first[..., None] + below[:, q0:q0 + seg.shape[1]]
            done += seg.sum(1)
    return rank.view(grid.shape[0], -1)[:, :grid.shape[1]]


def _tiled_blocks(args, rows: int):
    """The grid of each block of ``rows`` consecutive rows, with its first
    row: the kernels' blocks are independent of each other."""
    table, row_valid, *rest = args
    for r0 in range(0, table.shape[0], rows):
        yield r0, embed_join_grid_ref(table[r0:r0 + rows],
                                      row_valid[r0:r0 + rows], *rest)


def embed_join_count_tiled(table, row_valid, cand, cand_valid, elab, q_pos,
                           q_lab, q_valid, *, warps: int, k: int,
                           rows: int) -> torch.Tensor:
    """``embed_join_count_ref`` summed as the count kernel sums, block by
    block of ``rows`` rows (``_count_tiled``)."""
    args = (table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid)
    return torch.cat([_count_tiled(grid, warps, k).to(torch.int32)
                      for _, grid in _tiled_blocks(args, rows)])


def embed_join_emit_tiled(idx_map, table, row_valid, cand, cand_valid, elab,
                          q_pos, q_lab, q_valid, row_off, row_base, *,
                          warps: int, k: int, rows: int,
                          window: int) -> torch.Tensor:
    """``embed_join_emit_ref`` with each survivor's slot formed as the emit
    kernel forms it (``_emit_ranks``), block by block.  Returns
    ``idx_map``, updated in place."""
    args = (table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid)
    c = cand.shape[0]
    cap = idx_map.shape[0]
    for r0, grid in _tiled_blocks(args, rows):
        rank = _emit_ranks(grid, warps, k, window)
        slots = row_off[r0:r0 + grid.shape[0]].to(torch.int64)[:, None] + rank
        ids = torch.arange(grid.shape[0], device=grid.device) + int(row_base) + r0
        cells = ids[:, None] * c + torch.arange(c, device=grid.device)[None, :]
        keep = grid & (slots < cap)
        idx_map[slots[keep]] = cells[keep]
    return idx_map
