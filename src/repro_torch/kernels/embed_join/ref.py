"""Plain PyTorch versions of the three embed-join kernels.

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
the card compares each kernel with them.
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
