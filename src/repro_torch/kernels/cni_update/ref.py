"""Plain PyTorch version of the cni_update kernel.

For frontier count rows and their deltas, both (F, L) int32, it returns
``(new_rows (F, L) int32, deg (F,) int32, cni (F,) int64, cni_log (F,)
float32)``: ``rows + delta``, then the label degree, the exact saturating
digest and the float32 log digest of ``core/cni.py`` of the new rows.  It
runs on any device: the CPU tests use it, and the card compares the
kernel with it.
"""

from __future__ import annotations

import torch

from repro_torch.core import cni as cni_mod


def cni_update_ref(rows: torch.Tensor, delta: torch.Tensor, d_max: int,
                   max_p: int):
    """(F, L) int32 rows and deltas -> (new_rows, deg, cni, cni_log)."""
    new_rows = rows + delta
    return (
        new_rows,
        new_rows.sum(-1).to(torch.int32),
        cni_mod.cni_from_counts(new_rows, d_max, max_p),
        cni_mod.cni_log_from_counts(new_rows, d_max, max_p),
    )
