"""Plain PyTorch version of the cni_encode kernel.

For (N, L) int32 count rows (``counts[n, l]`` = multiplicity of ord value
l+1) it returns ``(deg (N,) int32, cni (N,) int64, cni_log (N,) float32)``:
the label degree, the exact saturating digest and the float32 log digest
of ``core/cni.py``.  This is ``filters.make_digest`` without ``ord_label``.
It runs on any device: the CPU tests use it, and the card compares the
kernel with it.
"""

from __future__ import annotations

import torch

from repro_torch.core import cni as cni_mod


def cni_encode_ref(counts: torch.Tensor, d_max: int, max_p: int):
    """(N, L) int32 -> (deg (N,) int32, cni (N,) int64, cni_log (N,) f32)."""
    return (
        counts.sum(-1).to(torch.int32),
        cni_mod.cni_from_counts(counts, d_max, max_p),
        cni_mod.cni_log_from_counts(counts, d_max, max_p),
    )
