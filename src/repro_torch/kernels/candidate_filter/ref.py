"""Plain PyTorch version of the candidate_filter kernel: the corrected
cniMatch grid (the bodies of ``core/filters.py``'s ``cni_match`` and
``cni_match_log``) on raw digest tensors.

Data digests (..., V) against query digests (..., U) give a (..., V, U)
bool grid.  ``exact`` compares int64 digests with the ``== SAT64``
pass-through; ``log`` compares float32 log digests with an ε tolerance and
the ``LOG_SAT_THRESH`` pass-through.  It runs on any device: the CPU tests
use it, and the card compares the kernel with it.
"""

from __future__ import annotations

import torch

from repro_torch.core.cni import LOG_SAT64, SAT64

# unsaturated rows within this margin of LOG_SAT64 are also treated as
# saturated — pass-through is monotone-weaker, hence always sound
LOG_SAT_THRESH = LOG_SAT64 - 1e-3


def candidate_filter_ref(ord_d, deg_d, cni_d, ord_q, deg_q, cni_q, *,
                         mode: str = "exact", eps: float = 1e-4) -> torch.Tensor:
    """(..., V, U) bool cniMatch grid."""
    dl = ord_d[..., :, None]
    lab = (dl == ord_q[..., None, :]) & (dl > 0)
    dv = deg_d[..., :, None]
    du = deg_q[..., None, :]
    cv = cni_d[..., :, None]
    cu = cni_q[..., None, :]
    if mode == "exact":
        sat = (cv == SAT64) | (cu == SAT64)
        strict = (dv > du) & ((cv >= cu) | sat)
        equal = (dv == du) & ((cv == cu) | sat)
        return lab & (strict | equal)
    tol = eps * cu.abs().clamp_min(1.0)
    ge = cv >= cu - tol
    eq = (cv - cu).abs() <= tol
    sat = (cv >= LOG_SAT_THRESH) | (cu >= LOG_SAT_THRESH)
    both_empty = (dv == 0) & (du == 0)
    strict = (dv > du) & (ge | sat)
    equal = (dv == du) & (eq | both_empty | sat)
    return lab & (strict | equal)
