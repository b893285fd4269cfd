"""Plain PyTorch version of the cni_update kernel, and the kernel's order
in plain form.

``cni_update_ref``: for frontier count rows and their deltas, both (F, L)
int32, it returns ``(new_rows (F, L) int32, deg (F,) int32, cni (F,) int64,
cni_log (F,) float32)``: ``rows + delta``, then the label degree, the exact
saturating digest and the float32 log digest of ``core/cni.py`` of the new
rows.  It runs on any device: the CPU tests use it, and the card compares
the kernel with it.

``cni_update_by_position``: the same outputs formed as the CUDA kernel
forms them, so the CPU tests can hold the kernel's order to both packages.
"""

from __future__ import annotations

import numpy as np
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


def plan_lanes(n_labels: int) -> int:
    """Lanes the kernel gives a row (``plan_lanes`` in
    ``csrc/cni_update.cu``): 8 up to 8 labels, 16 above, and a warp's 32
    for a row longer than a warp's 2048-int tile."""
    return 32 if n_labels > 2048 else 8 if n_labels <= 8 else 16


def sat_tree(acc: np.ndarray) -> np.ndarray:
    """Fold (..., G) lane sums in [0, SAT64] as the kernel's butterfly
    does: lane g takes ``sat_add(a[g], a[g ^ d])`` for d = G/2, ..., 1,
    with ``sat_add(a, b) = a + min(b, SAT64 - a)``, which never forms a raw
    a + b (2^62 + 2^62 overflows int64).  Returns lane 0's value."""
    acc = np.asarray(acc, dtype=np.int64)
    lane = np.arange(acc.shape[-1])
    d = acc.shape[-1] // 2
    while d:
        acc = acc + np.minimum(acc[..., lane ^ d], cni_mod.SAT64 - acc)
        d //= 2
    return acc[..., 0]


def cni_update_by_position(rows: torch.Tensor, delta: torch.Tensor,
                           d_max: int, max_p: int, lanes: int | None = None):
    """``cni_update_ref`` formed in the CUDA kernel's order, on the host.

    Per new row: the descending positions of its positive counts up to
    d_max, each position's label and prefix p, and its table index.  Lane
    g of the row's ``lanes`` (default: ``plan_lanes(L)``) folds the exact
    terms of positions g, g + lanes, ... in order with the saturating add,
    then ``sat_tree`` folds the lanes; m is the largest log term; the
    float32 sum of exp(t - m) runs from 0 in position order.  The degree
    is the sum of the whole row.  Returns CPU tensors.
    """
    new = (rows + delta).cpu().numpy()
    n, L = new.shape
    g = plan_lanes(L) if lanes is None else lanes
    deg = new.sum(axis=1, dtype=np.int64).astype(np.int32)
    cp = np.maximum(new, 0).astype(np.int64)
    npos = np.minimum(cp.sum(axis=1), d_max)                 # (n,)
    pascal = cni_mod._pascal_table_np(d_max, max_p).astype(np.int64)
    log_t = cni_mod._log_hbar_np(d_max, max_p)
    # label at position j: the first descending bin whose cumulative count
    # passes j (ord value L - bin)
    ccum = np.cumsum(cp[:, ::-1], axis=1)                    # (n, L)
    pos = np.arange(d_max)
    bins = (ccum[:, None, :] <= pos[None, :, None]).sum(-1)  # (n, d_max)
    valid = pos[None, :] < npos[:, None]
    lab = np.where(valid, L - bins, 0)
    prefix = np.minimum(np.cumsum(lab, axis=1), max_p)
    q = pos + 1
    terms = np.where(valid, pascal[q[None, :], prefix], 0)
    logs = np.where(valid, log_t[q[None, :], prefix], -np.inf).astype(np.float32)

    acc = np.zeros((n, g), dtype=np.int64)                   # lane sums
    for j in range(d_max):
        lane = j % g
        acc[:, lane] += np.minimum(terms[:, j], cni_mod.SAT64 - acc[:, lane])
    cni = sat_tree(acc)
    m = logs.max(axis=1, initial=-np.inf)
    m_safe = np.where(np.isfinite(m), m, np.float32(0.0)).astype(np.float32)
    s = np.zeros(n, dtype=np.float32)
    for j in range(d_max):
        e = np.exp(logs[:, j] - m_safe, dtype=np.float32)
        s = np.where(valid[:, j], s + e, s).astype(np.float32)
    log = np.where(deg > 0, m_safe + np.log(np.maximum(s, np.float32(1e-30))),
                   -np.inf).astype(np.float32)
    return (torch.as_tensor(new), torch.as_tensor(deg), torch.as_tensor(cni),
            torch.as_tensor(log))
