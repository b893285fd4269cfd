"""Compact Neighborhood Index (the paper's §3.1), port of ``repro.core.cni``.

``cni(u) = Σ_{j=1..k} ħ(j, x_1+…+x_j)`` with ``ħ(q,p) = C(q+p-1, q)`` over
the vertex's neighbour labels in *descending* ord() order.  The exact digest
is one int64 per row, saturating at ``SAT64 = 2^62``: it equals the
reference's two-limb value ``limb_to_u64_np(hi, lo)``.  The float32
log-space digest is the logsumexp of log-ħ terms.

The Pascal and log-ħ tables are built on the host with numpy/scipy, as the
reference builds them, and uploaded once per (d_max, max_p, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# saturation threshold of the exact digest (the reference's SAT64)
SAT64 = 1 << 62
# log-space twin of SAT64: log digests at/above it count as saturated
LOG_SAT64 = float(62 * np.log(2.0))


@functools.lru_cache(maxsize=8)
def _pascal_table_np(max_q: int, max_p: int) -> np.ndarray:
    """(max_q+1, max_p+1) uint64 table of ħ(q,p), saturated at SAT64.

    Row q is the prefix sum of row q-1; a float shadow detects overflow and
    saturation is sticky (the reference's construction, step for step).
    """
    sat_u = np.uint64(SAT64)
    sat_f = float(SAT64)
    row_u = np.ones(max_p + 1, dtype=np.uint64)
    row_u[0] = 0
    row_f = row_u.astype(np.float64)
    table = np.zeros((max_q + 1, max_p + 1), dtype=np.uint64)
    table[0] = row_u
    for q in range(1, max_q + 1):
        nxt_f = np.cumsum(row_f)
        nxt_u = np.cumsum(row_u, dtype=np.uint64)
        sat = nxt_f >= sat_f
        nxt_u[sat] = sat_u
        nxt_f[sat] = sat_f
        table[q] = nxt_u
        row_u, row_f = nxt_u, nxt_f
    return table


@functools.lru_cache(maxsize=8)
def _log_hbar_np(max_q: int, max_p: int) -> np.ndarray:
    from scipy.special import gammaln  # host-only precompute

    q = np.arange(max_q + 1, dtype=np.float64)[:, None]
    p = np.arange(max_p + 1, dtype=np.float64)[None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        val = gammaln(q + p) - gammaln(q + 1.0) - gammaln(np.maximum(p, 1e-9))
    val = np.where(p < 0.5, -np.inf, val)  # ħ(q, 0) := 0
    return val.astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pascal_table(max_q: int, max_p: int, device: torch.device) -> torch.Tensor:
    # every entry is <= 2^62, so the uint64 table fits int64 unchanged
    return torch.as_tensor(
        _pascal_table_np(max_q, max_p).astype(np.int64), device=device
    )


@functools.lru_cache(maxsize=8)
def _log_hbar(max_q: int, max_p: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_log_hbar_np(max_q, max_p), device=device)


def default_max_p(d_max: int, n_labels: int, cap: int = 4096) -> int:
    """Static bound on prefix sums fed to the ħ table (clipping is monotone,
    so it only weakens the filter)."""
    return int(min(d_max * max(n_labels, 1), cap))


def _descending_positions(counts: torch.Tensor, d_max: int):
    """Expand (V, L) count rows into descending ord()-value sequences.

    counts[v, l] = multiplicity of ord value (l+1).  Returns
    (prefix_sums (V, D) int32, valid (V, D) bool, deg (V,) int64); positions
    >= deg hold label 0.
    """
    L = counts.shape[-1]
    ccum = counts.flip(-1).cumsum(-1)  # (V, L) int64; index i ↔ ord L - i
    pos = torch.arange(d_max, dtype=ccum.dtype, device=counts.device)
    # label at position j: first i with ccum[i] > j  ⇒ ord value L - i
    idx = torch.searchsorted(
        ccum, pos.expand(ccum.shape[0], d_max).contiguous(), right=True,
        out_int32=True,
    )
    deg = ccum[:, -1]
    valid = pos[None, :] < deg[:, None]
    lab = torch.where(valid, (L - idx).clamp_min(0), 0)
    prefix = lab.cumsum(-1, dtype=torch.int32)
    return prefix, valid, deg


def _term_index(prefix: torch.Tensor, d_max: int, max_p: int) -> torch.Tensor:
    """Flat index of ħ(j+1, min(prefix_j, max_p)) into a (D+1, P+1) table."""
    q = torch.arange(1, d_max + 1, device=prefix.device, dtype=torch.int64)
    return q[None, :] * (max_p + 1) + prefix.clamp(0, max_p)


def cni_from_counts(counts: torch.Tensor, d_max: int, max_p: int) -> torch.Tensor:
    """Exact saturating CNI, one int64 per count row.

    counts: (..., L) int; any leading batch shape.  The sum saturates at
    SAT64 term by term as ``acc + min(term, SAT64 - acc)``, which never
    forms a value above 2^62 (a raw 2^62 + 2^62 would overflow int64).
    """
    batch_shape = counts.shape[:-1]
    counts = counts.reshape(-1, counts.shape[-1])
    table = _pascal_table(d_max, max_p, counts.device)
    prefix, valid, _ = _descending_positions(counts, d_max)
    terms = table.view(-1)[_term_index(prefix, d_max, max_p)]
    terms = torch.where(valid, terms, 0)
    acc = torch.zeros(counts.shape[0], dtype=torch.int64, device=counts.device)
    for i in range(d_max):
        acc = acc + torch.minimum(terms[:, i], SAT64 - acc)
    return acc.reshape(batch_shape)


def cni_log_from_counts(counts: torch.Tensor, d_max: int, max_p: int) -> torch.Tensor:
    """float32 log-space CNI: logsumexp of the log-ħ terms, per count row."""
    batch_shape = counts.shape[:-1]
    counts = counts.reshape(-1, counts.shape[-1])
    log_t = _log_hbar(d_max, max_p, counts.device)
    prefix, valid, deg = _descending_positions(counts, d_max)
    terms = log_t.view(-1)[_term_index(prefix, d_max, max_p)]
    terms = torch.where(valid, terms, -torch.inf)
    if d_max > 0:
        m = terms.max(dim=-1).values
    else:
        m = torch.full((counts.shape[0],), -torch.inf, device=counts.device)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    s = torch.where(valid, torch.exp(terms - m_safe[:, None]), 0.0).sum(-1)
    out = m_safe + torch.log(s.clamp_min(1e-30))
    return torch.where(deg > 0, out, -torch.inf).reshape(batch_shape)


def cni_from_counts_np(counts: np.ndarray, d_max: int, max_p: int):
    """Host (numpy) twin of the device encode: (N, L) count rows ->
    (cni (N,) int64, cni_log (N,) float32, deg (N,) int32).

    The same saturated Pascal table, ``min(p, max_p)`` clip and sticky
    ``min(acc + term, SAT64)`` add as the device, so host query digests
    (batch assembly) compare bit for bit against device data digests.  Rows
    whose float64 term-sum shadow stays below SAT64 / 2 take a plain uint64
    sum (partial sums are monotone, so no saturating add can have fired);
    the others replay the sticky saturating accumulation.  Every value is
    at most 2^62, so the int64 result equals the reference's uint64 one.
    """
    counts = np.asarray(counts)
    n, L = counts.shape
    deg_all = counts.sum(axis=1).astype(np.int32)
    if n == 0 or d_max <= 0:
        return np.zeros(n, np.int64), np.full(n, -np.inf, np.float32), deg_all
    table = _pascal_table_np(d_max, max_p)  # uint64, saturated at SAT64
    log_t = _log_hbar_np(d_max, max_p)

    # descending expansion across all rows: label at position j = first
    # ccum bin > j
    desc = counts[:, ::-1]
    ccum = np.cumsum(desc, axis=1)                              # (N, L)
    posr = np.arange(d_max)
    idx = (ccum[:, None, :] <= posr[None, :, None]).sum(-1)     # (N, D)
    lab = np.maximum(L - idx, 0)
    deg = ccum[:, -1]
    valid = posr[None, :] < deg[:, None]
    lab = np.where(valid, lab, 0)
    prefix = np.minimum(np.cumsum(lab, axis=1), max_p)          # (N, D)
    q_idx = np.arange(1, d_max + 1)
    terms = np.where(valid, table[q_idx[None, :], prefix], 0)   # uint64

    shadow_total = np.cumsum(terms.astype(np.float64), axis=1)[:, -1]
    cni_u64 = terms.sum(axis=1, dtype=np.uint64)
    for v in np.nonzero(shadow_total >= float(SAT64) * 0.5)[0]:
        acc = 0
        for j in range(1, min(int(deg[v]), d_max) + 1):
            acc = min(acc + int(table[j, prefix[v, j - 1]]), SAT64)
        cni_u64[v] = acc

    log_terms = np.where(valid, log_t[q_idx[None, :], prefix], -np.inf)
    log_terms = log_terms.astype(np.float32)
    m = log_terms.max(axis=1, initial=-np.inf)
    m_safe = np.where(np.isfinite(m), m, np.float32(0.0))
    s = np.sum(
        np.where(valid, np.exp(log_terms - m_safe[:, None]), 0.0),
        axis=1, dtype=np.float32,
    )
    cni_log = np.where(
        deg > 0,
        m_safe + np.log(np.maximum(s, np.float32(1e-30))),
        -np.inf,
    ).astype(np.float32)
    return cni_u64.astype(np.int64), cni_log, deg_all


def cni_exact_py(labels: list[int]) -> int:
    """Arbitrary-precision host oracle of the paper's formula over the
    positive ``labels`` in descending order (no saturation), as the
    reference's; the int64 digest equals it while it is below ``SAT64``."""
    import math

    xs = sorted((int(x) for x in labels if int(x) > 0), reverse=True)
    total = 0
    s = 0
    for j, x in enumerate(xs, start=1):
        s += x
        total += math.comb(j + s - 1, j)
    return total
