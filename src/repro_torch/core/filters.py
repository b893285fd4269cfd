"""Candidate filters: label / degree / CNI (Lemmas 1–3) plus the NLF and MND
baselines, port of ``repro.core.filters``.

Every function takes an optional leading batch dimension — data digests
(B, V), query digests (B, U) — and then returns a (B, V, U) grid.
``cni_match`` is the corrected Algorithm 3:

    match(v,u) ⇔ ℓ(v)=ℓ(u) ∧ ( (deg_L(v) > deg_L(u) ∧ cni(v) ≥ cni(u))
                              ∨ (deg_L(v) = deg_L(u) ∧ cni(v) = cni(u)) )
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import cni as cni_mod
from repro_torch.core.cni import LOG_SAT64, SAT64

# unsaturated rows within this margin of LOG_SAT64 are also treated as
# saturated — pass-through is monotone-weaker, hence always sound
_LOG_SAT_THRESH = LOG_SAT64 - 1e-3


class VertexDigest(NamedTuple):
    """Everything cniMatch needs about one side's vertices, shape (..., V)."""

    ord_label: torch.Tensor  # int32 in [0, L]; 0 = not in 𝓛(Q)
    deg: torch.Tensor        # int32 = deg_{𝓛(Q)}
    cni: torch.Tensor        # int64 exact CNI, saturating at SAT64
    cni_log: torch.Tensor    # float32 log-space CNI


def make_digest(counts: torch.Tensor, ord_label: torch.Tensor, d_max: int,
                max_p: int) -> VertexDigest:
    return VertexDigest(
        ord_label=ord_label.to(torch.int32),
        deg=counts.sum(-1).to(torch.int32),
        cni=cni_mod.cni_from_counts(counts, d_max, max_p),
        cni_log=cni_mod.cni_log_from_counts(counts, d_max, max_p),
    )


def label_match(data: VertexDigest, query: VertexDigest) -> torch.Tensor:
    """Lemma 1, (..., V, U) bool."""
    dl = data.ord_label[..., :, None]
    return (dl == query.ord_label[..., None, :]) & (dl > 0)


def degree_match(data: VertexDigest, query: VertexDigest) -> torch.Tensor:
    """Lemma 2, (..., V, U) bool."""
    return data.deg[..., :, None] >= query.deg[..., None, :]


def cni_match(data: VertexDigest, query: VertexDigest) -> torch.Tensor:
    """Corrected Algorithm 3 on the exact digest, (..., V, U) bool.

    When either side is saturated the CNI comparison degenerates to the
    label+degree filters (sound: saturation is monotone).
    """
    lab = label_match(data, query)
    dv = data.deg[..., :, None]
    du = query.deg[..., None, :]
    cv = data.cni[..., :, None]
    cu = query.cni[..., None, :]
    sat = (cv == SAT64) | (cu == SAT64)
    strict = (dv > du) & ((cv >= cu) | sat)
    equal = (dv == du) & ((cv == cu) | sat)
    return lab & (strict | equal)


def cni_match_log(data: VertexDigest, query: VertexDigest,
                  eps: float = 1e-4) -> torch.Tensor:
    """cniMatch on the float32 log-space path with ε-tolerant compares.

    At/above ``LOG_SAT64`` the comparison falls back to the label+degree
    filters, as the exact path does at SAT64.
    """
    lab = label_match(data, query)
    dv = data.deg[..., :, None]
    du = query.deg[..., None, :]
    cv = data.cni_log[..., :, None]
    cu = query.cni_log[..., None, :]
    tol = eps * cu.abs().clamp_min(1.0)
    ge = cv >= cu - tol
    eq = (cv - cu).abs() <= tol
    sat = (cv >= _LOG_SAT_THRESH) | (cu >= _LOG_SAT_THRESH)
    both_empty = (dv == 0) & (du == 0)
    strict = (dv > du) & (ge | sat)
    equal = (dv == du) & (eq | both_empty | sat)
    return lab & (strict | equal)


def nlf_match(counts_data: torch.Tensor, counts_query: torch.Tensor,
              data_ord: torch.Tensor, query_ord: torch.Tensor) -> torch.Tensor:
    """Neighborhood Label Frequency filter (Algorithm 1 lines 5–9), (..., V, U):
    v is a candidate for u iff v's label counts dominate u's component-wise."""
    do = data_ord[..., :, None]
    lab = (do == query_ord[..., None, :]) & (do > 0)
    dom = (counts_data[..., :, None, :] >= counts_query[..., None, :, :]).all(-1)
    return lab & dom


def mnd_values(counts: torch.Tensor, deg: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, n_vertices: int,
               alive: torch.Tensor | None = None) -> torch.Tensor:
    """Maximum Neighbor Degree per vertex (CFL-match's O(1) pre-filter).

    ``deg``/``alive`` may carry leading batch dims: (..., V) in, (..., V) out.
    """
    ddeg = deg[..., dst]
    if alive is not None:
        ddeg = torch.where(alive[..., dst] & alive[..., src], ddeg, 0)
    ddeg = ddeg.to(torch.int32)
    mnd = torch.zeros(deg.shape[:-1] + (n_vertices,), dtype=torch.int32,
                      device=deg.device)
    return mnd.scatter_reduce_(-1, src.expand_as(ddeg), ddeg, reduce="amax")


def mnd_match(mnd_data: torch.Tensor, mnd_query: torch.Tensor,
              data_ord: torch.Tensor, query_ord: torch.Tensor) -> torch.Tensor:
    do = data_ord[..., :, None]
    lab = (do == query_ord[..., None, :]) & (do > 0)
    return lab & (mnd_data[..., :, None] >= mnd_query[..., None, :])
