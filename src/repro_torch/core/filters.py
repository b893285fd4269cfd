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

from repro_torch.kernels.candidate_filter import ops as match_ops
from repro_torch.kernels.cni_encode import ops as encode_ops


class VertexDigest(NamedTuple):
    """Everything cniMatch needs about one side's vertices, shape (..., V)."""

    ord_label: torch.Tensor  # int32 in [0, L]; 0 = not in 𝓛(Q)
    deg: torch.Tensor        # int32 = deg_{𝓛(Q)}
    cni: torch.Tensor        # int64 exact CNI, saturating at SAT64
    cni_log: torch.Tensor    # float32 log-space CNI


def make_digest(counts: torch.Tensor, ord_label: torch.Tensor, d_max: int,
                max_p: int) -> VertexDigest:
    """Digest every count row (..., L): the cni_encode kernel on a CUDA
    tensor, its plain version on a CPU one."""
    deg, cni, cni_log = encode_ops.cni_encode(counts, d_max, max_p)
    return VertexDigest(ord_label=ord_label.to(torch.int32), deg=deg,
                        cni=cni, cni_log=cni_log)


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
    label+degree filters (sound: saturation is monotone).  The
    candidate_filter kernel on CUDA tensors, its plain version on CPU ones.
    """
    return match_ops.candidate_filter(
        data.ord_label, data.deg, data.cni,
        query.ord_label, query.deg, query.cni, mode="exact")


def cni_match_log(data: VertexDigest, query: VertexDigest,
                  eps: float = 1e-4) -> torch.Tensor:
    """cniMatch on the float32 log-space path with ε-tolerant compares.

    At/above ``LOG_SAT64`` the comparison falls back to the label+degree
    filters, as the exact path does at SAT64.
    """
    return match_ops.candidate_filter(
        data.ord_label, data.deg, data.cni_log,
        query.ord_label, query.deg, query.cni_log, mode="log", eps=eps)


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
