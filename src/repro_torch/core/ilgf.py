"""Iterative Local-Global Filtering (the paper's Algorithm 2), port of
``repro.core.ilgf``.

Each round removes every currently-unmatchable vertex at once and rebuilds
the alive-masked counts matrix with one scatter; the removal operator is
monotone, so this peeling reaches the paper's fixed point.  The reference's
``lax.while_loop`` becomes a Python loop that reads one ``changed`` scalar
per round.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import filters as flt
from repro_torch.core.cni import default_max_p
from repro_torch.core.labels import LabelMap, build_label_map, counts_matrix, ord_of
from repro_torch.graphs.csr import Graph, graph_to, max_degree


class IlgfResult(NamedTuple):
    alive: torch.Tensor       # (V,) bool — surviving data vertices
    candidates: torch.Tensor  # (V, U) bool — C(u) columns (Alg. 2 lines 20-25)
    iterations: int           # peeling rounds until the fixed point


class QueryDigest(NamedTuple):
    label_map: LabelMap
    counts: torch.Tensor
    digest: flt.VertexDigest
    mnd: torch.Tensor  # (U,) maximum neighbor degree (CFL-match baseline)


def prepare_query(query: Graph, d_max: int, max_p: int) -> QueryDigest:
    label_map = build_label_map(query)
    q_counts = counts_matrix(query, label_map)
    q_digest = flt.make_digest(q_counts, ord_of(label_map, query.vlabels),
                               d_max, max_p)
    q_mnd = flt.mnd_values(q_counts, q_digest.deg, query.src, query.dst,
                           query.n_vertices)
    return QueryDigest(label_map, q_counts, q_digest, q_mnd)


def match_matrix(variant: str, counts: torch.Tensor, ords: torch.Tensor,
                 q: QueryDigest, g: Graph, alive: torch.Tensor,
                 d_max: int, max_p: int) -> torch.Tensor:
    """(V, U) candidate matrix under the chosen filter family."""
    if variant == "nlf":
        return flt.nlf_match(counts, q.counts, ords, q.digest.ord_label)
    if variant == "label_degree":
        deg = counts.sum(-1).to(torch.int32)
        do = ords[..., :, None]
        lab = (do == q.digest.ord_label[..., None, :]) & (do > 0)
        return lab & (deg[..., :, None] >= q.digest.deg[..., None, :])
    if variant == "mnd_nlf":  # CFL-match's Algorithm 1: MND gate then NLF
        deg = counts.sum(-1).to(torch.int32)
        mnd_d = flt.mnd_values(counts, deg, g.src, g.dst, g.n_vertices, alive)
        gate = flt.mnd_match(mnd_d, q.mnd, ords, q.digest.ord_label)
        return gate & flt.nlf_match(counts, q.counts, ords, q.digest.ord_label)
    if variant not in ("cni", "cni_log"):
        raise ValueError(f"unknown filter variant: {variant}")
    digest = flt.make_digest(counts, ords, d_max, max_p)
    if variant == "cni":
        return flt.cni_match(digest, q.digest)
    return flt.cni_match_log(digest, q.digest)


def _prepare(data: Graph, query: Graph, d_max: int | None):
    """Shared set-up of ``ilgf`` and ``one_shot_filter``: the query moved to
    the data's device, and the static degree bound."""
    query = graph_to(query, data.vlabels.device)
    if d_max is None:
        d_max = max(1, max_degree(data))
    return query, d_max


def ilgf(data: Graph, query: Graph, *, variant: str = "cni",
         d_max: int | None = None, max_p: int | None = None,
         max_iters: int = 1_000, alive0=None) -> IlgfResult:
    """Run ILGF to its fixed point on the data graph's device.

    ``variant``: ``cni`` (exact digest), ``cni_log`` (float32 log digest),
    ``nlf``, ``label_degree`` or ``mnd_nlf``.  ``alive0``: optional (V,)
    bool sound starting mask.
    """
    query, d_max = _prepare(data, query, d_max)
    label_map = build_label_map(query)
    if max_p is None:
        max_p = default_max_p(d_max, label_map.n_labels)
    q = prepare_query(query, d_max, max_p)
    ords = ord_of(q.label_map, data.vlabels)
    alive = ords > 0  # Lemma 1 applied up front
    if alive0 is not None:
        alive = torch.as_tensor(alive0, dtype=torch.bool,
                                device=alive.device) & alive

    iters = 0
    changed = True
    while changed and iters < max_iters:
        counts = counts_matrix(data, q.label_map, alive)
        match = match_matrix(variant, counts, ords, q, data, alive, d_max, max_p)
        new_alive = alive & match.any(-1)
        changed = bool((new_alive != alive).any())  # the round's one sync
        alive = new_alive
        iters += 1
    # final candidate sets over the fixed-point graph (Alg. 2 lines 20-25)
    counts = counts_matrix(data, q.label_map, alive)
    match = match_matrix(variant, counts, ords, q, data, alive, d_max, max_p)
    return IlgfResult(alive=alive, candidates=match & alive[:, None],
                      iterations=iters)


def one_shot_filter(data: Graph, query: Graph, *, variant: str = "cni",
                    d_max: int | None = None) -> IlgfResult:
    """Single (non-iterated) filtering pass — for pruning-power comparisons."""
    query, d_max = _prepare(data, query, d_max)
    label_map = build_label_map(query)
    max_p = default_max_p(d_max, label_map.n_labels)
    q = prepare_query(query, d_max, max_p)
    ords = ord_of(q.label_map, data.vlabels)
    counts = counts_matrix(data, q.label_map, ords > 0)
    match = match_matrix(variant, counts, ords, q, data, ords > 0, d_max, max_p)
    cand = match.any(1) & (ords > 0)
    return IlgfResult(alive=cand, candidates=match & cand[:, None],
                      iterations=1)
