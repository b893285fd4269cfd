"""Subgraph search over the ILGF-filtered graph (the paper's §3.3), port of
``repro.core.search``.

Three engines, all enumerating the same embeddings in the same row order:

* ``host_dfs_search`` — Ullmann's recursive DFS (Algorithms 4/5) in numpy,
  the exactness oracle.
* ``bfs_join_search`` — the breadth-first vectorized join with a host
  result table: small levels run in numpy, large ones evaluate their
  validity grid on the device (``embed_join``).
* ``device_join_search`` — the partial-embedding table stays on the device
  and every level is a two-phase join: a count pass sizes the output, an
  on-device exclusive scan assigns slots (one scalar syncs per level), and
  an emit pass writes each survivor's row of the next table into an
  exactly-sized, 128-row-aligned buffer.  The level loop's inputs reach
  the device in one upload a query.  On a CUDA device the count and emit
  passes are the hand-written kernels; on the CPU the same loop runs their
  plain versions.
* ``sharded_device_join_search`` — the same join with the table split by
  row across a mesh (``core/distributed.py``), one contiguous block per
  shard, and a count-driven rebalancer; ``device_join_search`` is its
  one-shard case.

Row order is the flat row-major survivor order (lexicographic in the
matching order), which is what keeps ``max_embeddings`` prefixes identical
across the engines.  By default the matching order follows the
candidate-cardinality greedy rule (``greedy_matching_order``).
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import obsv
from repro_torch.core import distributed as dist
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, as_numpy
from repro_torch.kernels.embed_join import ops

# ---------------------------------------------------------------------------
# Matching order.
# ---------------------------------------------------------------------------


def greedy_matching_order(sizes, adj) -> list[int]:
    """Candidate-cardinality greedy matching order (§2.2 heuristic).

    Start at the smallest candidate set, then repeatedly take the
    smallest-|C(u)| vertex connected to the prefix (any remaining vertex
    only when the query is disconnected); ties break by smallest vertex id.

    ``sizes``: (U,) per-query-vertex candidate cardinalities;
    ``adj``: ``{u: {w: edge_label}}`` query adjacency.
    """
    sizes = np.asarray(sizes)
    n_q = int(sizes.shape[0])
    order: list[int] = [int(np.argmin(sizes))]
    remaining = [u for u in range(n_q) if u != order[0]]
    while remaining:
        connected = [u for u in remaining
                     if any(w in adj.get(u, {}) for w in order)]
        pool = connected if connected else remaining
        nxt = min(pool, key=lambda u: (sizes[u], u))
        order.append(nxt)
        remaining.remove(nxt)
    return order


def _as_order(order: Sequence[int], n_q: int) -> list[int]:
    """Validate a caller-supplied matching order (any permutation is legal)."""
    o = [int(u) for u in order]
    if sorted(o) != list(range(n_q)):
        raise ValueError(
            f"matching order must be a permutation of range({n_q}), got {o}"
        )
    return o


def _matching_order(order, cand: np.ndarray, q_adj, n_q: int) -> list[int]:
    if order is None:
        return greedy_matching_order(cand.sum(axis=0), q_adj)
    return _as_order(order, n_q)


# ---------------------------------------------------------------------------
# Host DFS oracle (Ullmann subroutine, Algorithms 4-5).
# ---------------------------------------------------------------------------


def _host_adjacency(g: Graph):
    adj: dict[int, dict[int, int]] = {}
    for s, t, e in zip(as_numpy(g.src), as_numpy(g.dst), as_numpy(g.elabels)):
        adj.setdefault(int(s), {})[int(t)] = int(e)
    return adj


def host_dfs_search(
    data: Graph,
    query: Graph,
    candidates: np.ndarray,
    *,
    order: Sequence[int] | None = None,
    max_embeddings: int | None = None,
) -> np.ndarray:
    """All embeddings (rows = mappings, columns = query vertices).

    ``candidates``: (V, U) bool — C(u) columns from ILGF.  ``order``: an
    explicit matching order; defaults to the greedy rule.
    """
    cand = as_numpy(candidates)
    n_q = query.n_vertices
    d_adj = _host_adjacency(data)
    q_adj = _host_adjacency(query)
    order = _matching_order(order, cand, q_adj, n_q)

    results: list[list[int]] = []
    mapping = [-1] * n_q
    used: set[int] = set()

    def neighbor_check(u: int, v: int) -> bool:
        # Algorithm 5: every matched query-neighbor must map to a data
        # neighbor with a matching edge label.
        for u2, el in q_adj.get(u, {}).items():
            v2 = mapping[u2]
            if v2 >= 0:
                got = d_adj.get(v, {}).get(v2)
                if got is None or got != el:
                    return False
        return True

    def rec(depth: int) -> bool:
        if max_embeddings is not None and len(results) >= max_embeddings:
            return True
        if depth == n_q:
            results.append(list(mapping))
            return False
        u = order[depth]
        for v in np.nonzero(cand[:, u])[0]:
            v = int(v)
            if v in used:
                continue
            if neighbor_check(u, v):
                mapping[u] = v
                used.add(v)
                if rec(depth + 1):
                    return True
                used.discard(v)
                mapping[u] = -1
        return False

    rec(0)
    return np.asarray(results, dtype=np.int64).reshape(-1, n_q)


# ---------------------------------------------------------------------------
# Breadth-first join engine (host result table).
# ---------------------------------------------------------------------------


def _dense_edge_labels(g: Graph, n: int) -> np.ndarray:
    """(n, n) int32 matrix: edge label, or -1 if no edge."""
    m = -np.ones((n, n), dtype=np.int32)
    m[as_numpy(g.src), as_numpy(g.dst)] = as_numpy(g.elabels)
    return m


def _expand_step_np(chunk, cand_ids, elab_np, q_pos, q_lab, q_val):
    """Numpy validity grid for small (R·C·J) levels, where a device round
    trip costs more than the work."""
    mapped = chunk[:, q_pos]                                   # (R, J)
    got = elab_np[mapped[:, :, None], cand_ids[None, None, :]]  # (R, J, C)
    lab_ok = (got == q_lab[None, :, None]) | ~q_val[None, :, None]
    adj_ok = lab_ok.all(axis=1)                                # (R, C)
    inj_ok = (chunk[:, :, None] != cand_ids[None, None, :]).all(axis=1)
    return adj_ok & inj_ok


# below this many (R·C·J) cells a join level runs on host numpy
_HOST_JOIN_CELLS = 1 << 18


def _level_constraints(q_adj, pos_of, u: int, t: int):
    """Matched-neighbor constraint arrays for join level ``t`` (vertex u).

    Returns (q_pos, q_lab, q_val): positions (< t) of already-matched query
    neighbors, their required edge labels, and a validity mask (at least one
    inert row is kept so shapes never collapse to zero)."""
    nbrs = [(pos_of[w], el) for w, el in q_adj.get(u, {}).items()
            if pos_of[w] < t]
    j = max(1, len(nbrs))
    q_pos = np.zeros(j, dtype=np.int32)
    q_lab = np.zeros(j, dtype=np.int32)
    q_val = np.zeros(j, dtype=bool)
    for k, (p, el) in enumerate(nbrs):
        q_pos[k], q_lab[k], q_val[k] = p, el, True
    return q_pos, q_lab, q_val


def _host_join_level(table, cand_ids, elab_np, elab_dev, constraints,
                     chunk_rows: int, t: int, device):
    """One chunked join level with a host survivor table.

    Returns ``(new_table, elab_dev)`` — the survivor table of width
    ``t + 1`` and the device copy of the edge-label matrix (made on the
    first chunk large enough for the device)."""
    q_pos, q_lab, q_val = constraints
    new_rows: list[np.ndarray] = []
    for lo in range(0, table.shape[0], chunk_rows):
        chunk = table[lo : lo + chunk_rows]
        r = chunk.shape[0]
        if r * cand_ids.size * q_pos.size <= _HOST_JOIN_CELLS:
            valid = _expand_step_np(chunk, cand_ids, elab_np, q_pos, q_lab, q_val)
        else:
            if elab_dev is None:
                elab_dev = torch.as_tensor(elab_np, device=device)
            chunk_d, cand_d, qp, ql, qv = (
                torch.as_tensor(x, device=device)
                for x in (chunk, cand_ids, q_pos, q_lab, q_val)
            )
            valid = ops.embed_join(
                chunk_d, torch.ones(r, dtype=torch.bool, device=device),
                cand_d, torch.ones(cand_ids.size, dtype=torch.bool, device=device),
                elab_dev, qp, ql, qv,
            ).cpu().numpy()
        r_idx, c_idx = np.nonzero(valid)
        if r_idx.size:
            new_rows.append(np.concatenate(
                [chunk[r_idx], cand_ids[c_idx][:, None]], axis=1
            ))
    if not new_rows:
        return np.zeros((0, t + 1), dtype=np.int32), elab_dev
    return np.concatenate(new_rows, axis=0), elab_dev


def bfs_join_search(
    data: Graph,
    query: Graph,
    candidates: np.ndarray,
    *,
    order: Sequence[int] | None = None,
    chunk_rows: int = 8192,
    max_embeddings: int | None = None,
    device=None,
) -> np.ndarray:
    """Enumerate all embeddings with the vectorized join plan.

    The result table stays on the host; each level's validity grid is
    evaluated in numpy when it has at most ``2^18`` (R·C·J) cells and by
    ``embed_join`` on ``device`` otherwise.
    """
    dev = resolve_device(device)
    cand = as_numpy(candidates)
    n_q = query.n_vertices
    q_adj = _host_adjacency(query)
    elab_np = _dense_edge_labels(data, data.n_vertices)
    elab_dev = None  # device copy made on the first level that needs it
    order = _matching_order(order, cand, q_adj, n_q)
    pos_of = {u: i for i, u in enumerate(order)}

    # seed table with u_0's candidates
    table = np.nonzero(cand[:, order[0]])[0].astype(np.int32).reshape(-1, 1)
    for t in range(1, n_q):
        u = order[t]
        cand_ids = np.nonzero(cand[:, u])[0].astype(np.int32)
        if table.shape[0] == 0 or cand_ids.size == 0:
            return np.zeros((0, n_q), dtype=np.int64)
        table, elab_dev = _host_join_level(
            table, cand_ids, elab_np, elab_dev,
            _level_constraints(q_adj, pos_of, u, t), chunk_rows, t, dev,
        )
    # truncation happens after the final level (covers single-vertex
    # queries, whose seed table never enters the loop)
    if max_embeddings is not None and table.shape[0] > max_embeddings:
        table = table[:max_embeddings]
    return _restore_query_order(table, order)


def _restore_query_order(table: np.ndarray, order: Sequence[int]) -> np.ndarray:
    """Table columns are in matching order; restore query-vertex order."""
    out = np.zeros((table.shape[0], len(order)), dtype=np.int64)
    for i, u in enumerate(order):
        out[:, u] = table[:, i]
    return out


# ---------------------------------------------------------------------------
# Device-resident two-phase join engine.
# ---------------------------------------------------------------------------


def _align_rows(n: int) -> int:
    """128-row-aligned allocation for ``n`` live rows (at most 127 inert
    rows ride along)."""
    return max(128, -(-int(n) // 128) * 128)


def empty_enum_report() -> dict:
    """The zeroed two-phase telemetry schema ``device_join_search`` fills.

    Every exit path leaves exactly these keys in ``report``:

    * ``device_rounds`` — expansion rounds executed (all on the device);
    * ``host_levels``   — always 0 (no level falls back to the host);
    * ``count_seconds`` / ``scan_seconds`` / ``emit_seconds`` — per-phase
      wall-clock totals across rounds; a level's three phases are
      contiguous, the emit's with the advance to the next level's blocks.
      The count ends in the level's one host read; the emit ends in a
      device sync only with an active tracer (``obsv.enabled()``), so with
      tracing off ``emit_seconds`` reads the emit's host dispatch time;
    * ``max_table_rows`` — peak true survivor count over all levels;
    * ``max_emit_rows``  — peak allocated (128-aligned) table rows;
    * ``scan_path``     — ``"device"``: the scan is an on-device cumsum;
    * ``enum_shards``   — the shard count (1 on one device);
    * ``emit_rows_max`` / ``emit_rows_min`` — the heaviest and lightest
      shard's emitted rows at the heaviest level (equal on one device);
    * ``rebalance_rounds`` / ``rebalance_rows_moved`` /
      ``rebalance_seconds`` — the rebalancer's work (0 on one device);
    * ``levels``        — per-level records ``{"level", "emit_rows",
      "rebalanced", "rebalance_seconds"}``.
    """
    return obsv.EnumReport.empty().to_dict()


def _level_record(level: int, emit_rows, *, rebalanced: bool = False,
                  rebalance_seconds: float = 0.0) -> dict:
    """One ``report["levels"]`` entry (see ``empty_enum_report``)."""
    return {
        "level": level,
        "emit_rows": [int(x) for x in emit_rows],
        "rebalanced": bool(rebalanced),
        "rebalance_seconds": float(rebalance_seconds),
    }


def device_join_search(
    data: Graph,
    query: Graph,
    candidates: np.ndarray,
    *,
    order: Sequence[int] | None = None,
    max_embeddings: int | None = None,
    report: dict | None = None,
    device=None,
) -> np.ndarray:
    """Enumerate all embeddings with the two-phase device-resident join.

    Bit-identical to ``bfs_join_search`` (same embeddings, same row order,
    any valid ``order``).  The partial-embedding table stays on ``device``
    and each level runs, over cell-budgeted row slices:

    1. **count** — the count kernel per slice, (R,) int32 survivors;
    2. **scan**  — an on-device cumsum turns counts into exclusive slots;
       only the level's total syncs to the host;
    3. **emit**  — the emit kernel writes each survivor's next-table row
       (its parent row, then the candidate) at its slot of an
       exactly-sized, 128-aligned buffer.

    ``report``: optional dict filled with the ``empty_enum_report()``
    schema on every exit path.  With an active tracer the join opens
    ``enum.build`` (adjacency, matching order, every level's candidates
    and constraints, their one upload, the edge-label matrix), then per
    level ``enum.stage`` (the level's views) and ``enum.count`` /
    ``enum.scan`` / ``enum.emit``, and last ``enum.assemble`` (the copy
    back); see ``_partitioned_join`` for their attributes.  This is the
    one-shard case of ``sharded_device_join_search``, which runs it.
    """
    return _partitioned_join(data, query, candidates,
                             dist.device_mesh(1, devices=resolve_device(device)),
                             order=order, max_embeddings=max_embeddings,
                             report=report, rebalance_threshold=1.0)


def sharded_device_join_search(
    data: Graph,
    query: Graph,
    candidates: np.ndarray,
    *,
    mesh,
    axis: str = "data",
    order: Sequence[int] | None = None,
    max_embeddings: int | None = None,
    report: dict | None = None,
    rebalance_threshold: float = 1.25,
) -> np.ndarray:
    """``device_join_search`` partitioned across a ``ShardMesh``.

    Equal to the single-device join bit for bit (rows, row order and the
    ``max_embeddings`` prefix) at any shard count: the table is split by
    row into one contiguous block per shard, in shard order, and children
    of contiguous parents are contiguous in the flat row-major survivor
    order, so the shards' live prefixes concatenate to the single-device
    order, level after level.  Each shard runs the count and emit passes
    on its own device against replicated candidate and edge-label tensors
    (one copy per distinct device); the per-shard totals, the level's one
    host read, number the next level's rows.

    The count pass prices every parent's emit, so when the heaviest
    shard's total exceeds ``rebalance_threshold ×`` the mean, the parents
    are recut into weight-balanced contiguous blocks
    (``enum_row_blocks``) and moved by ``exchange_rows``, which keeps the
    order.  Each shard's buffers are sized to its own rows; the report's
    ``max_emit_rows`` keeps the reference's meaning, ``n_shards ×`` the
    largest shard's aligned block.  ``report`` is filled as in
    ``device_join_search``, with the shard fields of
    ``empty_enum_report()``.
    """
    dist.mesh_shards(mesh, axis)
    return _partitioned_join(data, query, candidates, mesh, order=order,
                             max_embeddings=max_embeddings, report=report,
                             rebalance_threshold=rebalance_threshold)


def _edge_label_matrix(src, dst, elab, n: int) -> torch.Tensor:
    """The (n, n) int32 edge-label matrix, filled on the edge list's device
    from its int32 ``src``, ``dst`` and ``elab``: the label, or -1 where
    there is no edge.  A repeated (src, dst) pair holds the label of its
    last occurrence, as ``_dense_edge_labels`` leaves it: each cell takes
    the largest position of its edges (``scatter_reduce`` with ``amax``,
    the same on every run), then that edge's label."""
    m = torch.full((n * n,), -1, dtype=torch.int32, device=src.device)
    if src.numel():
        key = src.long() * n + dst.long()
        pos = torch.arange(src.numel(), dtype=torch.int32, device=src.device)
        m.scatter_reduce_(0, key, pos, "amax")
        hit = m >= 0
        m = elab.index_select(0, m.clamp_(min=0))
        m.masked_fill_(hit.logical_not_(), -1)
    return m.view(n, n)


def _pack_join(data, cand, q_adj, order, pos_of, *, pinned: bool):
    """Everything the level loop reads, in one int32 host buffer (pinned for
    a card): u_0's candidate ids (the seeds), the edge list (src, dst,
    labels), then for each level t its candidate ids and its matched
    neighbours' positions (< t) and edge labels.

    Returns ``(buffer, seeds, edges, levels)``: ``seeds`` a (lo, hi) span
    of the buffer, ``edges`` three spans, ``levels`` one
    ``(cand, q_pos, q_lab)`` triple of spans a level."""
    n_q = len(order)
    cols, ids = np.nonzero(np.ascontiguousarray(cand.T))
    starts = np.searchsorted(cols, np.arange(n_q + 1))
    edges = [as_numpy(x) for x in (data.src, data.dst, data.elabels)]
    parts = [ids[starts[order[0]] : starts[order[0] + 1]], *edges]
    for t in range(1, n_q):
        u = order[t]
        nbrs = [(pos_of[w], el) for w, el in q_adj.get(u, {}).items()
                if pos_of[w] < t]
        parts += [ids[starts[u] : starts[u + 1]], [p for p, _ in nbrs],
                  [el for _, el in nbrs]]
    bounds = np.concatenate([[0], np.cumsum([len(x) for x in parts])])
    spans = list(zip(bounds[:-1].tolist(), bounds[1:].tolist()))
    buf = torch.empty(int(bounds[-1]), dtype=torch.int32, pin_memory=pinned)
    host = buf.numpy()
    for (lo, hi), x in zip(spans, parts):
        host[lo:hi] = x
    return buf, spans[0], spans[1:4], [tuple(spans[k : k + 3])
                                       for k in range(4, len(spans), 3)]


def _fit_buffers(counts, scans, sizes) -> None:
    """Grow shard i's count and scan buffers (the count's output, and its
    scan with a leading 0) to hold ``sizes[i]`` rows: a query allocates
    them on its first level and again only when a level outgrows them."""
    for i, n in enumerate(sizes):
        if counts[i].shape[0] < n:
            cap = _align_rows(max(int(n), 2 * counts[i].shape[0]))
            dev = counts[i].device
            counts[i] = torch.empty(cap, dtype=torch.int32, device=dev)
        if scans[i].shape[0] <= n:
            scans[i] = torch.zeros(counts[i].shape[0] + 1, dtype=torch.int64,
                                   device=counts[i].device)


def _partitioned_join(data, query, candidates, mesh, *, order,
                      max_embeddings, report, rebalance_threshold):
    """The two-phase join over the shards of ``mesh`` (one shard: the
    single-device join).

    ``enum.build`` computes every level's candidate ids and matched-
    neighbour constraints on the host, packs them with the seed ids and
    the edge list into one int32 buffer and uploads it once per distinct
    device (``non_blocking``, from pinned memory when a shard is on a
    card); each device fills its (N, N) edge-label matrix from the edge
    list, and every level reads views of its copy.  A level then makes
    one host read (the shards' totals, which size the emit) and two
    kernel launches a row slice (count, emit), with the scan and the next
    table's allocation beside them; the emit writes the next table
    itself.  The rebalancer, when it fires, reads the counts and uploads
    the new offsets, as before.

    Spans, with an active tracer only: ``enum.build`` (``h2d_bytes``: the
    packed buffer, once per distinct device), per level ``enum.stage``
    (the level's views) and ``enum.count`` / ``enum.scan`` / ``enum.emit``,
    contiguous as their ``*_seconds`` in the report, and
    ``enum.assemble``.  Each carries ``copies``: the host<->device copies
    the join issued inside it (counted as issued, also where a shard lies
    on the host and the copy is a no-op).
    """
    traced = obsv.enabled()
    n_shards = mesh.n_shards
    devices = list(dict.fromkeys(mesh.devices))
    cuda = any(dev.type == "cuda" for dev in devices)
    with obsv.span("enum.build") as build_span:
        cand = as_numpy(candidates)
        n_q = query.n_vertices
        q_adj = _host_adjacency(query)
        order = _matching_order(order, cand, q_adj, n_q)
        pos_of = {u: i for i, u in enumerate(order)}

        stats = empty_enum_report()
        stats["enum_shards"] = n_shards
        stats["scan_path"] = "device"
        if report is not None:
            report.update(stats)

        host, seeds, edges, level_spans = _pack_join(
            data, cand, q_adj, order, pos_of, pinned=cuda)
        bufs, elabs = {}, {}
        for dev in devices:
            buf = host.to(dev, non_blocking=True)
            elabs[dev] = _edge_label_matrix(*(buf[lo:hi] for lo, hi in edges),
                                            data.n_vertices)
            ops.check_level_operands(buf, elabs[dev])
            bufs[dev] = buf
        # each level: the shards' (cand, elab, q_pos, q_lab) lists
        levels = [([bufs[d][c0:c1] for d in mesh.devices],
                   [elabs[d] for d in mesh.devices],
                   [bufs[d][p0:p1] for d in mesh.devices],
                   [bufs[d][l0:l1] for d in mesh.devices])
                  for (c0, c1), (p0, p1), (l0, l1) in level_spans]

        # seed: equal-rows contiguous blocks of u_0's candidate list
        total = seeds[1] - seeds[0]
        bounds = dist.enum_row_blocks(np.ones(total, np.int64), n_shards)
        sizes = np.diff(bounds).astype(np.int64)
        tables = [bufs[dev][seeds[0] + bounds[i] : seeds[0] + bounds[i + 1]]
                  .view(-1, 1) for i, dev in enumerate(mesh.devices)]
        counts = [torch.empty(0, dtype=torch.int32, device=dev)
                  for dev in mesh.devices]
        scans = [torch.empty(0, dtype=torch.int64, device=dev)
                 for dev in mesh.devices]
        host_tot = torch.empty(n_shards, dtype=torch.int64, pin_memory=cuda)
        if traced:
            build_span.set_attrs(h2d_bytes=host.nbytes * len(devices),
                                 copies=len(devices))
    stats["max_table_rows"] = total
    stats["max_emit_rows"] = n_shards * _align_rows(int(sizes.max()))
    stats["emit_rows_max"] = int(sizes.max())
    stats["emit_rows_min"] = int(sizes.min())

    for t in range(1, n_q):
        with obsv.span("enum.stage") as stage_span:
            level = levels[t - 1]
            (c0, c1), (p0, p1), _ = level_spans[t - 1]
            if traced:
                stage_span.set_attrs(copies=0)
        if total == 0 or c1 == c0:
            if report is not None:
                report.update(stats)
            return np.zeros((0, n_q), dtype=np.int64)
        stats["device_rounds"] += 1
        rows_per = dist.enum_rows_per(_align_rows(c1 - c0), max(1, p1 - p0))
        rebalanced = False
        rebal_dt = 0.0

        # -- count, with the scan fused per shard: only (D,) totals sync
        t0 = time.perf_counter()
        _fit_buffers(counts, scans, sizes)
        dist.enum_count(tables, sizes, level, rows_per, counts, scans)
        shard_tot = dist.read_totals(scans, sizes, host_tot)
        t1 = time.perf_counter()
        stats["count_seconds"] += t1 - t0
        if traced:
            obsv.span_at("enum.count", t0, t1, level=t, rows=total,
                         shards=n_shards, copies=n_shards)

        # the level's phases are contiguous: the scan starts where the
        # count ends, the emit where the scan ends
        t0 = t1
        new_total = int(shard_tot.sum())
        if new_total == 0:
            t1 = time.perf_counter()
            stats["scan_seconds"] += t1 - t0
            if traced:
                obsv.span_at("enum.scan", t0, t1, level=t, copies=0)
            total = 0
            sizes = np.zeros(n_shards, np.int64)
            stats["levels"].append(_level_record(t, [0] * n_shards))
            continue

        # -- rebalance: recut parents by exact child weights when the
        # heaviest shard's emit passes the threshold over the mean
        scan_copies = 0
        if (n_shards > 1
                and shard_tot.max() * n_shards
                > rebalance_threshold * new_total):
            t_r = time.perf_counter()
            weights = np.concatenate([
                c[: sizes[i]].cpu().numpy().astype(np.int64)
                for i, c in enumerate(counts)])
            scan_copies += n_shards
            new_bounds = dist.enum_row_blocks(weights, n_shards)
            if not np.array_equal(new_bounds, bounds):
                new_sizes = np.diff(new_bounds).astype(np.int64)
                caps = [_align_rows(n) for n in new_sizes]
                tables = dist.exchange_rows(tables, bounds, new_bounds, mesh,
                                            caps)
                # the scan's offsets follow from the weights on the host:
                # no recount on the devices
                for i, dev in enumerate(mesh.devices):
                    w = weights[new_bounds[i] : new_bounds[i + 1]]
                    off = np.zeros(caps[i] + 1, np.int64)
                    off[1 : w.size + 1] = np.cumsum(w)
                    scans[i] = torch.as_tensor(off, device=dev)
                    shard_tot[i] = w.sum()
                scan_copies += n_shards
                moved = int(sum(
                    max(0, new_sizes[i]
                        - max(0, min(new_bounds[i + 1], bounds[i + 1])
                              - max(new_bounds[i], bounds[i])))
                    for i in range(n_shards)))
                bounds, sizes = new_bounds, new_sizes
                rebalanced = True
                rebal_dt = time.perf_counter() - t_r
                stats["rebalance_rounds"] += 1
                stats["rebalance_rows_moved"] += moved
                stats["rebalance_seconds"] += rebal_dt
                obsv.span_at("enum.rebalance", t_r, t_r + rebal_dt,
                             level=t, rows_moved=moved)
        t1 = time.perf_counter()
        stats["scan_seconds"] += t1 - t0 - rebal_dt
        if traced:
            obsv.span_at("enum.scan", t0, t1, level=t, copies=scan_copies)

        # -- emit: each shard writes its exactly sized next table
        t0 = t1
        caps = [_align_rows(n) for n in shard_tot]
        tables = dist.enum_emit(tables, sizes, scans, shard_tot, caps, level,
                                rows_per)
        if traced:
            dist.sync(mesh)  # the emit's span then holds the device's work

        # advance: children become the next level's contiguous blocks
        sizes = shard_tot
        bounds = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        total = new_total
        stats["max_table_rows"] = max(stats["max_table_rows"], total)
        stats["max_emit_rows"] = max(stats["max_emit_rows"],
                                     n_shards * max(caps))
        stats["levels"].append(_level_record(
            t, sizes, rebalanced=rebalanced, rebalance_seconds=rebal_dt))
        if int(sizes.max()) > stats["emit_rows_max"]:
            stats["emit_rows_max"] = int(sizes.max())
            stats["emit_rows_min"] = int(sizes.min())
        t1 = time.perf_counter()
        stats["emit_seconds"] += t1 - t0
        if traced:
            obsv.span_at("enum.emit", t0, t1, level=t, rows=new_total,
                         copies=0)

    # assembly: the live prefixes in shard order are the global row order,
    # so truncation is a prefix: only the kept rows come back
    with obsv.span("enum.assemble") as assemble_span:
        n_keep = total if max_embeddings is None else min(total, max_embeddings)
        parts = []
        for i, tab in enumerate(tables):
            take = min(int(sizes[i]), n_keep - sum(len(p) for p in parts))
            if take > 0:
                parts.append(tab[:take].cpu().numpy())
        flat = (np.concatenate(parts) if parts
                else np.zeros((0, n_q), np.int32))
        if traced:
            assemble_span.set_attrs(copies=len(parts))
        if report is not None:
            report.update(stats)
        return _restore_query_order(flat, order)


def embeddings_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Set equality of embedding tables (row order independent)."""
    if a.shape != b.shape:
        return False
    if a.size == 0:
        return True
    return {tuple(r) for r in a.tolist()} == {tuple(r) for r in b.tolist()}
