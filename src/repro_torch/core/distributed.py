"""The partition authority and the sharded execution of the CNI engine,
port of ``repro.core.distributed``.

Every layer that shards anything (``graphs/store.py::ShardedGraphStore``,
``core/incremental.py::ShardedIncrementalIndex``, the single-query and
batched ILGF fixed points, the partitioned join and the service) takes its
partition from here:

* ``vertex_partition(V, n_shards)`` -> ``PartitionPlan``: contiguous equal
  slices of a padded vertex axis, shard *i* owning rows
  ``[i·v_local, (i+1)·v_local)``.  Pad rows carry ord 0 and alive False,
  exact no-ops for counts, digests and matching.
* ``device_mesh(n_shards, axis, devices)`` -> ``ShardMesh``: an ordered
  tuple of ``torch.device``s, one per shard, and an axis name.  The mesh
  is single-controller, as the reference's is: one Python process runs
  each shard's body on that shard's device.  By default every visible
  CUDA device is one shard; ``devices=`` places shards explicitly, so
  ``devices=["cuda:0"] * 4`` puts four shards on one card and
  ``devices="cpu"`` puts them on the host (the port's counterpart of
  ``--xla_force_host_platform_device_count``).
* ``shard_edges(src, dst, plan)`` -> per-shard directed edge buckets, each
  edge with the owner of its source, so every shard builds the count rows
  of exactly the vertices it owns.

The reference's ``shard_map`` collectives are explicit tensor operations
between the shards' devices, all defined in this module: ``all_gather`` (a
concatenation in shard order), ``psum`` (a sum), ``all_to_all`` (the join
step's piles) and ``exchange_rows`` (the rebalancer's order-preserving row
move).  Shards placed on one device share one copy of every replicated
tensor (the query digest, the alive mask, the join's candidate list and
edge-label matrix).  Per ILGF round each shard filters its own slice with
the ``cni_encode`` and ``candidate_filter`` kernels; the only cross-shard
traffic is the gather of the removal mask and the sum of the alive counts,
which decides retirement globally (peeling is monotone, so the count is
stationary exactly at the fixed point).

The count scatter of each shard is plain ``torch``, as it is plain ``jnp``
in the reference.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import filters as flt
from repro_torch.core.cni import default_max_p
from repro_torch.core.ilgf import IlgfResult, prepare_query
from repro_torch.core.labels import build_label_map, ord_of
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, as_numpy, graph_to, max_degree
from repro_torch.graphs.store import as_snapshot
from repro_torch.kernels.embed_join import ops as join_ops

# ---------------------------------------------------------------------------
# Partition authority: one plan shared by store, index, engines, service.
# ---------------------------------------------------------------------------


class PartitionPlan(NamedTuple):
    """Contiguous vertex partition: shard i owns ``[i*v_local, (i+1)*v_local)``.

    ``v_pad`` rounds the vertex axis up to a multiple of ``n_shards``; pad
    vertices (ids >= ``n_vertices``) never carry labels, edges or alive
    bits.  All fields are ints, so the plan is hashable.
    """

    n_shards: int
    n_vertices: int
    v_pad: int
    v_local: int

    def owner(self, v):
        """Owner shard of vertex id(s) ``v`` (host, numpy)."""
        return np.asarray(v) // self.v_local

    def bounds(self, shard: int) -> tuple[int, int]:
        """Owned range ``[lo, hi)`` of real vertex ids; both ends clamp to
        ``n_vertices``, so a shard that owns only padding gets an empty
        range."""
        lo = min(shard * self.v_local, self.n_vertices)
        return lo, min((shard + 1) * self.v_local, self.n_vertices)


def vertex_partition(n_vertices: int, n_shards: int) -> PartitionPlan:
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    v_pad = -(-max(1, n_vertices) // n_shards) * n_shards
    return PartitionPlan(n_shards, int(n_vertices), v_pad, v_pad // n_shards)


class ShardMesh(NamedTuple):
    """A 1-D mesh: the device of each shard, in shard order, and the axis
    name.  Hashable."""

    devices: tuple
    axis: str = "data"

    @property
    def n_shards(self) -> int:
        return len(self.devices)


def _placed(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_mesh(n_shards: int | None = None, axis: str = "data",
                devices=None) -> ShardMesh:
    """A mesh of ``n_shards`` shards over ``axis``.

    ``devices=None``: one shard per visible CUDA device (all of them when
    ``n_shards`` is None); asking for more shards than there are visible
    devices raises.  ``devices`` may instead name one device for every
    shard (``"cpu"``, ``"cuda:0"``) or list each shard's device.
    """
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if devices is None:
        resolve_device(None)  # no card: raises instead of using the host
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_shards is None:
            n_shards = len(visible)
        if n_shards > len(visible):
            raise ValueError(
                f"requested {n_shards} shards but only {len(visible)} "
                "devices are visible (pass devices= to place several shards "
                "on one device)")
        placed = visible[:n_shards]
    else:
        if isinstance(devices, (str, torch.device)):
            devices = [devices] * (1 if n_shards is None else n_shards)
        placed = [_placed(d) for d in devices]
        if n_shards is not None and len(placed) != n_shards:
            raise ValueError(
                f"devices= lists {len(placed)} devices for {n_shards} shards")
    return ShardMesh(tuple(placed), axis)


def mesh_shards(mesh, axis: str = "data") -> int:
    """The shard count of ``mesh`` along ``axis`` (checked)."""
    if not isinstance(mesh, ShardMesh):
        raise TypeError(
            f"mesh must be a ShardMesh from device_mesh(), got "
            f"{type(mesh).__name__}")
    if mesh.axis != axis:
        raise ValueError(f"mesh axis is {mesh.axis!r}, not {axis!r}")
    return mesh.n_shards


# ---------------------------------------------------------------------------
# Collectives: explicit cross-device tensor operations, in shard order.
# ---------------------------------------------------------------------------


def replicate(x, mesh: ShardMesh) -> list:
    """``x`` (a tensor, or a named tuple of them such as a query digest) on
    every shard's device: one copy per distinct device, shared by the
    shards placed there."""
    copies: dict = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = _tree_to(x, dev)
        out.append(copies[dev])
    return out


def _tree_to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_to(f, dev) for f in x))
    return x


def all_gather(parts: Sequence[torch.Tensor], mesh: ShardMesh,
               dim: int = 0) -> list:
    """Shard i's ``parts[i]`` -> their concatenation in shard order along
    ``dim``, on every shard's device (one copy per distinct device)."""
    copies: dict = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = torch.cat([p.to(dev) for p in parts], dim)
        out.append(copies[dev])
    return out


def gather_to(parts: Sequence[torch.Tensor], device, dim: int = 0):
    """The concatenation of the shards' parts, on one device."""
    return torch.cat([p.to(device) for p in parts], dim)


def psum(parts: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of the shards' parts, on one device."""
    return torch.stack([p.to(device) for p in parts]).sum(0)


def all_to_all(piles: Sequence[Sequence[torch.Tensor]],
               mesh: ShardMesh) -> list:
    """``piles[j][i]`` is what shard j sends shard i; shard i receives
    ``[piles[0][i], ..., piles[D-1][i]]`` on its device, in sender order."""
    return [[piles[j][i].to(dev) for j in range(len(piles))]
            for i, dev in enumerate(mesh.devices)]


def exchange_rows(tables: Sequence[torch.Tensor], old_bounds, new_bounds,
                  mesh: ShardMesh, caps: Sequence[int]) -> list:
    """Recut a row-partitioned table onto new contiguous blocks.

    Shard d holds global rows ``[old_bounds[d], old_bounds[d+1])`` at the
    top of ``tables[d]``; shard i receives rows
    ``[new_bounds[i], new_bounds[i+1])`` from the shards that hold them, in
    global row order, into a zeroed ``(caps[i], T)`` buffer on its device.
    Order-preserving by construction.
    """
    width = tables[0].shape[1]
    out = []
    for i, dev in enumerate(mesh.devices):
        a, b = int(new_bounds[i]), int(new_bounds[i + 1])
        pieces = []
        for s, tab in enumerate(tables):
            lo = max(a, int(old_bounds[s]))
            hi = min(b, int(old_bounds[s + 1]))
            if hi > lo:
                base = int(old_bounds[s])
                pieces.append(tab[lo - base : hi - base].to(dev))
        buf = torch.zeros((caps[i], width), dtype=torch.int32, device=dev)
        if pieces:
            buf[: b - a] = torch.cat(pieces)
        out.append(buf)
    return out


def on_device(dev: torch.device):
    """The context a shard's kernels launch in: its card made current (a
    kernel launches on the current device's context), or nothing on the
    host."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def sync(mesh: ShardMesh) -> None:
    """Wait for every device of the mesh."""
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# Per-shard edge buckets.
# ---------------------------------------------------------------------------


class ShardedEdges(NamedTuple):
    """Per-shard directed edge buckets: ``edge_src[i]`` / ``edge_dst[i]``
    (int32, on shard i's device) hold the edges whose source shard i owns,
    in the reference's bucket order (the reference pads them to one
    length; here each bucket has its own)."""

    edge_src: tuple
    edge_dst: tuple


def _by_owner(src: torch.Tensor, dst: torch.Tensor, owner: torch.Tensor,
              mesh: ShardMesh | None, n_shards: int) -> list:
    """``(src, dst)`` split by owner shard, each part in input order and on
    its shard's device (the host without a mesh), int32."""
    out = []
    for i in range(n_shards):
        dev = mesh.devices[i] if mesh is not None else torch.device("cpu")
        keep = owner == i
        out.append((src[keep].to(dev, torch.int32),
                    dst[keep].to(dev, torch.int32)))
    return out


def shard_edges(src, dst, plan: PartitionPlan,
                mesh: ShardMesh | None = None) -> ShardedEdges:
    """Bucket directed (symmetrized) edges by the owner shard of ``src``,
    each bucket on its shard's device (the host without a mesh); the
    masks run where the edges lie.

    Each undirected edge appears twice in the symmetrized list, so a
    cross-shard edge lands in both endpoint owners' buckets, each in the
    direction that feeds its owned count row.
    """
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    buckets = _by_owner(src, dst, src // plan.v_local, mesh, plan.n_shards)
    return ShardedEdges(tuple(b[0] for b in buckets),
                        tuple(b[1] for b in buckets))


def prepare_sharded_edges(data, mesh: ShardMesh, axis: str = "data"):
    """Any graph-like input -> (ShardedEdges, PartitionPlan, Graph).

    ``data`` is a ``Graph``, a store or a ``GraphSnapshot``.  A snapshot of
    a ``ShardedGraphStore`` with the mesh's shard count reuses the store's
    per-shard canonical tables: table i's ``(lo -> hi)`` edges already
    belong to shard i, and only the reverse directions are routed, one
    partition pass over each table's ``hi`` endpoints on its shard's
    device.  Anything else buckets the snapshot graph's edge list where it
    lies.
    """
    snap = as_snapshot(data)
    g = snap.graph
    plan = vertex_partition(g.n_vertices, mesh_shards(mesh, axis))
    tables = snap.shards
    if tables is None or len(tables) != plan.n_shards:
        return shard_edges(g.src, g.dst, plan, mesh), plan, g
    fwd = [(torch.as_tensor(t[0]).to(dev, torch.int32),
            torch.as_tensor(t[1]).to(dev, torch.int32))
           for t, dev in zip(tables, mesh.devices)]
    rev = [_by_owner(f_hi, f_lo, f_hi // plan.v_local, mesh, plan.n_shards)
           for f_lo, f_hi in fwd]
    return ShardedEdges(
        tuple(torch.cat([fwd[i][0]] + [r[i][0] for r in rev])
              for i in range(plan.n_shards)),
        tuple(torch.cat([fwd[i][1]] + [r[i][1] for r in rev])
              for i in range(plan.n_shards)),
    ), plan, g


# ---------------------------------------------------------------------------
# Local (per-shard) filtering building blocks.
# ---------------------------------------------------------------------------


def _local_counts(es: torch.Tensor, ed: torch.Tensor, ords: torch.Tensor,
                  alive: torch.Tensor, v_lo: int, v_local: int,
                  n_labels: int) -> torch.Tensor:
    """(..., v_local, L) int32 count rows of the owned slice, from the
    shard's bucket.  ``ords`` and ``alive`` are (..., V_pad) replicated."""
    lead = ords.shape[:-1]
    ords2 = ords.reshape(-1, ords.shape[-1])
    alive2 = alive.reshape(-1, alive.shape[-1])
    ord_dst = ords2[:, ed]
    ok = (ord_dst > 0) & (ords2[:, es] > 0) & alive2[:, ed] & alive2[:, es]
    idx = (es.to(torch.int64) - v_lo)[None, :] * n_labels + (
        ord_dst.to(torch.int64) - 1).clamp_min(0)
    flat = torch.zeros((ords2.shape[0], v_local * n_labels),
                       dtype=torch.int32, device=ords.device)
    flat.scatter_add_(1, idx, ok.to(torch.int32))
    return flat.reshape(lead + (v_local, n_labels))


def local_match_matrix(variant: str, counts: torch.Tensor,
                       my_ords: torch.Tensor, q, d_max: int,
                       max_p: int) -> torch.Tensor:
    """(..., Vl, U) candidate grid over a local vertex slice.

    Every supported variant needs only the slice's own count rows and the
    replicated query digest, so no collective runs inside a round.
    ``mnd_nlf`` inspects neighbour digests (a per-round halo exchange) and
    is not offered on the sharded path.
    """
    if variant == "nlf":
        return flt.nlf_match(counts, q.counts, my_ords, q.digest.ord_label)
    if variant == "label_degree":
        deg = counts.sum(-1).to(torch.int32)
        do = my_ords[..., :, None]
        lab = (do == q.digest.ord_label[..., None, :]) & (do > 0)
        return lab & (deg[..., :, None] >= q.digest.deg[..., None, :])
    if variant in ("cni", "cni_log"):
        digest = flt.make_digest(counts, my_ords, d_max, max_p)
        if variant == "cni":
            return flt.cni_match(digest, q.digest)
        return flt.cni_match_log(digest, q.digest)
    raise ValueError(
        f"filter variant {variant!r} is not supported on the sharded path "
        "(mnd_nlf needs neighbor digests — a per-round halo exchange; see "
        "DESIGN.md §9)")


# ---------------------------------------------------------------------------
# Single-query partitioned ILGF fixed point.
# ---------------------------------------------------------------------------


def distributed_ilgf(data, query: Graph, mesh: ShardMesh | None = None, *,
                     axis: str = "data", variant: str = "cni",
                     d_max: int | None = None, max_p: int | None = None,
                     alive0=None, max_iters: int = 1_000,
                     prepared=None) -> IlgfResult:
    """ILGF fixed point on a vertex-partitioned graph, equal to ``ilgf``
    bit for bit: the same alive mask, candidate columns and round count.

    ``data`` is a ``Graph``, a store or a ``GraphSnapshot``; ``alive0`` an
    optional sound starting mask (the store-digest prefilter).  Per round
    each shard counts, digests (``cni_encode``) and matches
    (``candidate_filter``) its own slice; ``all_gather`` broadcasts the
    new mask and ``psum`` of the alive counts decides retirement.
    ``prepared``: ``(ShardedEdges, PartitionPlan, Graph)`` from an earlier
    ``prepare_sharded_edges``.  The result lies on the first shard's
    device.
    """
    if mesh is None:
        mesh = device_mesh(axis=axis)
    n_shards = mesh_shards(mesh, axis)
    se, plan, g = (prepared if prepared is not None
                   else prepare_sharded_edges(data, mesh, axis))
    if plan.n_shards != n_shards:
        raise ValueError(f"prepared edges have {plan.n_shards} shards, the "
                         f"mesh {n_shards}")
    if d_max is None:
        d_max = max(1, max_degree(g))
    label_map = build_label_map(query, device=g.vlabels.device)
    n_labels = label_map.n_labels
    if max_p is None:
        max_p = default_max_p(d_max, n_labels)
    dev0 = mesh.devices[0]
    qs = replicate(prepare_query(graph_to(query, dev0), d_max, max_p),
                           mesh)
    ords = torch.zeros(plan.v_pad, dtype=torch.int32, device=dev0)
    ords[: g.n_vertices] = ord_of(label_map, g.vlabels).to(dev0)
    a0 = ords > 0
    if alive0 is not None:
        a0[: g.n_vertices] &= torch.as_tensor(alive0, dtype=torch.bool,
                                              device=dev0)
    ords_r = replicate(ords, mesh)
    alive = replicate(a0, mesh)
    v_local = plan.v_local

    def local_match(i, alive_i):
        v_lo = i * v_local
        with on_device(mesh.devices[i]):
            counts = _local_counts(se.edge_src[i], se.edge_dst[i], ords_r[i],
                                   alive_i, v_lo, v_local, n_labels)
            return local_match_matrix(variant, counts,
                                      ords_r[i][v_lo : v_lo + v_local],
                                      qs[i], d_max, max_p)

    iters = 0
    changed = True
    while changed and iters < max_iters:
        new_local, n_old, n_now = [], [], []
        for i in range(n_shards):
            my_alive = alive[i][i * v_local : (i + 1) * v_local]
            keep = my_alive & local_match(i, alive[i]).any(1)
            new_local.append(keep)
            n_old.append(my_alive.sum())
            n_now.append(keep.sum())
        # the two collectives of a round: the mask broadcast and the
        # alive-count sum that decides retirement on every shard at once
        alive = all_gather(new_local, mesh)
        changed = bool(psum(n_now, dev0) != psum(n_old, dev0))
        iters += 1
    cand = [local_match(i, alive[i])
            & alive[i][i * v_local : (i + 1) * v_local, None]
            for i in range(n_shards)]
    n = g.n_vertices
    return IlgfResult(alive=alive[0][:n],
                      candidates=gather_to(cand, dev0)[:n],
                      iterations=iters)


# ---------------------------------------------------------------------------
# Batched sharded peeling round (batch engine / serving tick unit).
# ---------------------------------------------------------------------------


def sharded_batched_ilgf_round(se: ShardedEdges, plan: PartitionPlan, qb,
                               alive: torch.Tensor, *, mesh: ShardMesh,
                               axis: str = "data", n_labels: int, d_max: int,
                               max_p: int, variant: str):
    """One batched peeling round, vertex-partitioned: the drop-in twin of
    ``batch_engine.batched_ilgf_round``, returning ``(new_alive (S, V),
    candidates (S, V, U), changed (S,))`` on ``alive``'s device.

    The batch axis is replicated; each shard encodes and matches exactly
    its owned slice (one ``cni_encode`` and one ``candidate_filter`` launch
    a shard), and retirement is decided by the summed alive counts.
    """
    n_shards = mesh_shards(mesh, axis)
    if plan.n_shards != n_shards:
        raise ValueError(f"plan has {plan.n_shards} shards, the mesh "
                         f"{n_shards}")
    out_dev = alive.device
    v = alive.shape[-1]
    pad = plan.v_pad - v
    ords = torch.nn.functional.pad(qb.ords, (0, pad))
    alive_p = torch.nn.functional.pad(alive, (0, pad))
    qbs = replicate(qb._replace(ords=ords), mesh)
    alive_r = replicate(alive_p, mesh)
    v_local = plan.v_local
    new_local, cand_local, n_old, n_now = [], [], [], []
    for i in range(n_shards):
        v_lo = i * v_local
        with on_device(mesh.devices[i]):
            counts = _local_counts(se.edge_src[i], se.edge_dst[i],
                                   qbs[i].ords, alive_r[i], v_lo, v_local,
                                   n_labels)
            match = local_match_matrix(variant, counts,
                                       qbs[i].ords[:, v_lo : v_lo + v_local],
                                       qbs[i], d_max, max_p)
        my_alive = alive_r[i][:, v_lo : v_lo + v_local]
        keep = my_alive & match.any(-1)
        new_local.append(keep)
        cand_local.append(match & keep[..., None])
        n_old.append(my_alive.sum(-1))
        n_now.append(keep.sum(-1))
    new_alive = gather_to(new_local, out_dev, 1)[:, :v]
    cand = gather_to(cand_local, out_dev, 1)[:, :v]
    return new_alive, cand, psum(n_now, out_dev) != psum(n_old, out_dev)


# ---------------------------------------------------------------------------
# Distributed join search with a round-robin all_to_all rebalance.
# ---------------------------------------------------------------------------


def distributed_join_step(mesh: ShardMesh, tables, n_rows, cand, cand_valid,
                          elab, q_pos, q_lab, q_valid, cap: int):
    """One distributed expansion: each shard's validity grid (the
    ``embed_join`` kernel), local compaction to ``cap`` rows, and a
    round-robin ``all_to_all`` of ``cap // D``-row piles.  ``tables[i]``
    (cap, t) int32 and the replicated level inputs lie on shard i's device;
    ``n_rows`` is a host list.  Returns (new tables, new row counts,
    overflowed)."""
    n_shards = mesh.n_shards
    per = cap // n_shards
    piles, overflow = [], False
    for i, dev in enumerate(mesh.devices):
        tab = tables[i]
        rows_valid = torch.arange(cap, device=dev) < n_rows[i]
        with on_device(dev):
            valid = join_ops.embed_join(tab, rows_valid, cand[i],
                                        cand_valid[i], elab[i], q_pos[i],
                                        q_lab[i], q_valid[i])
        r_idx, c_idx = torch.nonzero(valid, as_tuple=True)  # row-major
        overflow = overflow or r_idx.shape[0] > cap
        r_idx, c_idx = r_idx[:cap], c_idx[:cap]
        new = torch.cat([tab[r_idx], cand[i][c_idx][:, None]], dim=1)
        # deal the local rows into D piles of ``per`` rows
        piles.append([new[j * per : (j + 1) * per] for j in range(n_shards)])
    received = all_to_all(piles, mesh)
    out, counts = [], []
    for i, dev in enumerate(mesh.devices):
        rows = torch.cat(received[i])
        buf = torch.zeros((cap, rows.shape[1]), dtype=torch.int32, device=dev)
        buf[: rows.shape[0]] = rows
        out.append(buf)
        counts.append(int(rows.shape[0]))
    return out, counts, overflow


def distributed_join_search(data: Graph, query: Graph, candidates, mesh:
                            ShardMesh, *, axis: str = "data", cap: int = 4096,
                            order=None):
    """Enumerate embeddings with row-sharded tables and a round-robin
    rebalance every step.  Returns ``(emb, overflowed)``.

    ``cap`` rows per shard; an overflow is reported, not recovered.  The
    row order depends on the shard count (rows are dealt into piles), so
    only the set of rows is comparable across meshes.
    """
    from repro_torch.core.search import (
        _dense_edge_labels,
        _host_adjacency,
        _level_constraints,
        _matching_order,
    )

    n_shards = mesh_shards(mesh, axis)
    if cap % n_shards:
        raise ValueError(f"cap {cap} must divide evenly across {n_shards} "
                         "shards")
    cand = as_numpy(candidates)
    n_q = query.n_vertices
    q_adj = _host_adjacency(query)
    elab = replicate(torch.as_tensor(_dense_edge_labels(data, data.n_vertices)),
                     mesh)
    order = _matching_order(order, cand, q_adj, n_q)
    pos_of = {u: i for i, u in enumerate(order)}

    seeds = np.nonzero(cand[:, order[0]])[0].astype(np.int32)
    tables, n_rows = [], []
    for i, dev in enumerate(mesh.devices):
        mine = seeds[i::n_shards]
        tab = np.zeros((cap, 1), np.int32)
        tab[: mine.size, 0] = mine
        tables.append(torch.as_tensor(tab, device=dev))
        n_rows.append(int(mine.size))
    overflowed = False
    for t in range(1, n_q):
        u = order[t]
        cand_ids = np.nonzero(cand[:, u])[0].astype(np.int32)
        q_pos, q_lab, q_val = _level_constraints(q_adj, pos_of, u, t)
        c = max(1, cand_ids.size)
        cand_pad = np.zeros(c, np.int32)
        cand_pad[: cand_ids.size] = cand_ids
        tables, n_rows, ovf = distributed_join_step(
            mesh, tables, n_rows,
            replicate(torch.as_tensor(cand_pad), mesh),
            replicate(torch.arange(c) < cand_ids.size, mesh), elab,
            *(replicate(torch.as_tensor(x), mesh)
              for x in (q_pos, q_lab, q_val)),
            cap)
        overflowed = overflowed or ovf
    flat = np.concatenate([tables[i][: n_rows[i]].cpu().numpy()
                           for i in range(n_shards)], axis=0)
    out = np.zeros((flat.shape[0], n_q), dtype=np.int64)
    for i, u in enumerate(order):
        out[:, u] = flat[:, i]
    return out, overflowed


# ---------------------------------------------------------------------------
# Mesh-partitioned two-phase enumeration: the per-shard steps of
# ``core/search.py::sharded_device_join_search``.  The partial-embedding
# table is partitioned by row into one contiguous block per shard, in shard
# order, so the global row order is the concatenation of the shards' live
# prefixes.  (The reference's host-assisted valid and gather steps serve its
# CPU route; the port has one route, the kernels' or their plain versions'.)
# ---------------------------------------------------------------------------


def enum_rows_per(c_pad: int, j: int) -> int:
    """Rows of one count/emit launch: a (R·C·J) budget of 2^24 cells, a
    power of two in [256, 4096]."""
    rows = (1 << 24) // max(1, c_pad * j)
    rows = max(256, 1 << max(0, rows.bit_length() - 1))
    return min(rows, 4096)


def enum_row_blocks(weights, n_shards: int) -> np.ndarray:
    """Contiguous weighted row split: boundaries ``(n_shards + 1,)``.

    Greedily cuts the row sequence at the ideal cumulative-weight
    quantiles (``i · total / n_shards``), never splitting a row, so a
    parent row stays with all its children.  Equal prefix sums cut at the
    smallest row index.  With unit weights this is the equal-rows split
    that seeds the table.
    """
    w = np.asarray(weights, dtype=np.int64).reshape(-1)
    n_rows = int(w.size)
    bounds = np.zeros(n_shards + 1, dtype=np.int64)
    bounds[n_shards] = n_rows
    if n_rows == 0 or n_shards == 1:
        return bounds
    prefix = np.cumsum(w)
    total = int(prefix[-1])
    if total == 0:
        # all-zero weights: equal row counts
        bounds[1:n_shards] = [(i * n_rows) // n_shards
                              for i in range(1, n_shards)]
        return bounds
    targets = np.arange(1, n_shards, dtype=np.float64) * (total / n_shards)
    cuts = np.searchsorted(prefix, targets, side="left") + 1
    bounds[1:n_shards] = np.minimum(cuts, n_rows)
    return np.maximum.accumulate(bounds)


def _slices(n_rows: int, rows_per: int):
    """(lo, hi) bounds of the launches over ``n_rows`` live rows."""
    return [(lo, min(lo + rows_per, n_rows))
            for lo in range(0, n_rows, rows_per)]


def enum_count(tables, sizes, level, rows_per: int, counts, scans) -> None:
    """Per-shard count phase into the join's per-query buffers: shard i's
    per-row survivor counts into ``counts[i][:n]`` (``count_live``, one
    launch per row slice of its ``n = sizes[i]`` live rows) and their
    scan into ``scans[i][1 : n + 1]`` (int64; ``scans[i][0]`` is 0), so
    ``scans[i][:n]`` holds the exclusive row offsets and ``scans[i][n]``
    the shard's total, all on the shard's device.  ``level`` holds the
    replicated (cand, elab, q_pos, q_lab) lists."""
    for i, tab in enumerate(tables):
        n = int(sizes[i])
        if n == 0:
            continue
        cand, elab, q_pos, q_lab = (x[i] for x in level)
        with on_device(tab.device):
            for lo, hi in _slices(n, rows_per):
                join_ops.count_live(counts[i][lo:hi], tab[lo:hi], cand, elab,
                                    q_pos, q_lab)
        torch.cumsum(counts[i][:n], 0, dtype=torch.int64,
                     out=scans[i][1 : n + 1])


def read_totals(scans, sizes, host: torch.Tensor) -> np.ndarray:
    """The shards' totals ``scans[i][sizes[i]]`` on the host: one
    ``non_blocking`` copy per shard into ``host`` ((D,) int64, pinned when a
    shard lies on a card), then one wait per distinct card's stream."""
    for i, scan in enumerate(scans):
        n = int(sizes[i])
        host[i : i + 1].copy_(scan[n : n + 1], non_blocking=True)
    for dev in dict.fromkeys(scan.device for scan in scans):
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
    return host.numpy().copy()


def enum_emit(tables, sizes, scans, shard_tot, caps, level,
              rows_per: int) -> list:
    """Per-shard emit phase: shard i writes its survivors' rows (the parent
    row, then the candidate) at their scan slots of a zeroed ``(caps[i],
    T + 1)`` next table (``emit_table_live``, one launch per row slice)."""
    out = []
    for i, tab in enumerate(tables):
        nxt = torch.zeros((caps[i], tab.shape[1] + 1), dtype=torch.int32,
                          device=tab.device)
        if shard_tot[i]:
            cand, elab, q_pos, q_lab = (x[i] for x in level)
            with on_device(tab.device):
                for lo, hi in _slices(int(sizes[i]), rows_per):
                    join_ops.emit_table_live(nxt, tab[lo:hi], cand, elab,
                                             q_pos, q_lab, scans[i][lo:hi])
        out.append(nxt)
    return out
