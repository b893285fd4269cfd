"""Incrementally maintained CNI index over a mutable graph store, port of
``repro.core.incremental``.

``IncrementalIndex`` keeps, on its store's device, the
per-vertex label-count matrix ``counts[v, l]`` over the store's label
universe (every vertex label; the vertex set is fixed, so the universe is
too), the label degree, the exact int64 CNI digest (saturating at SAT64)
and the float32 log digest.  An applied edge batch is a count-vector
delta:

* **Counts.**  Insert/delete of (u, w) adds/subtracts 1 at
  ``counts[u, col(w)]`` and ``counts[w, col(u)]``.  The batch's delta over
  its frontier (the sorted unique endpoints) is scattered on the device
  into an (F, Lu) matrix, and the ``cni_update`` kernel adds it to the
  frontier rows and re-encodes them in one pass; the new rows go back to
  ``counts``.
* **Digests re-encode only the frontier**, with the reference's partition:
  an insert-only touch of a saturated digest keeps it (the CNI is monotone
  and saturation sticky: ``saturated_skips``); a saturated row that took a
  delete is recomputed from its exact counts (``saturated_recomputes``); a
  row whose degree passes ``d_max`` grows the tables (next power of two)
  and re-encodes everything (``full_rebuilds``).  Only the rows the
  partition re-encodes get the new digests.
* **One encoder.**  ``rebuild`` and the auto-grow path encode with
  ``cni_encode``, the batch path with ``cni_update``; the two kernels share
  their row walk, so incremental state equals a scratch rebuild bit for
  bit on the card, as the plain versions make it equal on the CPU.

Engines read the index through ``store_prefilter``: the round-0 candidate
mask of a query from the maintained counts and digests, with no edge
scatter and no full-graph encode.

``checkpoint_state`` / ``from_checkpoint_state`` carry the maintained
state through the durable tier (``serve/persist.py``), so a restore is
warm: no rebuild, hence no ``cni_encode``.  The restore also reads a
snapshot the reference wrote, whose exact digest is the uint64 leaf
``cni_u64``.  ``ShardedIncrementalIndex`` keeps the same state per shard
of a ``ShardedGraphStore``, bit-identical once merged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointError
from repro_torch.core import filters as flt
from repro_torch.core.batch_engine import ceil_pow2, prepare_padded_query
from repro_torch.core.cni import LOG_SAT64, SAT64, default_max_p
from repro_torch.core.distributed import vertex_partition
from repro_torch.core.stats import GraphStats, alive_edge_blocks
from repro_torch.graphs.csr import as_numpy
from repro_torch.device import resolve_device
from repro_torch.graphs.store import EdgeBatch, GraphStore
from repro_torch.kernels.cni_encode import ops as encode_ops
from repro_torch.kernels.cni_update import ops as update_ops


@dataclass
class IndexStats:
    applied_batches: int = 0
    edges_inserted: int = 0
    edges_deleted: int = 0
    touched_vertices: int = 0
    reencoded_vertices: int = 0
    saturated_skips: int = 0        # saturated digest + insert-only: no work
    saturated_recomputes: int = 0   # saturated digest + delete: re-encoded
    full_rebuilds: int = 0          # d_max overflow (auto-grown tables)
    boundary_exchanged: int = 0     # cross-shard records (sharded index)
    extras: dict = field(default_factory=dict)


class IndexSnapshot(NamedTuple):
    """Frozen copy of the index state at one store epoch; travels inside
    ``GraphSnapshot.index``.  Tensors lie on the index's device."""

    epoch: int
    universe: np.ndarray   # (Lu,) sorted unique raw vertex labels
    vlabels: np.ndarray    # (V,) raw vertex labels (shared, immutable)
    counts: torch.Tensor   # (V, Lu) int32
    deg: torch.Tensor      # (V,) int32
    cni: torch.Tensor      # (V,) int64 exact saturating CNI (universe ords)
    cni_log: torch.Tensor  # (V,) float32 canonical log CNI (universe ords)
    d_max: int
    max_p: int
    stats: object = None   # frozen core.stats.GraphStats (planner input)


def _canonical_log(cni: torch.Tensor, log: torch.Tensor) -> torch.Tensor:
    """Rows whose exact digest is saturated carry ``LOG_SAT64``.

    The float log digest has no saturation of its own, so the insert-skip
    path would leave it stale on saturated rows; ``cni_match_log`` passes
    values at or above ``LOG_SAT64`` through, so this is exact, and it keeps
    incremental and scratch states bit-identical.
    """
    return torch.where(cni == SAT64, torch.full_like(log, LOG_SAT64), log)


class IncrementalIndex:
    """Label-count matrix + CNI digest state for a ``GraphStore``.

    Attach with ``store.attach_index(IncrementalIndex())``; the store then
    calls ``apply_batch`` with exactly the records that changed the edge
    set.  ``d_max`` is the tables' degree bound: pinned by the argument or
    the store's ``degree_cap``, else the next power of two of the store's
    maximum degree, grown when a batch passes it.
    """

    def __init__(self, *, d_max: int | None = None):
        self._d_max_arg = d_max
        self.stats = IndexStats()
        self.graph_stats: GraphStats | None = None  # set by rebuild()
        self._epoch = -1  # set by rebuild()

    # -- (re)build -----------------------------------------------------------

    def rebuild(self, store: GraphStore) -> None:
        """Full build from the store's current edge set: scatters of its
        2|E| records into (V, Lu) counts, block by block, then
        ``cni_encode``."""
        self.counts = self._count_edges(store)
        self._encode_all()
        # the planner's statistics ride along, rebuilt with the counts
        self.graph_stats = GraphStats.from_store(store)
        self._epoch = store.epoch

    def _count_edges(self, store) -> torch.Tensor:
        """Set the tables' bounds from ``store`` and return its (V, Lu)
        int32 count matrix, built on the store's device."""
        self.device = store.device  # the store alone decides where
        self.universe = np.unique(store.vlabels)
        self.vlabels = store.vlabels
        v = store.n_vertices
        lu = int(self.universe.size)
        if self._d_max_arg is not None:
            self.d_max = int(self._d_max_arg)
        elif store.degree_cap is not None:
            self.d_max = int(store.degree_cap)
        else:
            self.d_max = ceil_pow2(max(4, store.max_degree))
        self.max_p = default_max_p(self.d_max, lu)
        self._col_of = np.searchsorted(self.universe, self.vlabels)
        counts = torch.zeros(v * lu, dtype=torch.int32, device=self.device)
        col = torch.as_tensor(self._col_of, device=self.device)
        # one index_add_ per block of the store's alive edges: an
        # out-of-core store streams its chunks, and the integer sums equal
        # a one-shot build's
        for lo, hi, _ in alive_edge_blocks(store):
            if lo.size:
                lo_t = torch.as_tensor(lo, device=self.device)
                hi_t = torch.as_tensor(hi, device=self.device)
                flat = torch.cat([lo_t * lu + col[hi_t], hi_t * lu + col[lo_t]])
                del lo_t, hi_t
                counts.index_add_(0, flat, torch.ones(
                    flat.shape, dtype=torch.int32, device=self.device))
                del flat
        return counts.view(v, lu)

    def _encode_rows(self, sub: torch.Tensor):
        """(k, Lu) count rows -> (deg, cni, canonical log) digest rows."""
        deg, cni, log = encode_ops.cni_encode(sub, self.d_max, self.max_p)
        return deg, cni, _canonical_log(cni, log)

    def _encode_all(self) -> None:
        self.deg, self.cni, self.cni_log = self._encode_rows(self.counts)

    # -- incremental maintenance --------------------------------------------

    def frontier_delta(self, applied: EdgeBatch):
        """The batch's frontier and its count delta.

        Returns ``(frontier, rows, delta)``: the sorted unique endpoints
        (F,) int64 on the host, their current count rows and the batch's
        net change to them, both (F, Lu) int32 on the index's device.
        """
        lo, hi = applied.src, applied.dst
        sign = np.where(applied.insert, 1, -1).astype(np.int32)
        frontier = np.unique(np.concatenate([lo, hi]))
        lu = int(self.universe.size)
        at_lo = np.searchsorted(frontier, lo)
        at_hi = np.searchsorted(frontier, hi)
        flat = np.concatenate([at_lo * lu + self._col_of[hi],
                               at_hi * lu + self._col_of[lo]])
        delta = torch.zeros(frontier.size * lu, dtype=torch.int32,
                            device=self.device)
        delta.index_add_(0, torch.as_tensor(flat, device=self.device),
                         torch.as_tensor(np.concatenate([sign, sign]),
                                         device=self.device))
        rows = self.counts[torch.as_tensor(frontier, device=self.device)]
        return frontier, rows, delta.view(frontier.size, lu)

    def apply_batch(self, store: GraphStore, applied: EdgeBatch) -> None:
        """Fold one applied batch into counts and digests (frontier only)."""
        st = self.stats
        st.applied_batches += 1
        sign = np.where(applied.insert, 1, -1).astype(np.int32)
        st.edges_inserted += int(applied.insert.sum())
        st.edges_deleted += int((~applied.insert).sum())
        self._fold_graph_stats(store, applied.src, applied.dst, sign)

        frontier, rows, delta = self.frontier_delta(applied)
        st.touched_vertices += int(frontier.size)
        new_rows, new_deg, new_cni, new_log = update_ops.cni_update(
            rows, delta, self.d_max, self.max_p)
        at = torch.as_tensor(frontier, device=self.device)
        self.counts[at] = new_rows
        max_deg = int(new_deg.max())  # the batch's one device sync
        if max_deg > self.d_max:
            # the tables' degree bound is passed: grow it and re-encode all
            self.d_max = ceil_pow2(max_deg)
            self.max_p = default_max_p(self.d_max, int(self.universe.size))
            self._encode_all()
            st.full_rebuilds += 1
            self._epoch = store.epoch
            return
        self.deg[at] = new_deg

        # partition the frontier by the saturation rules
        sat = self.cni[at] == SAT64
        dec = torch.as_tensor(_decreased(applied, frontier), device=self.device)
        skip = sat & ~dec  # stays saturated: provably no change
        n_skip, n_recompute, n_redo = torch.stack(
            [skip.sum(), (sat & dec).sum(), (~skip).sum()]).tolist()
        st.saturated_skips += n_skip
        st.saturated_recomputes += n_recompute
        st.reencoded_vertices += n_redo
        redo = ~skip
        self.cni[at[redo]] = new_cni[redo]
        self.cni_log[at[redo]] = _canonical_log(new_cni, new_log)[redo]
        self._epoch = store.epoch

    def _fold_graph_stats(self, store, lo, hi, sign) -> None:
        """Fold the applied records into the planner statistics: the column
        ids are in hand, so no edge-table scan is needed."""
        if self.graph_stats is not None:
            self.graph_stats.apply_records(
                self._col_of[lo], self._col_of[hi], sign, epoch=store.epoch)

    # -- durable snapshots ---------------------------------------------------

    def checkpoint_state(self):
        """``(leaves, meta)`` of the maintained state, exactly: a warm
        restore skips the rebuild.  Leaves are the device tensors as they
        stand (the checkpoint manager copies them to the host before its
        writer starts); the planner's ``GraphStats`` rides along under a
        ``stats_`` prefix."""
        leaves = {
            "universe": self.universe,
            "vlabels": self.vlabels,
            "counts": self.counts,
            "deg": self.deg,
            "cni": self.cni,
            "cni_log": self.cni_log,
        }
        meta = {
            "type": type(self).__name__,
            "d_max": int(self.d_max),
            "d_max_arg": self._d_max_arg,
            "max_p": int(self.max_p),
            "epoch": int(self._epoch),
            "stats": None,
        }
        if self.graph_stats is not None:
            s_leaves, s_meta = self.graph_stats.checkpoint_state()
            leaves.update({f"stats_{k}": v for k, v in s_leaves.items()})
            meta["stats"] = s_meta
        return leaves, meta

    @classmethod
    def from_checkpoint_state(cls, leaves, meta, *, store=None, device=None):
        """Rebuild the maintained state from ``checkpoint_state()`` output,
        checked against itself, on ``store.device`` (else ``device``;
        ``None`` means ``"cuda"``).  A snapshot of the reference carries
        the exact digest as uint64 ``cni_u64`` (at most SAT64), read here
        as the port's int64 ``cni``."""
        cni_key = "cni" if "cni" in leaves else "cni_u64"
        for k in ("universe", "vlabels", "counts", "deg", cni_key, "cni_log"):
            if k not in leaves:
                raise CheckpointError(f"index snapshot is missing leaf {k!r}")
        idx = cls(d_max=None)
        idx._d_max_arg = meta.get("d_max_arg")
        idx.device = store.device if store is not None else resolve_device(
            device)
        idx.universe = np.asarray(leaves["universe"])
        idx.vlabels = np.asarray(leaves["vlabels"], dtype=np.int32)
        idx.d_max = int(meta["d_max"])
        idx.max_p = int(meta["max_p"])
        idx._col_of = np.searchsorted(idx.universe, idx.vlabels)
        v, lu = int(idx.vlabels.size), int(idx.universe.size)
        counts = np.asarray(leaves["counts"], dtype=np.int32)
        if counts.shape != (v, lu):
            raise CheckpointError(
                f"index snapshot counts shape {counts.shape} disagrees with "
                f"(V, Lu) = ({v}, {lu})")
        cni = np.asarray(leaves[cni_key])
        if cni.dtype == np.uint64:
            if cni.size and int(cni.max()) > SAT64:
                raise CheckpointError("index snapshot cni_u64 exceeds SAT64")
            cni = cni.astype(np.int64)
        vectors = {"deg": np.asarray(leaves["deg"], dtype=np.int32),
                   "cni": np.asarray(cni, dtype=np.int64),
                   "cni_log": np.asarray(leaves["cni_log"], dtype=np.float32)}
        for name, arr in vectors.items():
            if arr.shape != (v,):
                raise CheckpointError(
                    f"index snapshot {name} shape {arr.shape} disagrees with "
                    f"V={v}")
        idx.counts = torch.as_tensor(counts, device=idx.device)
        for name, arr in vectors.items():
            setattr(idx, name, torch.as_tensor(arr, device=idx.device))
        idx._epoch = int(meta["epoch"])
        if meta.get("stats") is not None:
            idx.graph_stats = GraphStats.from_checkpoint_state(
                {k[len("stats_"):]: val for k, val in leaves.items()
                 if k.startswith("stats_")},
                meta["stats"])
        return idx

    # -- views ---------------------------------------------------------------

    def freeze(self) -> IndexSnapshot:
        """A copy of the state at this epoch (the counts are (V, Lu) on the
        device: a snapshot costs that much memory while it is cached)."""
        return IndexSnapshot(
            epoch=self._epoch,
            universe=self.universe,
            vlabels=self.vlabels,
            counts=self.counts.clone(),
            deg=self.deg.clone(),
            cni=self.cni.clone(),
            cni_log=self.cni_log.clone(),
            d_max=self.d_max,
            max_p=self.max_p,
            stats=(self.graph_stats.copy()
                   if self.graph_stats is not None else None),
        )


def _decreased(applied: EdgeBatch, frontier: np.ndarray) -> np.ndarray:
    """(F,) bool: frontier rows that lost a neighbour in this batch."""
    dec = np.zeros(frontier.size, dtype=bool)
    gone = ~applied.insert
    if gone.any():
        ids = np.unique(np.concatenate([applied.src[gone], applied.dst[gone]]))
        dec[np.searchsorted(frontier, ids)] = True
    return dec


class ShardState(NamedTuple):
    """One shard's slice of the maintained index state (a read-only view)."""

    shard: int
    v_base: int             # first owned vertex id
    counts: torch.Tensor    # (n_owned, Lu) int32
    deg: torch.Tensor       # (n_owned,) int32
    cni: torch.Tensor       # (n_owned,) int64
    cni_log: torch.Tensor   # (n_owned,) float32


class ShardedIncrementalIndex(IncrementalIndex):
    """Per-shard counts and CNI digests with a boundary-exchange update.

    The state is one tensor set per shard, each owning the contiguous
    vertex slice of the partition (normally the attached
    ``ShardedGraphStore``'s plan), on the store's device.  A batch routes
    every record to the owner shard(s) of its endpoints: an intra-shard
    edge is a local ±1 on two of that shard's rows, a cross-shard edge is
    sent to both owners (counted in ``stats.boundary_exchanged``).  Each
    touched shard then re-encodes its own frontier with one ``cni_update``
    launch under the base class's saturation rules, and ``rebuild``
    encodes each shard's slice with its own ``cni_encode`` launch, so the
    merged state equals an unsharded ``IncrementalIndex`` fed the same
    batches, bit for bit.  ``freeze()`` returns one merged
    ``IndexSnapshot``; ``counts``/``deg``/``cni``/``cni_log`` read as
    merged copies.
    """

    def __init__(self, *, n_shards: int | None = None,
                 d_max: int | None = None):
        super().__init__(d_max=d_max)
        self._n_shards_arg = n_shards
        self._plan = None

    # merged read-only views (freeze, checkpoints, parity checks)
    counts = property(lambda self: torch.cat(self._sh_counts))
    deg = property(lambda self: torch.cat(self._sh_deg))
    cni = property(lambda self: torch.cat(self._sh_cni))
    cni_log = property(lambda self: torch.cat(self._sh_log))

    def rebuild(self, store) -> None:
        plan = getattr(store, "plan", None)
        if plan is None or (self._n_shards_arg is not None
                            and plan.n_shards != self._n_shards_arg):
            plan = vertex_partition(store.n_vertices, self._n_shards_arg or 1)
        self._plan = plan
        self._split(self._count_edges(store))
        self._encode_all()
        self.graph_stats = GraphStats.from_store(store)
        self._epoch = store.epoch

    def _split(self, counts: torch.Tensor) -> None:
        """Take each shard's slice of a (V, Lu) count matrix as its own."""
        self._sh_counts = [counts[lo:hi].clone() for lo, hi in
                           map(self._plan.bounds, range(self._plan.n_shards))]

    def _encode_all(self) -> None:
        """Encode every shard's slice (one ``cni_encode`` launch a shard
        that owns vertices)."""
        enc = [self._encode_rows(c) for c in self._sh_counts]
        self._sh_deg, self._sh_cni, self._sh_log = (
            [e[k] for e in enc] for k in range(3))

    # -- durable snapshots ---------------------------------------------------

    def checkpoint_state(self):
        """The merged state and the shard count; a restore re-splits it
        along the restored store's plan."""
        leaves, meta = super().checkpoint_state()
        meta["n_shards"] = int(self._plan.n_shards)
        return leaves, meta

    @classmethod
    def from_checkpoint_state(cls, leaves, meta, *, store=None, device=None):
        """Restore over the restored ``ShardedGraphStore`` (its plan; its
        device); a snapshot whose shard count differs fails closed."""
        plan = getattr(store, "plan", None)
        if plan is None:
            raise CheckpointError(
                "sharded index restore needs the restored ShardedGraphStore "
                "(its partition plan) passed as store=")
        if int(plan.n_shards) != int(meta.get("n_shards", -1)):
            raise CheckpointError(
                f"index snapshot has n_shards={meta.get('n_shards')} but the "
                f"store plan has {plan.n_shards}")
        flat = IncrementalIndex.from_checkpoint_state(leaves, meta,
                                                      store=store,
                                                      device=device)
        idx = cls(n_shards=int(meta["n_shards"]))
        merged = {k: getattr(flat, k) for k in ("deg", "cni", "cni_log")}
        idx.__dict__.update({k: v for k, v in vars(flat).items()
                             if k not in ("counts", *merged)})
        idx._plan = plan
        idx._split(flat.counts)
        bounds = [plan.bounds(s) for s in range(plan.n_shards)]
        idx._sh_deg, idx._sh_cni, idx._sh_log = (
            [merged[k][lo:hi].clone() for lo, hi in bounds]
            for k in ("deg", "cni", "cni_log"))
        return idx

    def shard_state(self, s: int) -> ShardState:
        return ShardState(shard=s, v_base=self._plan.bounds(s)[0],
                          counts=self._sh_counts[s], deg=self._sh_deg[s],
                          cni=self._sh_cni[s], cni_log=self._sh_log[s])

    # -- incremental maintenance --------------------------------------------

    def apply_batch(self, store, applied: EdgeBatch) -> None:
        """Route one applied batch to the owner shards (the boundary
        exchange), then fold each touched shard's frontier with one
        ``cni_update`` launch under the saturation rules."""
        st = self.stats
        st.applied_batches += 1
        lo, hi = applied.src, applied.dst
        sign = np.where(applied.insert, 1, -1).astype(np.int32)
        st.edges_inserted += int(applied.insert.sum())
        st.edges_deleted += int((~applied.insert).sum())
        own_lo = lo // self._plan.v_local
        own_hi = hi // self._plan.v_local
        st.boundary_exchanged += int((own_lo != own_hi).sum())
        # the planner's statistics are global: folded once
        self._fold_graph_stats(store, lo, hi, sign)

        lu = int(self.universe.size)
        updates = []
        for s in range(self._plan.n_shards):
            base = self._plan.bounds(s)[0]
            m1, m2 = own_lo == s, own_hi == s
            rows = np.concatenate([lo[m1] - base, hi[m2] - base])
            if not rows.size:
                continue
            cols = np.concatenate([self._col_of[hi[m1]], self._col_of[lo[m2]]])
            sg = np.concatenate([sign[m1], sign[m2]])
            frontier = np.unique(rows)
            st.touched_vertices += int(frontier.size)
            delta = torch.zeros(frontier.size * lu, dtype=torch.int32,
                                device=self.device)
            delta.index_add_(0, torch.as_tensor(
                np.searchsorted(frontier, rows) * lu + cols,
                device=self.device), torch.as_tensor(sg, device=self.device))
            at = torch.as_tensor(frontier, device=self.device)
            new_rows, new_deg, new_cni, new_log = update_ops.cni_update(
                self._sh_counts[s][at], delta.view(frontier.size, lu),
                self.d_max, self.max_p)
            self._sh_counts[s][at] = new_rows
            dec = np.zeros(frontier.size, dtype=bool)
            dec[np.searchsorted(frontier, np.unique(rows[sg < 0]))] = True
            updates.append((s, at, new_deg, new_cni, new_log, dec))
        if not updates:
            self._epoch = store.epoch
            return
        max_deg = int(torch.stack([u[2].max() for u in updates]).max())
        if max_deg > self.d_max:
            # the tables' degree bound is passed: grow it, re-encode all
            self.d_max = ceil_pow2(max_deg)
            self.max_p = default_max_p(self.d_max, lu)
            self._encode_all()
            st.full_rebuilds += 1
            self._epoch = store.epoch
            return
        tallies = []
        for s, at, new_deg, new_cni, new_log, dec in updates:
            self._sh_deg[s][at] = new_deg
            sat = self._sh_cni[s][at] == SAT64
            dec = torch.as_tensor(dec, device=self.device)
            skip = sat & ~dec  # stays saturated: provably no change
            redo = ~skip
            self._sh_cni[s][at[redo]] = new_cni[redo]
            self._sh_log[s][at[redo]] = _canonical_log(new_cni, new_log)[redo]
            tallies.append(torch.stack([skip.sum(), (sat & dec).sum(),
                                        redo.sum()]))
        n_skip, n_recompute, n_redo = torch.stack(tallies).sum(0).tolist()
        st.saturated_skips += n_skip
        st.saturated_recomputes += n_recompute
        st.reencoded_vertices += n_redo
        self._epoch = store.epoch

    # -- views ---------------------------------------------------------------

    def freeze(self) -> IndexSnapshot:
        """One merged snapshot: every digest consumer reads a flat index
        (the merged views are copies already)."""
        return IndexSnapshot(
            epoch=self._epoch, universe=self.universe, vlabels=self.vlabels,
            counts=self.counts, deg=self.deg, cni=self.cni,
            cni_log=self.cni_log, d_max=self.d_max, max_p=self.max_p,
            stats=(self.graph_stats.copy()
                   if self.graph_stats is not None else None))


# ---------------------------------------------------------------------------
# Query-side consumption: maintained digests instead of a per-query encode.
# ---------------------------------------------------------------------------


def query_columns(universe: np.ndarray, query_labels: np.ndarray):
    """A query's sorted unique labels -> (universe columns (Lq,) int64,
    present (Lq,) bool); an absent label has zero counts everywhere."""
    cols = np.searchsorted(universe, query_labels)
    cols_c = np.clip(cols, 0, max(0, universe.size - 1))
    present = (
        universe[cols_c] == query_labels if universe.size else
        np.zeros(query_labels.shape, bool)
    )
    return cols_c, present


def gathered_counts(idx: IndexSnapshot, query_labels: np.ndarray) -> torch.Tensor:
    """Round-0 per-query counts (V, Lq) int32 from the universe matrix: a
    column gather, equal to ``counts_matrix`` of the same epoch's graph."""
    cols, present = query_columns(idx.universe, query_labels)
    dev = idx.counts.device
    out = torch.zeros((idx.counts.shape[0], query_labels.size),
                      dtype=torch.int32, device=dev)
    if present.any():
        keep = np.nonzero(present)[0]
        out[:, torch.as_tensor(keep, device=dev)] = \
            idx.counts[:, torch.as_tensor(cols[keep], device=dev)]
    return out


def store_digest(idx: IndexSnapshot, query_labels: np.ndarray,
                 ords: np.ndarray | None = None):
    """Data-side ``VertexDigest`` for a query alphabet, from index state.

    A full-universe alphabet reuses the maintained digests; a restricted
    one re-encodes the gathered counts with ``cni_encode`` under the
    index's (d_max, max_p).  Returns (digest, counts_q, ords), tensors on
    the index's device.  ``ords`` may pass in the data-side ord() values.
    """
    vlab = idx.vlabels
    if ords is None:
        pos = np.clip(np.searchsorted(query_labels, vlab), 0,
                      max(0, query_labels.size - 1))
        ords = np.where(
            query_labels.size and (query_labels[pos] == vlab), pos + 1, 0
        ).astype(np.int32)
    dev = idx.counts.device
    counts_q = gathered_counts(idx, query_labels)
    if query_labels.size == idx.universe.size and np.array_equal(
            query_labels, idx.universe):
        deg, cni, log = idx.deg, idx.cni, idx.cni_log
    else:
        deg, cni, log = encode_ops.cni_encode(counts_q, idx.d_max,
                                               idx.max_p)
    ords_t = torch.as_tensor(np.asarray(ords, dtype=np.int32), device=dev)
    digest = flt.VertexDigest(ord_label=ords_t, deg=deg, cni=cni, cni_log=log)
    return digest, counts_q, ords_t


def store_prefilter(idx: IndexSnapshot, query, *, variant: str = "cni",
                    digest_cache: dict | None = None) -> torch.Tensor:
    """One filtering pass from the store's digests: (V,) bool alive0 on the
    index's device.

    Sound for every variant; the ILGF fixed point proceeds from this mask.
    ``mnd_nlf`` needs per-edge maxima the counts cannot give, so it takes
    the label filter.  ``digest_cache``: an optional dict the caller owns;
    the data-side digest is memoized per query alphabet.
    """
    q_vlab = as_numpy(query.vlabels)
    query_labels = np.unique(q_vlab)
    ords_data, q_counts, q_digest, _q_mnd = prepare_padded_query(
        query, idx.vlabels, idx.d_max, idx.max_p,
        u_pad=int(q_vlab.shape[0]), l_pad=int(query_labels.size))
    key = query_labels.tobytes()
    cached = digest_cache.get(key) if digest_cache is not None else None
    if cached is None:
        cached = store_digest(idx, query_labels, ords=ords_data)
        if digest_cache is not None:
            digest_cache[key] = cached
    data_digest, counts_q, ords = cached
    dev = idx.counts.device
    q = flt.VertexDigest(*(torch.as_tensor(x, device=dev) for x in q_digest))
    label = (ords[:, None] == q.ord_label[None, :]) & (ords[:, None] > 0)
    if variant == "cni":
        match = flt.cni_match(data_digest, q)
    elif variant == "cni_log":
        match = flt.cni_match_log(data_digest, q)
    elif variant == "nlf":
        match = flt.nlf_match(counts_q, torch.as_tensor(q_counts, device=dev),
                              ords, q.ord_label)
    elif variant == "label_degree":
        match = label & (data_digest.deg[:, None] >= q.deg[None, :])
    else:  # mnd_nlf and future variants: the label filter (a sound superset)
        match = label
    return match.any(1) & (ords > 0)
