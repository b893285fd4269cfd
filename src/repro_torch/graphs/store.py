"""Mutable graph store: a keyed edge table, epochs and snapshots (port of
``repro.graphs.store``).

``GraphStore`` holds the undirected canonical edges (lo < hi) of one
labelled vertex universe in host arrays, in the reference's table order:
rows are appended in plan order, a delete clears a row's alive flag, a
re-insert revives the row in place, and ``compact()`` drops dead rows while
keeping the order of the rest.  Lookup goes through a sorted int64 key
index (``lo * V + hi``) searched with ``searchsorted``, so ``apply`` is a
handful of vectorised passes per batch instead of a loop over records with
a per-edge ``dict``.  Because the table order is the reference's, the
alive edge set comes out in the same order too (``random_update_batches``
draws from it seed for seed), and the snapshot graph, which ``build_graph``
sorts, is bit-identical.

``apply(EdgeBatch)`` keeps the reference's semantics: first record wins
within a batch, self-loops are dropped, duplicate inserts and missing
deletes count as skipped, a delete reports the label it removed, the
degree cap is checked on post-batch degrees before anything mutates, the
epoch bumps once per batch, an attached index sees exactly the records
that changed the edge set, and ``compact_every`` batches trigger a
compaction.  Snapshots are cached per epoch, pinned and released, and
built on the store's device (``None`` means ``"cuda"``).

``checkpoint_state`` / ``GraphStore.from_checkpoint_state`` carry the
logical state (the alive canonical edges, in table order, and the vertex
labels) through the durable tier (``serve/persist.py``), with the
reference's leaf names and meta.

``ShardedGraphStore`` keeps the same contract over a vertex-partitioned
table: each canonical edge (lo < hi) lives in the table of ``owner(lo)``
(the partition of ``core/distributed.py``), a cross-shard edge registers
its remote endpoint as a ghost on both owners, each shard logs one delta
row per batch that touched it, and snapshots carry the per-shard tables
(``GraphSnapshot.shards``) that the partitioned engines consume.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.checkpoint import CheckpointError
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, as_numpy, build_graph


class EdgeBatch(NamedTuple):
    """One batch of undirected edge records (host numpy arrays).

    ``insert[i]`` selects insert (True) or delete (False); ``valid`` masks
    padding rows.
    """

    src: np.ndarray      # (k,) int64
    dst: np.ndarray      # (k,) int64
    elabels: np.ndarray  # (k,) int64
    insert: np.ndarray   # (k,) bool
    valid: np.ndarray    # (k,) bool

    @property
    def n_records(self) -> int:
        return int(self.valid.sum())


def make_edge_batch(edges, elabels=None, *, insert=True) -> EdgeBatch:
    """(k, 2) edges (+labels) -> EdgeBatch; ``insert`` may be scalar or (k,)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    k = edges.shape[0]
    if elabels is None:
        elabels = np.zeros(k, dtype=np.int64)
    ins = np.broadcast_to(np.asarray(insert, dtype=bool), (k,)).copy()
    return EdgeBatch(
        src=edges[:, 0].copy(),
        dst=edges[:, 1].copy(),
        elabels=np.asarray(elabels, dtype=np.int64).copy(),
        insert=ins,
        valid=np.ones(k, dtype=bool),
    )


def canonicalize_batch(batch: EdgeBatch, n_vertices: int):
    """Valid records -> (lo, hi, lab, insert), self-loops dropped.

    One op per undirected edge per batch: a record repeating an earlier
    (lo, hi) pair is dropped (the first record wins), so an insert and a
    delete of one edge never interleave within a batch.
    """
    v = np.asarray(batch.valid, dtype=bool)
    s = np.asarray(batch.src, dtype=np.int64)[v]
    d = np.asarray(batch.dst, dtype=np.int64)[v]
    lab = np.asarray(batch.elabels, dtype=np.int64)[v]
    ins = np.asarray(batch.insert, dtype=bool)[v]
    lo = np.minimum(s, d)
    hi = np.maximum(s, d)
    keep = lo != hi
    lo, hi, lab, ins = lo[keep], hi[keep], lab[keep], ins[keep]
    if lo.size and (lo.min() < 0 or hi.max() >= n_vertices):
        raise ValueError("edge endpoint out of range for this store")
    # np.unique's return_index is the first occurrence of each key
    _, first = np.unique(lo * n_vertices + hi, return_index=True)
    idx = np.sort(first)
    return lo[idx], hi[idx], lab[idx], ins[idx]


class ApplyResult(NamedTuple):
    epoch: int           # store epoch after this batch
    applied: EdgeBatch   # canonical records that changed the edge set
    n_inserted: int
    n_deleted: int
    n_skipped: int       # duplicate inserts / missing deletes (no-ops)


class GraphSnapshot(NamedTuple):
    """Immutable view of a store at one epoch.

    ``graph`` is a port ``Graph`` on the store's device; ``index`` is a
    frozen ``core.incremental.IndexSnapshot`` when an incremental index is
    attached, else None.  ``shards`` is filled by ``ShardedGraphStore``
    alone: a tuple of per-shard ``(lo, hi, lab)`` host arrays of canonical
    edges.  ``ooc`` is filled by ``OutOfCoreGraphStore`` alone: a
    ``graphs.ooc.OocSnapshot`` handle over the epoch's on-disk generation,
    whose ``graph`` then holds the labels and no edges (the engines fetch
    the edges a query's prefilter touches).
    """

    epoch: int
    graph: Graph
    index: Optional[object]
    shards: Optional[tuple] = None
    ooc: Optional[object] = None


class StoreStats(NamedTuple):
    epoch: int
    n_vertices: int
    n_edges_alive: int
    n_edges_dead: int
    n_batches_applied: int
    n_compactions: int
    n_snapshots_cached: int


class BaseGraphStore:
    """Shared store machinery: vertex universe, epochs, snapshot cache and
    pins, degrees, the index listener, and batch validation.

    Concrete stores implement the edge table: ``_lookup`` (a probe of
    each key: its row, -1 when absent, for ``GraphStore``), ``_row_alive``
    of a probe, ``_apply_planned``, ``compact``, ``alive_edges``,
    ``n_edges`` and ``_n_edges_dead``.
    """

    def __init__(self, n_vertices: int, vlabels, *,
                 degree_cap: int | None = None, compact_every: int = 64,
                 device=None):
        self.vlabels = np.asarray(as_numpy(vlabels), dtype=np.int32).copy()
        if self.vlabels.shape != (n_vertices,):
            raise ValueError(f"vlabels has shape {self.vlabels.shape}, "
                             f"expected ({n_vertices},)")
        self.n_vertices = int(n_vertices)
        self.device = resolve_device(device)
        self._deg = np.zeros(n_vertices, dtype=np.int64)
        self.degree_cap = degree_cap
        self.compact_every = compact_every
        self.epoch = 0
        self._index = None  # listener: rebuild / apply_batch / freeze
        self._snapshots: dict[int, GraphSnapshot] = {}
        self._pins: dict[int, int] = {}
        self._n_batches = 0
        self._n_compactions = 0

    # -- construction --------------------------------------------------------

    @classmethod
    def from_graph(cls, g: Graph, **kwargs):
        """Seed a store from a ``Graph`` (its edges become the epoch-0 base)."""
        vlab = as_numpy(g.vlabels)
        store = cls(int(vlab.shape[0]), vlab, **kwargs)
        src = as_numpy(g.src)
        dst = as_numpy(g.dst)
        keep = src < dst  # one canonical record per undirected edge
        batch = make_edge_batch(np.stack([src[keep], dst[keep]], axis=1),
                                as_numpy(g.elabels)[keep])
        if batch.src.size:
            store.apply(batch)
            store._seed_reset()
        return store

    def _seed_reset(self) -> None:
        """The seeding batch of ``from_graph`` is epoch-0 base state."""
        self.epoch = 0
        self._snapshots.pop(1, None)

    def attach_index(self, index, *, rebuild: bool = True) -> None:
        """Attach an incremental-index listener (``core/incremental.py``),
        rebuilt from the current edge set and then kept in step by
        ``apply``.  ``rebuild=False`` only checks that the index is at the
        store's epoch."""
        if not rebuild and getattr(index, "_epoch", None) != self.epoch:
            raise ValueError(
                f"attach_index(rebuild=False): index epoch "
                f"{getattr(index, '_epoch', None)} != store epoch {self.epoch}")
        self._index = index
        if rebuild:
            index.rebuild(self)

    @property
    def index(self):
        return self._index

    # -- durable snapshots (checkpoint leaves + JSON meta) -------------------

    _CKPT_KIND = "graph"

    def checkpoint_state(self):
        """Logical store state as ``(leaves, meta)`` for the durable tier:
        host arrays of the alive canonical edges (in table order) and the
        vertex labels, and the JSON-serialisable meta that rebuilds the
        store around them."""
        lo, hi, lab = self.alive_edges()
        leaves = {
            "vlabels": self.vlabels,
            "edge_lo": np.asarray(lo, dtype=np.int64),
            "edge_hi": np.asarray(hi, dtype=np.int64),
            "edge_lab": np.asarray(lab, dtype=np.int64),
        }
        meta = {
            "kind": self._CKPT_KIND,
            "n_vertices": self.n_vertices,
            "epoch": self.epoch,
            "degree_cap": self.degree_cap,
            "compact_every": self.compact_every,
        }
        meta.update(self._checkpoint_extra_meta())
        return leaves, meta

    def _checkpoint_extra_meta(self) -> dict:
        return {}

    # -- mutation ------------------------------------------------------------

    def apply(self, batch: EdgeBatch) -> ApplyResult:
        """Apply one insert/delete batch; bumps the epoch; feeds the index.

        Atomic: the batch is validated in full (against ``degree_cap``, on
        post-batch degrees) before any state mutates.
        """
        lo, hi, lab, ins = canonicalize_batch(batch, self.n_vertices)
        # ---- validate phase: plan every action, mutate nothing ------------
        rows = self._lookup(lo * self.n_vertices + hi)
        plan = np.nonzero(ins != self._row_alive(rows))[0]
        n_skip = int(lo.size - plan.size)
        if self.degree_cap is not None:
            self._check_degree_cap(lo[plan], hi[plan], ins[plan])
        # ---- apply phase: no failure paths below ---------------------------
        applied, n_ins, n_del = self._apply_planned(plan, lo, hi, lab, ins, rows)
        self.epoch += 1
        self._n_batches += 1
        if self._index is not None and applied.src.size:
            self._index.apply_batch(self, applied)
        if self.compact_every and self._n_batches % self.compact_every == 0:
            self.compact()
        self._gc_snapshots()
        return ApplyResult(self.epoch, applied, n_ins, n_del, n_skip)

    def _check_degree_cap(self, lo, hi, ins) -> None:
        """Raise on the first vertex (in record order, ``lo`` before ``hi``)
        whose post-batch degree would pass the cap."""
        ends = np.stack([lo, hi], axis=1).ravel()
        sign = np.repeat(np.where(ins, 1, -1), 2)
        verts, first, inv = np.unique(ends, return_index=True,
                                      return_inverse=True)
        ddelta = np.bincount(inv, weights=sign, minlength=verts.size)
        post = self._deg[verts] + ddelta.astype(np.int64)
        bad = np.nonzero(post > self.degree_cap)[0]
        if bad.size:
            k = bad[np.argmin(first[bad])]
            raise ValueError(
                f"batch would push vertex {int(verts[k])} to degree "
                f"{int(post[k])} > degree_cap={self.degree_cap}; size the cap "
                "from the workload at store construction (store state is "
                "unchanged)")

    def add_edges(self, edges, elabels=None) -> ApplyResult:
        return self.apply(make_edge_batch(edges, elabels, insert=True))

    def remove_edges(self, edges) -> ApplyResult:
        return self.apply(make_edge_batch(edges, insert=False))

    def _add_degrees(self, lo, hi, sign: int) -> None:
        if lo.size:
            ends = np.concatenate([lo, hi])
            self._deg += sign * np.bincount(ends, minlength=self.n_vertices)

    # -- storage interface ---------------------------------------------------

    def _lookup(self, keys: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _row_alive(self, rows: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _apply_planned(self, plan, lo, hi, lab, ins, rows):
        raise NotImplementedError

    def compact(self) -> int:
        raise NotImplementedError

    def alive_edges(self):
        """Current edge set as host arrays ``(lo, hi, lab)``, one canonical
        (lo < hi) record per alive edge, in table order."""
        raise NotImplementedError

    @property
    def n_edges(self) -> int:
        raise NotImplementedError

    def _n_edges_dead(self) -> int:
        raise NotImplementedError

    def _shard_tables(self) -> Optional[tuple]:
        """Per-shard snapshot payload (None for an unsharded store)."""
        return None

    def has_edges(self, u, v) -> np.ndarray:
        """Vectorised ``has_edge`` over arrays of endpoints."""
        u = np.asarray(u, dtype=np.int64)
        v = np.asarray(v, dtype=np.int64)
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        return self._row_alive(self._lookup(lo * self.n_vertices + hi))

    def has_edge(self, u: int, v: int) -> bool:
        return bool(self.has_edges([u], [v])[0])

    # -- snapshots -----------------------------------------------------------

    def snapshot(self) -> GraphSnapshot:
        """Immutable (graph, frozen index) view at the current epoch, cached."""
        snap = self._snapshots.get(self.epoch)
        if snap is None:
            lo, hi, lab = self.alive_edges()
            g = build_graph(self.n_vertices, self.vlabels,
                            np.stack([lo, hi], axis=1), lab,
                            device=self.device)
            idx = self._index.freeze() if self._index is not None else None
            snap = GraphSnapshot(self.epoch, g, idx, self._shard_tables())
            self._snapshots[self.epoch] = snap
        return snap

    def pin(self, epoch: int | None = None) -> GraphSnapshot:
        """Snapshot + refcount: the epoch survives garbage collection until
        a matching ``release``."""
        snap = self.snapshot() if epoch is None else self._snapshots[epoch]
        self._pins[snap.epoch] = self._pins.get(snap.epoch, 0) + 1
        return snap

    def release(self, epoch: int) -> None:
        n = self._pins.get(epoch, 0) - 1
        if n <= 0:
            self._pins.pop(epoch, None)
        else:
            self._pins[epoch] = n
        self._gc_snapshots()

    def _gc_snapshots(self) -> None:
        for ep in list(self._snapshots):
            if ep != self.epoch and self._pins.get(ep, 0) <= 0:
                del self._snapshots[ep]

    # -- inspection ----------------------------------------------------------

    @property
    def max_degree(self) -> int:
        return int(self._deg.max()) if self._deg.size else 0

    def degrees(self) -> np.ndarray:
        return self._deg.copy()

    def stats(self) -> StoreStats:
        return StoreStats(
            epoch=self.epoch,
            n_vertices=self.n_vertices,
            n_edges_alive=self.n_edges,
            n_edges_dead=self._n_edges_dead(),
            n_batches_applied=self._n_batches,
            n_compactions=self._n_compactions,
            n_snapshots_cached=len(self._snapshots),
        )


class _EdgeTable:
    """A canonical edge table (lo < hi) in append order with alive flags,
    and a sorted int64 key index (``lo * V + hi``, the row of each key)
    searched with ``searchsorted``."""

    def __init__(self, n_vertices: int):
        self.n_vertices = n_vertices
        self.lo = np.zeros(0, dtype=np.int64)
        self.hi = np.zeros(0, dtype=np.int64)
        self.lab = np.zeros(0, dtype=np.int64)
        self.alive = np.zeros(0, dtype=bool)
        self._keys = np.zeros(0, dtype=np.int64)
        self._rows = np.zeros(0, dtype=np.int64)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """The row of each key, -1 when absent."""
        rows = np.full(keys.shape, -1, dtype=np.int64)
        if self._keys.size:
            pos = np.minimum(np.searchsorted(self._keys, keys),
                             self._keys.size - 1)
            hit = self._keys[pos] == keys
            rows[hit] = self._rows[pos[hit]]
        return rows

    def row_alive(self, rows: np.ndarray) -> np.ndarray:
        alive = np.zeros(rows.shape, dtype=bool)
        hit = rows >= 0
        alive[hit] = self.alive[rows[hit]]
        return alive

    def commit(self, lo, hi, lab, ins, rows) -> None:
        """Apply planned records (``rows``: each record's row, -1 when
        new): revive re-inserted rows with their label, clear deleted ones
        (writing the label each removed into ``lab``), append new rows."""
        revive = ins & (rows >= 0)
        self.alive[rows[revive]] = True
        self.lab[rows[revive]] = lab[revive]
        dele = ~ins
        self.alive[rows[dele]] = False
        lab[dele] = self.lab[rows[dele]]
        new = ins & (rows < 0)
        if new.any():
            self.append_rows(lo[new], hi[new], lab[new])

    def append_rows(self, lo, hi, lab) -> None:
        """Append brand-new alive rows and merge their keys into the index."""
        base = self.alive.size
        keys = lo * self.n_vertices + hi
        order = np.argsort(keys)
        at = np.searchsorted(self._keys, keys[order])
        self._keys = np.insert(self._keys, at, keys[order])
        self._rows = np.insert(self._rows, at, base + order)
        self.lo = np.concatenate([self.lo, lo])
        self.hi = np.concatenate([self.hi, hi])
        self.lab = np.concatenate([self.lab, lab])
        self.alive = np.concatenate([self.alive, np.ones(lo.size, dtype=bool)])

    def compact(self) -> int:
        """Drop dead rows, keeping the order of the rest; returns how many."""
        dead = int((~self.alive).sum())
        if dead == 0:
            return 0
        keep = self.alive
        self.lo, self.hi, self.lab = self.lo[keep], self.hi[keep], self.lab[keep]
        self.alive = np.ones(self.lo.size, dtype=bool)
        keys = self.lo * self.n_vertices + self.hi
        self._rows = np.argsort(keys)
        self._keys = keys[self._rows]
        return dead

    def alive_rows(self):
        keep = self.alive
        return self.lo[keep], self.hi[keep], self.lab[keep]


class GraphStore(BaseGraphStore):
    """Mutable vertex-labelled graph with epoch-versioned snapshots."""

    def __init__(self, n_vertices, vlabels, **kwargs):
        super().__init__(n_vertices, vlabels, **kwargs)
        self._table = _EdgeTable(self.n_vertices)

    @classmethod
    def from_checkpoint_state(cls, leaves, meta, *, device=None) -> "GraphStore":
        """Rebuild a store from ``checkpoint_state()`` output, validated
        first; its snapshots go to ``device`` (``None`` means ``"cuda"``).
        Rows keep the snapshot's order, so ``alive_edges`` does too."""
        n, vlab, lo, hi, lab = _ckpt_restore_arrays(leaves, meta)
        store = cls(n, vlab, degree_cap=meta.get("degree_cap"),
                    compact_every=int(meta.get("compact_every", 64)),
                    device=device)
        store._table.append_rows(lo, hi, lab)
        store._add_degrees(lo, hi, 1)
        store.epoch = int(meta["epoch"])
        return store

    def _lookup(self, keys):
        return self._table.lookup(keys)

    def _row_alive(self, rows):
        return self._table.row_alive(rows)

    def _apply_planned(self, plan, lo, hi, lab, ins, rows):
        p_lo, p_hi, p_ins = lo[plan], hi[plan], ins[plan]
        p_lab = lab[plan].copy()
        self._table.commit(p_lo, p_hi, p_lab, p_ins, rows[plan])
        self._add_degrees(p_lo[p_ins], p_hi[p_ins], 1)
        self._add_degrees(p_lo[~p_ins], p_hi[~p_ins], -1)
        applied = EdgeBatch(src=p_lo, dst=p_hi, elabels=p_lab, insert=p_ins,
                            valid=np.ones(plan.size, dtype=bool))
        return applied, int(p_ins.sum()), int((~p_ins).sum())

    def compact(self) -> int:
        """Drop dead rows from the edge table; returns rows reclaimed.

        Storage maintenance only: the logical edge set, the epoch and the
        attached index are unchanged.
        """
        dead = self._table.compact()
        if dead:
            self._n_compactions += 1
        return dead

    def alive_edges(self):
        return self._table.alive_rows()

    @property
    def n_edges(self) -> int:
        return int(self._table.alive.sum())

    def _n_edges_dead(self) -> int:
        return int((~self._table.alive).sum())


def _ckpt_restore_arrays(leaves: dict, meta: dict):
    """Check a store snapshot's edge leaves against its meta: a truncated
    or tampered snapshot raises ``CheckpointError`` instead of restoring a
    wrong edge set."""
    for k in ("vlabels", "edge_lo", "edge_hi", "edge_lab"):
        if k not in leaves:
            raise CheckpointError(f"store snapshot is missing leaf {k!r}")
    n = int(meta["n_vertices"])
    vlab = np.asarray(leaves["vlabels"], dtype=np.int32)
    if vlab.shape != (n,):
        raise CheckpointError(
            f"store snapshot vlabels shape {vlab.shape} disagrees with "
            f"n_vertices={n}")
    lo = np.asarray(leaves["edge_lo"], dtype=np.int64)
    hi = np.asarray(leaves["edge_hi"], dtype=np.int64)
    lab = np.asarray(leaves["edge_lab"], dtype=np.int64)
    if not (lo.shape == hi.shape == lab.shape):
        raise CheckpointError("store snapshot edge arrays disagree in length")
    if lo.size and (lo.min() < 0 or hi.max() >= n or not (lo < hi).all()):
        raise CheckpointError(
            "store snapshot edge table is not canonical (need 0 <= lo < hi "
            f"< {n})")
    if np.unique(lo * n + hi).size != lo.size:
        raise CheckpointError("store snapshot edge table repeats an edge")
    return n, vlab, lo, hi, lab


class _ShardTable(_EdgeTable):
    """One shard's slice of the canonical edge table: the edges whose
    ``lo`` endpoint the shard owns.

    ``ghost_refs[v]`` counts the alive local edges that reference remote
    vertex ``v`` (either direction); ``delta_log`` holds one ``(epoch,
    n_inserted, n_deleted, n_boundary)`` row per batch that touched the
    shard and is cleared on compaction (the table is then the merged
    state).
    """

    def __init__(self, n_vertices: int):
        super().__init__(n_vertices)
        self.ghost_refs = np.zeros(n_vertices, dtype=np.int32)
        self.delta_log: list[tuple[int, int, int, int]] = []

    @property
    def ghosts(self) -> dict:
        """``{remote vertex: alive edges referencing it}``."""
        v = np.flatnonzero(self.ghost_refs)
        return dict(zip(v.tolist(), self.ghost_refs[v].tolist()))

    def compact(self) -> int:
        self.delta_log.clear()
        return super().compact()


class ShardStats(NamedTuple):
    shard: int
    n_vertices_owned: int
    n_edges: int           # alive canonical edges stored here (owner of lo)
    n_ghosts: int          # distinct remote vertices referenced by alive edges
    n_boundary_edges: int  # alive edges with endpoints on two shards
    n_log_entries: int     # delta-log rows since the last compaction


class ShardedGraphStore(BaseGraphStore):
    """Vertex-partitioned ``GraphStore``: the same contract, sharded storage.

    The vertex axis splits into ``n_shards`` contiguous owner slices
    (``core/distributed.py::vertex_partition``).  Each canonical edge
    lives in the table of ``owner(lo)``; a cross-shard edge registers its
    remote endpoint in both owners' ghost counts, which is the set of
    remote vertices each shard's count rows depend on.  ``apply``
    validates globally (the same atomic degree-cap check), commits per
    shard and logs one delta row per touched shard; snapshots carry the
    per-shard tables.  The same batches applied to a ``GraphStore`` and a
    ``ShardedGraphStore`` give bit-identical snapshot graphs and degrees.
    A probe's row is encoded ``row * n_shards + shard``.
    """

    def __init__(self, n_vertices, vlabels, *, n_shards: int, **kwargs):
        super().__init__(n_vertices, vlabels, **kwargs)
        # imported here: the core package imports this module
        from repro_torch.core.distributed import vertex_partition

        self.plan = vertex_partition(self.n_vertices, n_shards)
        self.n_shards = int(n_shards)
        self._shards = [_ShardTable(self.n_vertices)
                        for _ in range(self.n_shards)]
        self._n_boundary_alive = 0    # alive cross-shard edges right now
        self._n_boundary_records = 0  # cumulative boundary records applied

    _CKPT_KIND = "sharded"

    def _checkpoint_extra_meta(self) -> dict:
        return {"n_shards": self.n_shards}

    @classmethod
    def from_checkpoint_state(cls, leaves, meta, *,
                              device=None) -> "ShardedGraphStore":
        """Rebuild from ``checkpoint_state()`` output: the canonical edge
        set re-buckets through one seeding ``apply`` (as ``from_graph``
        does), so ghosts and boundary counters are rebuilt exactly."""
        n, vlab, lo, hi, lab = _ckpt_restore_arrays(leaves, meta)
        if "n_shards" not in meta:
            raise CheckpointError("sharded store snapshot has no n_shards in "
                                  "its meta")
        store = cls(n, vlab, n_shards=int(meta["n_shards"]),
                    degree_cap=meta.get("degree_cap"),
                    compact_every=int(meta.get("compact_every", 64)),
                    device=device)
        if lo.size:
            store.apply(make_edge_batch(np.stack([lo, hi], axis=1), lab))
            store._seed_reset()
        store.epoch = int(meta["epoch"])
        return store

    def _lookup(self, keys):
        rows = np.full(keys.shape, -1, dtype=np.int64)
        owner = (keys // self.n_vertices) // self.plan.v_local
        for s in np.unique(owner):
            m = owner == s
            r = self._shards[s].lookup(keys[m])
            rows[m] = np.where(r >= 0, r * self.n_shards + s, -1)
        return rows

    def _row_alive(self, rows):
        alive = np.zeros(rows.shape, dtype=bool)
        hit = rows >= 0
        shard = rows % self.n_shards
        for s in np.unique(shard[hit]):
            m = hit & (shard == s)
            alive[m] = self._shards[s].alive[rows[m] // self.n_shards]
        return alive

    def _apply_planned(self, plan, lo, hi, lab, ins, rows):
        p_lo, p_hi, p_ins, p_rows = lo[plan], hi[plan], ins[plan], rows[plan]
        p_lab = lab[plan].copy()
        s_lo = p_lo // self.plan.v_local
        s_hi = p_hi // self.plan.v_local
        cross = s_lo != s_hi
        local = np.where(p_rows >= 0, p_rows // self.n_shards, -1)
        sign = np.where(p_ins, 1, -1).astype(np.int32)
        next_epoch = self.epoch + 1
        for s, tab in enumerate(self._shards):
            mine = s_lo == s
            if mine.any():
                mine_lab = p_lab[mine]
                tab.commit(p_lo[mine], p_hi[mine], mine_lab, p_ins[mine],
                           local[mine])
                p_lab[mine] = mine_lab  # the labels deletes removed
            # ghosts: owner(lo) references hi, owner(hi) references lo
            g_lo, g_hi = mine & cross, (s_hi == s) & cross
            tab.ghost_refs += np.bincount(
                np.concatenate([p_hi[g_lo], p_lo[g_hi]]),
                weights=np.concatenate([sign[g_lo], sign[g_hi]]),
                minlength=self.n_vertices).astype(np.int32)
            touched = mine | (s_hi == s)
            if touched.any():
                tab.delta_log.append((
                    next_epoch, int((touched & p_ins).sum()),
                    int((touched & ~p_ins).sum()),
                    int((touched & cross).sum())))
        self._add_degrees(p_lo[p_ins], p_hi[p_ins], 1)
        self._add_degrees(p_lo[~p_ins], p_hi[~p_ins], -1)
        self._n_boundary_alive += int(sign[cross].sum())
        self._n_boundary_records += int(cross.sum())
        applied = EdgeBatch(src=p_lo, dst=p_hi, elabels=p_lab, insert=p_ins,
                            valid=np.ones(plan.size, dtype=bool))
        return applied, int(p_ins.sum()), int((~p_ins).sum())

    def _seed_reset(self) -> None:
        super()._seed_reset()
        for tab in self._shards:  # the seed is base state, not a delta
            tab.delta_log.clear()

    def compact(self) -> int:
        dead = sum(tab.compact() for tab in self._shards)
        if dead:
            self._n_compactions += 1
        return dead

    def alive_edges(self):
        rows = [tab.alive_rows() for tab in self._shards]
        return tuple(np.concatenate([r[k] for r in rows]) for k in range(3))

    @property
    def n_edges(self) -> int:
        return int(sum(int(tab.alive.sum()) for tab in self._shards))

    def _n_edges_dead(self) -> int:
        return int(sum(int((~tab.alive).sum()) for tab in self._shards))

    def _shard_tables(self) -> tuple:
        return tuple(tab.alive_rows() for tab in self._shards)

    def shard_stats(self) -> list[ShardStats]:
        out = []
        for i, tab in enumerate(self._shards):
            lo, hi = self.plan.bounds(i)
            keep = tab.alive
            boundary = int((tab.hi[keep] // self.plan.v_local
                            != tab.lo[keep] // self.plan.v_local).sum())
            out.append(ShardStats(
                shard=i, n_vertices_owned=hi - lo, n_edges=int(keep.sum()),
                n_ghosts=int(np.count_nonzero(tab.ghost_refs)),
                n_boundary_edges=boundary,
                n_log_entries=len(tab.delta_log)))
        return out

    @property
    def n_boundary_edges(self) -> int:
        """Alive edges whose endpoints live on different shards."""
        return self._n_boundary_alive


def as_snapshot(data) -> GraphSnapshot:
    """Graph | GraphStore | GraphSnapshot -> GraphSnapshot (a plain Graph
    becomes an epoch-0 snapshot with no index)."""
    if isinstance(data, GraphSnapshot):
        return data
    if isinstance(data, BaseGraphStore):
        return data.snapshot()
    if isinstance(data, Graph):
        return GraphSnapshot(0, data, None)
    raise TypeError(
        f"expected a repro_torch Graph | GraphStore | GraphSnapshot, got "
        f"{type(data)}")
