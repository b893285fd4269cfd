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
reference's leaf names and meta.  The vertex-partitioned
``ShardedGraphStore`` belongs to a later slice of the port and raises
``NotImplementedError`` naming its ROADMAP item.
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
    attached, else None.  ``ooc`` is filled by ``OutOfCoreGraphStore``
    alone: a ``graphs.ooc.OocSnapshot`` handle over the epoch's on-disk
    generation, whose ``graph`` then holds the labels and no edges (the
    engines fetch the edges a query's prefilter touches).
    """

    epoch: int
    graph: Graph
    index: Optional[object]
    ooc: Optional[object] = None


class StoreStats(NamedTuple):
    epoch: int
    n_vertices: int
    n_edges_alive: int
    n_edges_dead: int
    n_batches_applied: int
    n_compactions: int
    n_snapshots_cached: int


def later_slice(what: str, item: str) -> NotImplementedError:
    """The error for a part of the reference a later slice of the port
    brings (raised by the store, the index and the engines)."""
    return NotImplementedError(
        f"{what} is not ported yet: it comes with ROADMAP.md queue A item "
        f"{item}")


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
        return leaves, meta

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
            snap = GraphSnapshot(self.epoch, g, idx)
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


class GraphStore(BaseGraphStore):
    """Mutable vertex-labelled graph with epoch-versioned snapshots."""

    def __init__(self, n_vertices, vlabels, **kwargs):
        super().__init__(n_vertices, vlabels, **kwargs)
        # canonical edge table (lo < hi) in append order, with alive flags
        self._lo = np.zeros(0, dtype=np.int64)
        self._hi = np.zeros(0, dtype=np.int64)
        self._lab = np.zeros(0, dtype=np.int64)
        self._alive = np.zeros(0, dtype=bool)
        # sorted keys lo * V + hi of every row, and the row of each key
        self._keys = np.zeros(0, dtype=np.int64)
        self._rows = np.zeros(0, dtype=np.int64)

    @classmethod
    def from_checkpoint_state(cls, leaves, meta, *, device=None) -> "GraphStore":
        """Rebuild a store from ``checkpoint_state()`` output, validated
        first; its snapshots go to ``device`` (``None`` means ``"cuda"``).
        Rows keep the snapshot's order, so ``alive_edges`` does too."""
        n, vlab, lo, hi, lab = _ckpt_restore_arrays(leaves, meta)
        store = cls(n, vlab, degree_cap=meta.get("degree_cap"),
                    compact_every=int(meta.get("compact_every", 64)),
                    device=device)
        store._append_rows(lo, hi, lab)
        store._add_degrees(lo, hi, 1)
        store.epoch = int(meta["epoch"])
        return store

    def _lookup(self, keys):
        rows = np.full(keys.shape, -1, dtype=np.int64)
        if self._keys.size:
            pos = np.minimum(np.searchsorted(self._keys, keys),
                             self._keys.size - 1)
            hit = self._keys[pos] == keys
            rows[hit] = self._rows[pos[hit]]
        return rows

    def _row_alive(self, rows):
        alive = np.zeros(rows.shape, dtype=bool)
        hit = rows >= 0
        alive[hit] = self._alive[rows[hit]]
        return alive

    def _apply_planned(self, plan, lo, hi, lab, ins, rows):
        p_lo, p_hi, p_ins, p_rows = lo[plan], hi[plan], ins[plan], rows[plan]
        p_lab = lab[plan].copy()
        revive = p_ins & (p_rows >= 0)
        self._alive[p_rows[revive]] = True
        self._lab[p_rows[revive]] = p_lab[revive]
        dele = ~p_ins
        self._alive[p_rows[dele]] = False
        p_lab[dele] = self._lab[p_rows[dele]]  # report the label removed
        new = p_ins & (p_rows < 0)
        if new.any():
            self._append_rows(p_lo[new], p_hi[new], p_lab[new])
        self._add_degrees(p_lo[p_ins], p_hi[p_ins], 1)
        self._add_degrees(p_lo[dele], p_hi[dele], -1)
        applied = EdgeBatch(src=p_lo, dst=p_hi, elabels=p_lab, insert=p_ins,
                            valid=np.ones(plan.size, dtype=bool))
        return applied, int(p_ins.sum()), int(dele.sum())

    def _append_rows(self, lo, hi, lab):
        """Append brand-new alive rows and merge their keys into the index."""
        base = self._alive.size
        keys = lo * self.n_vertices + hi
        order = np.argsort(keys)
        at = np.searchsorted(self._keys, keys[order])
        self._keys = np.insert(self._keys, at, keys[order])
        self._rows = np.insert(self._rows, at, base + order)
        self._lo = np.concatenate([self._lo, lo])
        self._hi = np.concatenate([self._hi, hi])
        self._lab = np.concatenate([self._lab, lab])
        self._alive = np.concatenate([self._alive, np.ones(lo.size, dtype=bool)])

    def compact(self) -> int:
        """Drop dead rows from the edge table; returns rows reclaimed.

        Storage maintenance only: the logical edge set, the epoch and the
        attached index are unchanged.
        """
        dead = int((~self._alive).sum())
        if dead == 0:
            return 0
        keep = self._alive
        self._lo = self._lo[keep]
        self._hi = self._hi[keep]
        self._lab = self._lab[keep]
        self._alive = np.ones(self._lo.size, dtype=bool)
        keys = self._lo * self.n_vertices + self._hi
        self._rows = np.argsort(keys)
        self._keys = keys[self._rows]
        self._n_compactions += 1
        return dead

    def alive_edges(self):
        keep = self._alive
        return self._lo[keep], self._hi[keep], self._lab[keep]

    @property
    def n_edges(self) -> int:
        return int(self._alive.sum())

    def _n_edges_dead(self) -> int:
        return int((~self._alive).sum())


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


class ShardedGraphStore(BaseGraphStore):
    """The vertex-partitioned store of the reference; not ported yet."""

    def __init__(self, *args, **kwargs):
        raise later_slice("ShardedGraphStore", "11 (multi-device)")

    def checkpoint_state(self):
        raise later_slice("ShardedGraphStore.checkpoint_state",
                          "11 (multi-device)")

    @classmethod
    def from_checkpoint_state(cls, leaves, meta, *, device=None):
        raise later_slice("ShardedGraphStore.from_checkpoint_state",
                          "11 (multi-device)")


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
