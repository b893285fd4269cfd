"""Out-of-core graph store: resident digests, disk-resident edge table
(port of ``repro.graphs.ooc``).

``OutOfCoreGraphStore`` keeps the CNI digests, label counts, degrees and
``GraphStats`` resident (all O(V·L), maintained by ``IncrementalIndex`` on
the store's device as for the in-memory store), while the canonical edge
table lives on disk as a chunk directory (``graphs/io.py``): ``(lo, hi,
label)`` records sorted by ``(lo, hi)`` in fixed-size chunk files whose
manifest is an interval index.  The format is the reference's, so a
directory either package wrote opens in the other.

A query runs the prefilter first, on the resident digests alone
(``store_prefilter``), and only then fetches edge chunks: those whose
``lo`` and ``hi`` ranges both meet the surviving vertices, through a
byte-budgeted LRU ``ChunkCache``.  The fetched restricted graph (every
edge with both endpoints in the prefilter mask) feeds the usual pipeline
with the store's resident ``d_max``; every ILGF round masks counts by the
alive set at both endpoints, so the results equal the in-memory engine's
bit for bit.

Mutations follow the LSM pattern: ``apply`` writes a resident overlay of
inserts, re-labels and tombstones keyed by ``(lo, hi)``; ``compact``
streams base chunks and the sorted overlay through a merge into a new
on-disk generation.  A snapshot carries an ``OocSnapshot`` handle that
refcounts its generation, so an epoch pin pins chunk files.

``apply`` plans a batch with grouped probes: the overlay first, then one
``searchsorted`` of the remaining keys over the chunks' first keys, then
one read per chunk touched, where the reference answers one ``has_edge``
and one ``label_of`` per record.  The ``ApplyResult``, the applied labels
and the overlay are the reference's; the cache is left in another state,
so the cache's hit, miss and byte counters agree with the reference's only
until the first ``apply``.  The query side's ``chunks_read``,
``edges_fetched``, ``n_chunks`` and ``partial`` always agree.

Every disk read validates sizes and headers against the manifest and
raises ``ChunkIOError``: the tier fails closed.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
import time
import weakref
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obsv
from repro_torch.checkpoint import CheckpointError
from repro_torch.graphs.csr import Graph, as_numpy, build_graph
from repro_torch.graphs.io import (
    ChunkDirWriter,
    ChunkIOError,
    load_chunk_sidecars,
    load_manifest,
    read_chunk,
    sort_canonical,
)
from repro_torch.graphs.store import BaseGraphStore, EdgeBatch, GraphSnapshot

_GEN_RE = re.compile(r"^gen-(\d{5})$")


class ChunkCache:
    """Byte-budgeted LRU over immutable chunk arrays, keyed (gen, chunk).

    ``budget_bytes`` bounds the resident fetched edge data; a chunk larger
    than the budget is still admitted (the cache never holds fewer than
    one entry), and ``peak_resident_bytes`` is the high-water mark.
    """

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._entries: OrderedDict[tuple[int, int], np.ndarray] = OrderedDict()
        self.resident_bytes = 0
        self.peak_resident_bytes = 0
        self.accesses = 0
        self.hits = 0
        self.misses = 0
        self.bytes_read = 0

    def load(self, key: tuple[int, int], loader) -> np.ndarray:
        self.accesses += 1
        rec = self._entries.get(key)
        if rec is not None:
            self.hits += 1
            self._entries.move_to_end(key)
            if obsv.enabled():  # zero-duration marker: resident, no IO
                now = time.perf_counter()
                obsv.span_at("ooc.chunk", now, now,
                             gen=key[0], chunk=key[1], hit=True)
            return rec
        self.misses += 1
        with obsv.span("ooc.chunk", gen=key[0], chunk=key[1], hit=False) as sp:
            rec = loader()
            sp.set_attrs(bytes=int(rec.nbytes))
        self.bytes_read += rec.nbytes
        self._entries[key] = rec
        self.resident_bytes += rec.nbytes
        self.peak_resident_bytes = max(self.peak_resident_bytes,
                                       self.resident_bytes)
        while self.resident_bytes > self.budget_bytes and len(self._entries) > 1:
            _, old = self._entries.popitem(last=False)
            self.resident_bytes -= old.nbytes
        return rec

    def drop_generation(self, gen_id: int) -> None:
        for key in [k for k in self._entries if k[0] == gen_id]:
            self.resident_bytes -= self._entries.pop(key).nbytes

    def counters(self) -> dict:
        return {
            "chunks_read": self.accesses,
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "bytes_read": self.bytes_read,
        }


def _keys(rec: np.ndarray, n_vertices: int) -> np.ndarray:
    return rec[:, 0] * np.int64(n_vertices) + rec[:, 1]


def _not_in(keys: np.ndarray, sorted_keys: np.ndarray) -> np.ndarray:
    """(k,) bool: ``keys`` absent from ``sorted_keys``."""
    if not sorted_keys.size:
        return np.ones(keys.shape, dtype=bool)
    pos = np.minimum(np.searchsorted(sorted_keys, keys), sorted_keys.size - 1)
    return sorted_keys[pos] != keys


class _Generation:
    """Immutable view over one on-disk generation (chunk directory)."""

    def __init__(self, path: str, gen_id: int, manifest: dict,
                 n_vertices: int):
        self.path = path
        self.gen_id = int(gen_id)
        self.manifest = manifest
        self.n_vertices = int(n_vertices)
        self.entries = manifest["chunks"]
        v = np.int64(self.n_vertices)

        def col(name):
            return np.array([e[name] for e in self.entries], dtype=np.int64)

        self.lo_min, self.lo_max = col("lo_min"), col("lo_max")
        self.hi_min, self.hi_max = col("hi_min"), col("hi_max")
        # lexicographic (lo, hi) key range of each chunk: the probe index
        self._first_key = self.lo_min * v + col("hi_first")
        self._last_key = self.lo_max * v + col("hi_last")

    @property
    def n_chunks(self) -> int:
        return len(self.entries)

    @property
    def n_records(self) -> int:
        return int(self.manifest["n_records"])

    def chunk(self, cid: int, cache: ChunkCache) -> np.ndarray:
        return cache.load(
            (self.gen_id, cid),
            lambda: read_chunk(self.path, self.entries[cid], self.n_vertices))

    def labels_of(self, keys: np.ndarray, cache: ChunkCache):
        """Base-table probes of int64 keys ``lo * V + hi``, grouped by
        chunk (one read per chunk touched): ``(found (k,) bool, label (k,)
        int64)``."""
        found = np.zeros(keys.shape, dtype=bool)
        label = np.zeros(keys.shape, dtype=np.int64)
        if not self.entries or not keys.size:
            return found, label
        cid = np.searchsorted(self._first_key, keys, side="right") - 1
        cand = np.nonzero(cid >= 0)[0]
        cand = cand[keys[cand] <= self._last_key[cid[cand]]]
        cand = cand[np.argsort(cid[cand], kind="stable")]
        chunks, starts = np.unique(cid[cand], return_index=True)
        for c, idx in zip(chunks, np.split(cand, starts[1:])):
            rec = self.chunk(int(c), cache)
            ckeys = _keys(rec, self.n_vertices)
            pos = np.minimum(np.searchsorted(ckeys, keys[idx]), ckeys.size - 1)
            hit = ckeys[pos] == keys[idx]
            found[idx[hit]] = True
            label[idx[hit]] = rec[pos[hit], 2]
        return found, label


def _overlay_arrays(overlay: dict, n_vertices: int):
    """An overlay ``{lo * V + hi: label or None}`` as key-sorted arrays:
    ``(keys, lo, hi, label, live)``, a tombstone's label 0."""
    keys = np.fromiter(overlay.keys(), dtype=np.int64, count=len(overlay))
    order = np.argsort(keys)
    keys = keys[order]
    vals = np.fromiter((-1 if v is None else v for v in overlay.values()),
                       dtype=np.int64, count=len(overlay))[order]
    live = np.fromiter((v is not None for v in overlay.values()),
                       dtype=bool, count=len(overlay))[order]
    v = np.int64(n_vertices)
    return keys, keys // v, keys % v, np.where(live, vals, 0), live


class OocSnapshot:
    """Frozen read handle over one epoch: a generation and an overlay copy.

    Travels in ``GraphSnapshot.ooc``.  Holding it refcounts the generation
    (the store will not delete its chunk files), so a pinned query keeps
    reading the edge set it was admitted on, across compactions.  Fetched
    graphs lie on ``device``.
    """

    def __init__(self, *, base: _Generation, overlay: dict,
                 cache: ChunkCache, n_vertices: int, vlabels: np.ndarray,
                 d_max: int, epoch: int, device):
        self.base = base
        self.cache = cache
        self.n_vertices = int(n_vertices)
        self.vlabels = vlabels
        self.d_max = int(d_max)
        self.epoch = int(epoch)
        self.device = device
        keys, lo, hi, lab, live = _overlay_arrays(overlay, self.n_vertices)
        # every overlay key overrides (drops) its base record, and the live
        # entries re-emit from the overlay side
        self._ov_keys = keys
        self._ov_edges = np.stack([lo, hi, lab], axis=1)[live]

    @property
    def n_chunks(self) -> int:
        return self.base.n_chunks

    def _tel(self, before: dict, t0: float, edges_fetched: int,
             partial: bool) -> obsv.OocReport:
        after = self.cache.counters()
        return obsv.OocReport(
            chunks_read=after["chunks_read"] - before["chunks_read"],
            cache_hits=after["cache_hits"] - before["cache_hits"],
            cache_misses=after["cache_misses"] - before["cache_misses"],
            bytes_read=after["bytes_read"] - before["bytes_read"],
            n_chunks=self.base.n_chunks,
            edges_fetched=int(edges_fetched),
            peak_resident_bytes=self.cache.peak_resident_bytes,
            resident_budget_bytes=self.cache.budget_bytes,
            fetch_seconds=time.perf_counter() - t0,
            partial=partial,
        ).validate()

    def fetch_restricted(self, alive0) -> tuple[Graph, obsv.OocReport]:
        """The edges with both endpoints in ``alive0`` ((V,) bool, host or
        device), as a full-V ``Graph`` on the handle's device, and the
        fetch's ``OocReport``.

        A chunk is read only when the alive set meets both its ``lo`` and
        its ``hi`` range.  On a disk fault the ``ChunkIOError`` carries a
        partial report (``err.tel``, ``partial=True``) of the IO done
        before it.
        """
        t0 = time.perf_counter()
        alive0 = as_numpy(alive0).astype(bool)
        if alive0.shape != (self.n_vertices,):
            raise ValueError(f"alive0 must be ({self.n_vertices},) bool, "
                             f"got shape {alive0.shape}")
        before = self.cache.counters()
        with obsv.span("ooc.fetch") as fetch_span:
            with obsv.span("ooc.manifest") as man_span:
                psum = np.zeros(self.n_vertices + 1, dtype=np.int64)
                np.cumsum(alive0, out=psum[1:])
                hit_lo = psum[self.base.lo_max + 1] > psum[self.base.lo_min]
                hit_hi = psum[self.base.hi_max + 1] > psum[self.base.hi_min]
                touched = np.nonzero(hit_lo & hit_hi)[0]
                man_span.set_attrs(chunks_touched=int(touched.size),
                                   n_chunks=self.base.n_chunks)
            parts = []
            try:
                for cid in touched:
                    rec = self.base.chunk(int(cid), self.cache)
                    keep = alive0[rec[:, 0]] & alive0[rec[:, 1]]
                    if self._ov_keys.size and keep.any():
                        keep[keep] = _not_in(_keys(rec[keep], self.n_vertices),
                                             self._ov_keys)
                    if keep.any():
                        parts.append(rec[keep])
            except ChunkIOError as err:
                # fail closed, not silent: the error carries the IO counters
                # accumulated before the fault
                err.tel = self._tel(before, t0, edges_fetched=0, partial=True)
                raise
            ov = self._ov_edges
            if ov.shape[0]:
                keep = alive0[ov[:, 0]] & alive0[ov[:, 1]]
                if keep.any():
                    parts.append(ov[keep])
            rows = (np.concatenate(parts, axis=0) if parts
                    else np.zeros((0, 3), dtype=np.int64))
            g = build_graph(self.n_vertices, self.vlabels, rows[:, :2],
                            rows[:, 2], device=self.device)
            tel = self._tel(before, t0, edges_fetched=rows.shape[0],
                            partial=False)
            fetch_span.set_attrs(chunks_read=tel["chunks_read"],
                                 edges_fetched=tel["edges_fetched"])
        return g, tel


class _Probe(NamedTuple):
    """What ``apply`` plans with, per canonical key."""

    alive: np.ndarray    # (k,) bool: the edge is in the current edge set
    label: np.ndarray    # (k,) int64: its label when alive
    in_base: np.ndarray  # (k,) bool: the base generation holds the key


class OutOfCoreGraphStore(BaseGraphStore):
    """Disk-backed ``BaseGraphStore``: the mutation, snapshot and pin
    contract of ``GraphStore``, the same query results, bounded resident
    edges.

    ``storage_dir`` owns generations ``gen-00000``, ``gen-00001``, ... (the
    newest is live; older ones survive while a snapshot handle references
    them); without it a private temporary directory is used and deleted
    with the store.  ``resident_budget_bytes`` caps the chunk cache.
    ``index="auto"`` attaches a fresh ``IncrementalIndex``: the query path
    needs resident digests, so ``index=None`` is for storage-level use.
    ``generation`` adopts that exact generation (a durable-snapshot
    restore) and raises ``ChunkIOError`` when it is gone.  ``device``
    (``None`` means ``"cuda"``) holds the index and the fetched graphs.
    """

    def __init__(self, n_vertices, vlabels, *, storage_dir: str | None = None,
                 chunk_edges: int = 2048,
                 resident_budget_bytes: int = 16 << 20,
                 index="auto", generation: int | None = None, **kwargs):
        super().__init__(n_vertices, vlabels, **kwargs)
        if storage_dir is None:
            storage_dir = tempfile.mkdtemp(prefix="ooc-store-")
            weakref.finalize(self, shutil.rmtree, storage_dir,
                             ignore_errors=True)
        self._root = storage_dir
        self.chunk_edges = int(chunk_edges)
        self.resident_budget_bytes = int(resident_budget_bytes)
        self.cache = ChunkCache(resident_budget_bytes)
        # {lo * V + hi: label, or None for a tombstone}
        self._overlay: dict[int, int | None] = {}
        self._gen_refs: dict[int, int] = {}
        gens = self._scan_generations(self._root)
        if generation is not None:
            # newer generations on disk are post-snapshot state and roll
            # back on the next GC; a missing one fails closed
            gens = [g for g in gens if g[0] == int(generation)]
            if not gens:
                raise ChunkIOError(
                    f"generation gen-{int(generation):05d} not found under "
                    f"{self._root} (snapshot references a deleted or "
                    "never-written generation)")
        if gens:
            gen_id, gpath = gens[-1]
            manifest = load_manifest(gpath)
            if int(manifest["n_vertices"]) != self.n_vertices:
                raise ChunkIOError(
                    f"generation {gpath} has n_vertices="
                    f"{manifest['n_vertices']}, store expects {self.n_vertices}")
            vlab_disk, deg = load_chunk_sidecars(gpath, self.n_vertices)
            if not np.array_equal(vlab_disk, self.vlabels):
                raise ChunkIOError(f"generation {gpath} vertex labels "
                                   "disagree with the store's")
            self._deg = deg
        else:
            gen_id, gpath = 0, self._gen_path(0)
            ChunkDirWriter(gpath, self.n_vertices, self.vlabels,
                           chunk_edges=self.chunk_edges).close()
            manifest = load_manifest(gpath)
        self._base = _Generation(gpath, gen_id, manifest, self.n_vertices)
        self._n_alive = self._base.n_records
        self._attach(index)

    def _attach(self, index) -> None:
        if index == "auto":
            from repro_torch.core.incremental import IncrementalIndex

            index = IncrementalIndex()
        if index is not None:
            self.attach_index(index)

    # -- construction --------------------------------------------------------

    @classmethod
    def open(cls, path: str, **kwargs):
        """Open an existing store root (its newest generation)."""
        gens = cls._scan_generations(path)
        if not gens:
            raise ChunkIOError(f"{path} contains no gen-NNNNN chunk directory")
        manifest = load_manifest(gens[-1][1])
        n_vertices = int(manifest["n_vertices"])
        vlab, _deg = load_chunk_sidecars(gens[-1][1], n_vertices)
        kwargs.setdefault("chunk_edges", int(manifest["chunk_edges"]))
        return cls(n_vertices, vlab, storage_dir=path, **kwargs)

    @classmethod
    def from_graph(cls, g: Graph, **kwargs):
        """Seed from a ``Graph``: its edges become the base generation."""
        vlab = as_numpy(g.vlabels)
        index = kwargs.pop("index", "auto")
        store = cls(int(vlab.shape[0]), vlab, index=None, **kwargs)
        src = as_numpy(g.src).astype(np.int64)
        dst = as_numpy(g.dst).astype(np.int64)
        keep = src < dst  # one canonical record per undirected edge
        store._install_generation(src[keep], dst[keep],
                                  as_numpy(g.elabels)[keep])
        del src, dst, keep
        store._attach(index)
        return store

    # -- generation plumbing -------------------------------------------------

    def _gen_path(self, gen_id: int) -> str:
        return os.path.join(self._root, f"gen-{gen_id:05d}")

    @staticmethod
    def _scan_generations(root: str) -> list[tuple[int, str]]:
        out = []
        if os.path.isdir(root):
            for name in os.listdir(root):
                m = _GEN_RE.match(name)
                if m:
                    out.append((int(m.group(1)), os.path.join(root, name)))
        return sorted(out)

    def _writer(self, gen_id: int) -> ChunkDirWriter:
        return ChunkDirWriter(self._gen_path(gen_id), self.n_vertices,
                              self.vlabels, chunk_edges=self.chunk_edges)

    def _install_generation(self, lo, hi, lab) -> None:
        """Write and adopt a new generation from unsorted records."""
        gen_id = self._base.gen_id + 1
        w = self._writer(gen_id)
        w.add(*sort_canonical(lo, hi, lab, self.n_vertices))
        self._adopt_generation(gen_id, w.close())

    def _adopt_generation(self, gen_id: int, manifest: dict) -> None:
        gpath = self._gen_path(gen_id)
        self._base = _Generation(gpath, gen_id, manifest, self.n_vertices)
        _vlab, self._deg = load_chunk_sidecars(gpath, self.n_vertices)
        self._n_alive = self._base.n_records
        self._gc_generations()

    def _ref_generation(self, handle: OocSnapshot) -> None:
        gen_id = handle.base.gen_id
        self._gen_refs[gen_id] = self._gen_refs.get(gen_id, 0) + 1
        weakref.finalize(handle, self._unref_generation, gen_id)

    def _unref_generation(self, gen_id: int) -> None:
        n = self._gen_refs.get(gen_id, 0) - 1
        if n <= 0:
            self._gen_refs.pop(gen_id, None)
        else:
            self._gen_refs[gen_id] = n
        self._gc_generations()

    def _gc_generations(self) -> None:
        """Delete the generation directories no live handle references."""
        live = set(self._gen_refs) | {self._base.gen_id}
        for gen_id, gpath in self._scan_generations(self._root):
            if gen_id not in live:
                shutil.rmtree(gpath, ignore_errors=True)
                self.cache.drop_generation(gen_id)

    def _gc_snapshots(self) -> None:
        super()._gc_snapshots()
        self._gc_generations()

    # -- storage interface ---------------------------------------------------

    def _lookup(self, keys: np.ndarray) -> _Probe:
        """Grouped probes: the overlay decides its keys, the base answers
        the rest (and, for an overlay insert, whether a delete must leave a
        tombstone) with one read per chunk touched."""
        keys = np.asarray(keys, dtype=np.int64)
        missing = object()
        state = [self._overlay.get(k, missing) for k in keys.tolist()]
        in_ov = np.fromiter((s is not missing for s in state), dtype=bool,
                            count=keys.size)
        ov_live = np.fromiter((s is not missing and s is not None
                               for s in state), dtype=bool, count=keys.size)
        ov_lab = np.fromiter((s if isinstance(s, int) else 0 for s in state),
                             dtype=np.int64, count=keys.size)
        tomb = in_ov & ~ov_live  # a tombstone shadows a base record
        ask = np.nonzero(~tomb)[0]
        found, base_lab = self._base.labels_of(keys[ask], self.cache)
        in_base = tomb.copy()
        in_base[ask] = found
        label = ov_lab
        label[ask[~ov_live[ask]]] = base_lab[~ov_live[ask]]
        alive = np.where(in_ov, ov_live, in_base)
        return _Probe(alive=alive, label=label, in_base=in_base)

    def _row_alive(self, probe: _Probe) -> np.ndarray:
        return probe.alive

    def _apply_planned(self, plan, lo, hi, lab, ins, probe: _Probe):
        p_lo, p_hi, p_ins = lo[plan], hi[plan], ins[plan]
        p_lab = lab[plan].copy()
        dele = ~p_ins
        p_lab[dele] = probe.label[plan][dele]  # report the label removed
        drop = probe.in_base[plan]
        v = self.n_vertices
        ov = self._overlay
        for k, l, insert, in_base in zip(
                (p_lo * v + p_hi).tolist(), p_lab.tolist(), p_ins.tolist(),
                drop.tolist()):
            if insert:
                ov[k] = l
            elif in_base:
                ov[k] = None  # tombstone the base record
            else:
                del ov[k]  # an overlay insert that never reached the base
        self._add_degrees(p_lo[p_ins], p_hi[p_ins], 1)
        self._add_degrees(p_lo[dele], p_hi[dele], -1)
        n_ins, n_del = int(p_ins.sum()), int(dele.sum())
        self._n_alive += n_ins - n_del
        applied = EdgeBatch(src=p_lo, dst=p_hi, elabels=p_lab, insert=p_ins,
                            valid=np.ones(plan.size, dtype=bool))
        return applied, n_ins, n_del

    def compact(self) -> int:
        """Merge the overlay into a new on-disk generation, O(chunk) memory.

        Returns the tombstones reclaimed.  Old generations survive while a
        snapshot handle references them; the epoch, the logical edge set
        and the attached index are unchanged.
        """
        if not self._overlay:
            return 0
        ov_keys, ov_lo, ov_hi, ov_lab, live = _overlay_arrays(
            self._overlay, self.n_vertices)
        dead = int((~live).sum())
        ov_rows = np.stack([ov_lo, ov_hi, ov_lab], axis=1)
        gen_id = self._base.gen_id + 1
        w = self._writer(gen_id)
        cursor = 0  # overlay rows merged so far
        for cid in range(self._base.n_chunks):
            rec = self._base.chunk(cid, self.cache)
            keys = _keys(rec, self.n_vertices)
            # base rows overridden by any overlay entry drop out here; the
            # live overlay rows up to this chunk's last key merge in
            stop = int(np.searchsorted(ov_keys, keys[-1], side="right"))
            merged = np.concatenate([rec[_not_in(keys, ov_keys)],
                                     ov_rows[cursor:stop][live[cursor:stop]]])
            cursor = stop
            merged = merged[np.argsort(_keys(merged, self.n_vertices),
                                       kind="stable")]
            w.add(merged[:, 0], merged[:, 1], merged[:, 2])
        tail = ov_rows[cursor:][live[cursor:]]
        w.add(tail[:, 0], tail[:, 1], tail[:, 2])
        manifest = w.close()
        self._overlay.clear()
        self._adopt_generation(gen_id, manifest)
        if dead:
            self._n_compactions += 1
        return dead

    def alive_edges(self):
        chunks = list(self.iter_alive_edge_chunks())
        if not chunks:
            z = np.zeros(0, dtype=np.int64)
            return z, z.copy(), z.copy()
        return tuple(np.concatenate([c[i] for c in chunks]) for i in range(3))

    def iter_alive_edge_chunks(self):
        """The alive edge set as ``(lo, hi, lab)`` int64 blocks in O(chunk)
        memory: base chunks without the keys the overlay overrides, then
        the overlay's live records in key order.  ``IncrementalIndex.rebuild``
        and ``GraphStats.from_store`` stream it."""
        ov_keys, ov_lo, ov_hi, ov_lab, live = _overlay_arrays(
            self._overlay, self.n_vertices)
        for cid in range(self._base.n_chunks):
            rec = self._base.chunk(cid, self.cache)
            keep = _not_in(_keys(rec, self.n_vertices), ov_keys)
            if keep.any():
                yield rec[keep, 0], rec[keep, 1], rec[keep, 2]
        if live.any():
            yield ov_lo[live], ov_hi[live], ov_lab[live]

    @property
    def n_edges(self) -> int:
        return int(self._n_alive)

    def _n_edges_dead(self) -> int:
        return sum(1 for lab in self._overlay.values() if lab is None)

    @property
    def overlay_edges(self) -> int:
        """Resident overlay entries awaiting the next compaction."""
        return len(self._overlay)

    @property
    def generation(self) -> int:
        return self._base.gen_id

    @property
    def n_chunks(self) -> int:
        return self._base.n_chunks

    # -- durable snapshots ---------------------------------------------------

    _CKPT_KIND = "ooc"

    def checkpoint_state(self):
        """Resident state only: the overlay (with its tombstone mask),
        degrees and labels.  The base edge table is referenced by
        ``(storage_root, generation)``: its chunk files are already durable,
        and ``from_checkpoint_state`` re-adopts exactly that generation."""
        _keys_, ov_lo, ov_hi, ov_lab, live = _overlay_arrays(
            self._overlay, self.n_vertices)
        leaves = {
            "vlabels": self.vlabels,
            "deg": self._deg,
            "ov_lo": ov_lo,
            "ov_hi": ov_hi,
            "ov_lab": ov_lab,
            "ov_tomb": ~live,
        }
        meta = {
            "kind": self._CKPT_KIND,
            "n_vertices": self.n_vertices,
            "epoch": self.epoch,
            "degree_cap": self.degree_cap,
            "compact_every": self.compact_every,
            "storage_root": os.path.abspath(self._root),
            "generation": self._base.gen_id,
            "chunk_edges": self.chunk_edges,
            "resident_budget_bytes": self.resident_budget_bytes,
            "n_alive": int(self._n_alive),
        }
        return leaves, meta

    @classmethod
    def from_checkpoint_state(cls, leaves, meta, *,
                              storage_dir: str | None = None, device=None):
        """Rebuild from ``checkpoint_state()`` output and the on-disk chunk
        directory (``storage_dir`` overrides the recorded root when the
        store moved), on ``device``.  Raises ``CheckpointError`` when the
        referenced generation is gone or the resident leaves disagree."""
        for k in ("vlabels", "deg", "ov_lo", "ov_hi", "ov_lab", "ov_tomb"):
            if k not in leaves:
                raise CheckpointError(f"ooc snapshot is missing leaf {k!r}")
        n = int(meta["n_vertices"])
        root = storage_dir if storage_dir is not None else meta["storage_root"]
        try:
            store = cls(
                n, np.asarray(leaves["vlabels"], dtype=np.int32),
                storage_dir=root,
                chunk_edges=int(meta["chunk_edges"]),
                resident_budget_bytes=int(meta["resident_budget_bytes"]),
                index=None,
                generation=int(meta["generation"]),
                degree_cap=meta.get("degree_cap"),
                compact_every=int(meta.get("compact_every", 64)),
                device=device,
            )
        except ChunkIOError as err:
            raise CheckpointError(f"ooc snapshot restore failed: {err}") from err
        ov_lo = np.asarray(leaves["ov_lo"], dtype=np.int64)
        ov_hi = np.asarray(leaves["ov_hi"], dtype=np.int64)
        ov_lab = np.asarray(leaves["ov_lab"], dtype=np.int64)
        ov_tomb = np.asarray(leaves["ov_tomb"], dtype=bool)
        if not (ov_lo.shape == ov_hi.shape == ov_lab.shape == ov_tomb.shape):
            raise CheckpointError("ooc snapshot overlay arrays disagree in "
                                  "length")
        if ov_lo.size and (ov_lo.min() < 0 or ov_hi.max() >= n
                           or not (ov_lo < ov_hi).all()):
            raise CheckpointError(
                f"ooc snapshot overlay is not canonical (need 0 <= lo < hi "
                f"< {n})")
        deg = np.asarray(leaves["deg"], dtype=np.int64)
        if deg.shape != (n,):
            raise CheckpointError(
                f"ooc snapshot deg shape {deg.shape} disagrees with "
                f"n_vertices={n}")
        store._overlay = {
            int(k): (None if t else int(lab))
            for k, lab, t in zip(ov_lo * n + ov_hi, ov_lab, ov_tomb)
        }
        store._deg = deg.copy()
        store._n_alive = int(meta["n_alive"])
        store.epoch = int(meta["epoch"])
        return store

    # -- snapshots -----------------------------------------------------------

    def snapshot(self) -> GraphSnapshot:
        """An epoch view whose ``graph`` holds labels and no edges; its
        ``ooc`` handle fetches edges on demand and pins this generation."""
        snap = self._snapshots.get(self.epoch)
        if snap is None:
            idx = self._index.freeze() if self._index is not None else None
            handle = OocSnapshot(
                base=self._base, overlay=dict(self._overlay), cache=self.cache,
                n_vertices=self.n_vertices, vlabels=self.vlabels,
                d_max=max(1, self.max_degree), epoch=self.epoch,
                device=self.device,
            )
            self._ref_generation(handle)
            empty = torch.zeros(0, dtype=torch.int64, device=self.device)
            g = Graph(vlabels=torch.as_tensor(self.vlabels, device=self.device),
                      src=empty, dst=empty.clone(),
                      elabels=torch.zeros(0, dtype=torch.int32,
                                          device=self.device))
            snap = GraphSnapshot(self.epoch, g, idx, ooc=handle)
            self._snapshots[self.epoch] = snap
        return snap
