"""Edge files and chunk directories on disk, port of ``repro.graphs.io``.

Both formats are shared with the reference byte for byte: a file or a
directory written by one package is read by the other.

* **Edge files** hold ``[n_vertices, n_records]`` (int64), the vertex
  labels (int64) and ``(src, dst, elabel)`` records (int64): the paper's
  single-pass access model (§3.4).  ``stream_edge_chunks`` yields
  fixed-size padded chunks in one sequential pass, and
  ``iter_update_batches`` turns any edge source into fixed-size
  ``EdgeBatch``es (the stream filter's and the store's common currency).
* **Chunk directories** are the out-of-core store's random-access format
  (``graphs/ooc.py``): canonical ``(lo, hi, label)`` records sorted by
  ``(lo, hi)`` in ``chunk_%05d.bin`` files, each with a 6-word header
  (magic ``0x434E4943``, record count, lo and hi bounds), the
  ``vlabels.bin`` / ``degrees.bin`` sidecars and a JSON manifest whose
  per-chunk bounds are the interval index.

Every read validates byte counts and headers against the header or the
manifest and raises ``ChunkIOError`` on a mismatch: the disk tier fails
closed, never with a silently wrong edge set.
"""

from __future__ import annotations

import json
import os
from typing import Iterator

import numpy as np

from repro_torch.graphs.csr import Graph, as_numpy, graph_to

_HEADER_DTYPE = np.int64


class ChunkIOError(RuntimeError):
    """On-disk graph data failed validation (truncated, corrupt, missing).

    Raised by every disk read path, edge files and chunk directories
    alike.  A failed out-of-core fetch attaches its partial ``OocReport``
    as ``err.tel``; the service releases the request's epoch pin on the
    way out, so the store stays usable.
    """


def _read_edge_header(path: str) -> tuple[int, int]:
    """Validated ``(n_vertices, n_records)`` of an edge file: the header
    must agree with the file's byte count."""
    try:
        size = os.path.getsize(path)
    except OSError as e:
        raise ChunkIOError(f"edge file missing or unreadable: {path}") from e
    if size < 16:
        raise ChunkIOError(
            f"edge file {path} has {size} bytes — too short for a header")
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_HEADER_DTYPE, count=2)
    n_v, n_rec = int(header[0]), int(header[1])
    if n_v < 0 or n_rec < 0:
        raise ChunkIOError(
            f"edge file {path} header is corrupt: "
            f"n_vertices={n_v}, n_records={n_rec}")
    expect = 16 + 8 * n_v + 24 * n_rec
    if size != expect:
        raise ChunkIOError(
            f"edge file {path} is {size} bytes but its header "
            f"(n_vertices={n_v}, n_records={n_rec}) requires {expect}")
    return n_v, n_rec


def write_edge_file(path: str, g: Graph, *, sorted_by_src: bool = True) -> None:
    """Serialize a graph: header, vertex labels, then its directed records,
    stably sorted by src or in ``default_rng(0)``'s permutation."""
    vlab = as_numpy(g.vlabels).astype(np.int64)
    src = as_numpy(g.src).astype(np.int64)
    if sorted_by_src:
        order = np.argsort(src, kind="stable")
    else:
        order = np.random.default_rng(0).permutation(src.size)
    rec = np.empty((src.size, 3), dtype=np.int64)
    rec[:, 0] = src[order]
    del src
    rec[:, 1] = as_numpy(g.dst)[order]
    rec[:, 2] = as_numpy(g.elabels)[order]
    with open(path, "wb") as f:
        np.array([vlab.size, rec.shape[0]], dtype=_HEADER_DTYPE).tofile(f)
        vlab.tofile(f)
        rec.tofile(f)


def read_edge_file(path: str, *, device=None) -> Graph:
    """The whole edge file as a ``Graph`` on ``device`` (``None`` means
    ``"cuda"``), records in file order."""
    n_v, n_rec = _read_edge_header(path)
    with open(path, "rb") as f:
        f.seek(16)
        vlab = np.fromfile(f, dtype=np.int64, count=n_v)
        rec = np.fromfile(f, dtype=np.int64, count=n_rec * 3).reshape(-1, 3)
    return graph_to(Graph(vlab, rec[:, 0], rec[:, 1], rec[:, 2]), device)


def stream_edge_chunks(
    path: str, chunk_edges: int
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Yield ``(src, dst, elabel, valid)`` chunks of exactly
    ``chunk_edges`` rows (int32, int32, int32, bool), the last padded with
    ``valid=False`` rows: one sequential pass, O(chunk) memory."""
    n_v, n_rec = _read_edge_header(path)
    with open(path, "rb") as f:
        f.seek(16 + n_v * 8)  # past the header and the label block
        remaining = n_rec
        while remaining > 0:
            take = min(chunk_edges, remaining)
            rec = np.fromfile(f, dtype=np.int64, count=take * 3).reshape(-1, 3)
            remaining -= take
            out = np.zeros((3, chunk_edges), dtype=np.int32)
            out[:, :take] = rec.T
            valid = np.zeros(chunk_edges, dtype=bool)
            valid[:take] = True
            yield out[0], out[1], out[2], valid


def read_vertex_labels(path: str) -> np.ndarray:
    n_v, _ = _read_edge_header(path)
    with open(path, "rb") as f:
        f.seek(16)
        return np.fromfile(f, dtype=np.int64, count=n_v).astype(np.int32)


def iter_update_batches(source, chunk_edges: int):
    """Normalize an edge source into ``EdgeBatch``es of exactly
    ``chunk_edges`` rows (the tail padded with ``valid=False`` inserts).

    ``source`` is an edge-file path, a port ``Graph`` (its directed records
    replayed as inserts: a static load is an update stream that never
    deletes), or an iterable of legacy ``(src, dst, elabel, valid)`` tuples
    or ``EdgeBatch``es.  Dtypes follow the source, as in the reference.
    """
    from repro_torch.graphs.store import EdgeBatch

    def _pad(s, d, e, valid, insert):
        take = s.shape[0]
        if take < chunk_edges:
            pad = chunk_edges - take
            s = np.concatenate([s, np.zeros(pad, s.dtype)])
            d = np.concatenate([d, np.zeros(pad, d.dtype)])
            e = np.concatenate([e, np.zeros(pad, e.dtype)])
            valid = np.concatenate([valid, np.zeros(pad, dtype=bool)])
            insert = np.concatenate([insert, np.ones(pad, dtype=bool)])
        return EdgeBatch(src=s, dst=d, elabels=e, insert=insert, valid=valid)

    if isinstance(source, str):
        for s, d, e, valid in stream_edge_chunks(source, chunk_edges):
            yield EdgeBatch(src=s, dst=d, elabels=e,
                            insert=np.ones(s.shape[0], dtype=bool),
                            valid=valid)
        return
    if isinstance(source, Graph):
        src, dst, elab = (as_numpy(x) for x in
                          (source.src, source.dst, source.elabels))
        n = src.shape[0]
        for start in range(0, max(n, 1), chunk_edges):
            s = src[start:start + chunk_edges]
            if s.size == 0 and start > 0:
                break
            ones = np.ones(s.shape[0], dtype=bool)
            yield _pad(s, dst[start:start + chunk_edges],
                       elab[start:start + chunk_edges], ones, ones.copy())
        return
    for item in source:
        if isinstance(item, EdgeBatch):
            yield _pad(as_numpy(item.src), as_numpy(item.dst),
                       as_numpy(item.elabels),
                       as_numpy(item.valid).astype(bool),
                       as_numpy(item.insert).astype(bool))
        else:
            s, d, e, valid = (as_numpy(x) for x in item)
            yield _pad(s, d, e, valid.astype(bool),
                       np.ones(s.shape[0], dtype=bool))


# ---------------------------------------------------------------------------
# Chunk directory: the out-of-core store's on-disk edge table.
# ---------------------------------------------------------------------------

MANIFEST_NAME = "manifest.json"
_CHUNK_MAGIC = 0x434E4943  # "CNIC"
_CHUNK_HEADER_BYTES = 6 * 8  # magic, n_records, lo_min, lo_max, hi_min, hi_max
_REC_BYTES = 3 * 8           # (lo, hi, elabel) int64


class ChunkDirWriter:
    """Stream (lo, hi)-sorted canonical records into a chunk directory:
    ``chunk_%05d.bin`` files of ``chunk_edges`` records, ``vlabels.bin``,
    ``degrees.bin`` and the manifest (written last, by ``os.replace``).

    ``add`` takes sorted blocks of any size in O(block) memory; order
    across calls is checked, because the manifest's key ranges are the
    point-probe index.  A repeated key is rejected.
    """

    def __init__(self, path: str, n_vertices: int, vlabels, *,
                 chunk_edges: int = 4096):
        if chunk_edges <= 0:
            raise ValueError(f"chunk_edges must be positive, got {chunk_edges}")
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.n_vertices = int(n_vertices)
        self.chunk_edges = int(chunk_edges)
        self._vlabels = as_numpy(vlabels).astype(np.int64)
        if self._vlabels.shape != (self.n_vertices,):
            raise ValueError(f"vlabels has shape {self._vlabels.shape}, "
                             f"expected ({self.n_vertices},)")
        self._degrees = np.zeros(self.n_vertices, dtype=np.int64)
        self._pending = np.zeros((0, 3), dtype=np.int64)
        self._entries: list[dict] = []
        self._last_key = (-1, -1)
        self._closed = False

    def add(self, lo, hi, lab) -> None:
        lo = np.asarray(lo, dtype=np.int64)
        hi = np.asarray(hi, dtype=np.int64)
        lab = np.asarray(lab, dtype=np.int64)
        if lo.size == 0:
            return
        if lo.min() < 0 or hi.max() >= self.n_vertices or (lo >= hi).any():
            raise ValueError("records must be canonical: 0 <= lo < hi < V")
        key = lo * np.int64(self.n_vertices) + hi
        if (np.diff(key) <= 0).any() or (int(lo[0]), int(hi[0])) <= self._last_key:
            raise ValueError(
                "chunk-dir records must be strictly increasing by (lo, hi) "
                "across all add() calls")
        del key
        self._last_key = (int(lo[-1]), int(hi[-1]))
        self._degrees += np.bincount(lo, minlength=self.n_vertices)
        self._degrees += np.bincount(hi, minlength=self.n_vertices)
        rec = np.empty((self._pending.shape[0] + lo.size, 3), dtype=np.int64)
        rec[:self._pending.shape[0]] = self._pending
        tail = rec[self._pending.shape[0]:]
        tail[:, 0], tail[:, 1], tail[:, 2] = lo, hi, lab
        n_full = rec.shape[0] // self.chunk_edges * self.chunk_edges
        for start in range(0, n_full, self.chunk_edges):
            self._write_chunk(rec[start:start + self.chunk_edges])
        self._pending = rec[n_full:].copy()

    def _write_chunk(self, rec: np.ndarray) -> None:
        name = f"chunk_{len(self._entries):05d}.bin"
        hi_min, hi_max = int(rec[:, 1].min()), int(rec[:, 1].max())
        header = np.array([_CHUNK_MAGIC, rec.shape[0], rec[0, 0], rec[-1, 0],
                           hi_min, hi_max], dtype=np.int64)
        with open(os.path.join(self.path, name), "wb") as f:
            header.tofile(f)
            np.ascontiguousarray(rec).tofile(f)
        self._entries.append({
            "file": name,
            "n_records": int(rec.shape[0]),
            "lo_min": int(rec[0, 0]),
            "lo_max": int(rec[-1, 0]),
            "hi_min": hi_min,
            "hi_max": hi_max,
            # first/last full (lo, hi) keys: the point-probe binary search
            "hi_first": int(rec[0, 1]),
            "hi_last": int(rec[-1, 1]),
        })

    def close(self) -> dict:
        """Flush the tail chunk, write the sidecars and the manifest;
        returns the manifest."""
        if self._closed:
            raise RuntimeError("ChunkDirWriter already closed")
        self._closed = True
        if self._pending.shape[0]:
            self._write_chunk(self._pending)
            self._pending = np.zeros((0, 3), dtype=np.int64)
        self._vlabels.tofile(os.path.join(self.path, "vlabels.bin"))
        self._degrees.tofile(os.path.join(self.path, "degrees.bin"))
        manifest = {
            "version": 1,
            "n_vertices": self.n_vertices,
            "chunk_edges": self.chunk_edges,
            "n_records": int(sum(e["n_records"] for e in self._entries)),
            "chunks": self._entries,
        }
        tmp = os.path.join(self.path, MANIFEST_NAME + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(self.path, MANIFEST_NAME))
        return manifest


def sort_canonical(lo, hi, lab, n_vertices: int):
    """``(lo, hi, lab)`` as int64 in the writer's (lo, hi) order: one stable
    sort of the int64 key ``lo * V + hi`` (``np.lexsort((hi, lo))``'s
    order)."""
    lo = np.asarray(lo, dtype=np.int64)
    hi = np.asarray(hi, dtype=np.int64)
    order = np.argsort(lo * np.int64(n_vertices) + hi, kind="stable")
    return lo[order], hi[order], np.asarray(lab, dtype=np.int64)[order]


def write_chunk_dir(path: str, n_vertices: int, vlabels, lo, hi, lab, *,
                    chunk_edges: int = 4096) -> dict:
    """One-shot chunk directory from in-memory canonical records, sorted by
    (lo, hi) first; ``ChunkDirWriter`` streams larger tables."""
    w = ChunkDirWriter(path, n_vertices, vlabels, chunk_edges=chunk_edges)
    w.add(*sort_canonical(lo, hi, lab, n_vertices))
    return w.close()


def load_manifest(path: str) -> dict:
    """Parse a chunk directory's manifest and check its structure."""
    mpath = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mpath, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except OSError as e:
        raise ChunkIOError(f"chunk directory {path} has no manifest") from e
    except json.JSONDecodeError as e:
        raise ChunkIOError(f"manifest {mpath} is not valid JSON") from e
    for field in ("version", "n_vertices", "chunk_edges", "n_records",
                  "chunks"):
        if field not in manifest:
            raise ChunkIOError(f"manifest {mpath} is missing field {field!r}")
    for entry in manifest["chunks"]:
        for field in ("file", "n_records", "lo_min", "lo_max",
                      "hi_min", "hi_max", "hi_first", "hi_last"):
            if field not in entry:
                raise ChunkIOError(
                    f"manifest {mpath} chunk entry is missing {field!r}")
    return manifest


def load_chunk_sidecars(path: str, n_vertices: int):
    """``(vlabels (V,) int32, degrees (V,) int64)``, sizes checked."""
    out = []
    for name, dtype in (("vlabels.bin", np.int32), ("degrees.bin", np.int64)):
        fp = os.path.join(path, name)
        try:
            size = os.path.getsize(fp)
        except OSError as e:
            raise ChunkIOError(f"chunk directory {path} missing {name}") from e
        if size != n_vertices * 8:
            raise ChunkIOError(
                f"{fp} is {size} bytes, expected {n_vertices * 8} "
                f"(n_vertices={n_vertices})")
        out.append(np.fromfile(fp, dtype=np.int64).astype(dtype))
    return out[0], out[1]


def read_chunk(path: str, entry: dict, n_vertices: int) -> np.ndarray:
    """One chunk as ``(n_records, 3)`` int64 ``(lo, hi, lab)``, validated.

    The file size and the header are checked against the manifest entry
    before any record is trusted; the records are copied out of the
    mapping (the cache owns plain arrays, so its byte count is exact).  A
    missing file, a truncation, a bad magic, bounds drift or an
    out-of-range endpoint raises ``ChunkIOError``.
    """
    fp = os.path.join(path, entry["file"])
    n = int(entry["n_records"])
    try:
        size = os.path.getsize(fp)
    except OSError as e:
        raise ChunkIOError(
            f"chunk file {fp} listed in the manifest is missing") from e
    expect = _CHUNK_HEADER_BYTES + n * _REC_BYTES
    if size != expect:
        raise ChunkIOError(
            f"chunk file {fp} is {size} bytes but the manifest requires "
            f"{expect} (n_records={n})")
    try:
        mm = np.memmap(fp, dtype=np.int64, mode="r")
    except (OSError, ValueError) as e:
        raise ChunkIOError(f"chunk file {fp} could not be mapped") from e
    try:
        header = np.asarray(mm[:6])
        if int(header[0]) != _CHUNK_MAGIC:
            raise ChunkIOError(f"chunk file {fp} has a corrupted header "
                               f"(bad magic {int(header[0]):#x})")
        if (int(header[1]) != n
                or int(header[2]) != int(entry["lo_min"])
                or int(header[3]) != int(entry["lo_max"])
                or int(header[4]) != int(entry["hi_min"])
                or int(header[5]) != int(entry["hi_max"])):
            raise ChunkIOError(
                f"chunk file {fp} header disagrees with the manifest entry")
        rec = np.array(mm[6:]).reshape(n, 3)
    finally:
        del mm
    if n and (rec[:, 0].min() < 0 or rec[:, 1].max() >= n_vertices
              or (rec[:, 0] >= rec[:, 1]).any()):
        raise ChunkIOError(
            f"chunk file {fp} contains non-canonical or out-of-range records")
    return rec
