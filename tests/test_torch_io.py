"""The port's edge files and chunk directories against the reference's.

* Edge files are byte-identical in both record orders (the unsorted one is
  ``default_rng(0)``'s permutation), each package reads the other's file,
  and ``stream_edge_chunks`` yields the same padded chunks.
* Chunk directories are byte-identical file for file, with equal
  manifests, whether written in one block or streamed in uneven ones; each
  package reads the other's chunks.
* Every header, manifest and sidecar fault raises ``ChunkIOError``.
* ``iter_update_batches`` gives equal batches for every source kind: a
  path, a graph, legacy tuples and ``EdgeBatch``es.
"""

import json
import os

import numpy as np
import pytest

import repro.graphs.io as rio
import repro_torch.graphs.io as pio
from repro.graphs import random_labeled_graph
from repro.graphs.store import EdgeBatch as RefEdgeBatch
from repro_torch.graphs import graph_from_numpy
from repro_torch.graphs.store import EdgeBatch
from strategies import graph_chunks


def port(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def _graph(seed=0, n_vertices=36, n_edges=90):
    return random_labeled_graph(n_vertices, n_edges, 3, n_edge_labels=2,
                                seed=seed)


def _canonical(g):
    src, dst, lab = (np.asarray(x).astype(np.int64)
                     for x in (g.src, g.dst, g.elabels))
    keep = src < dst
    return src[keep], dst[keep], lab[keep]


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


# ---------------------------------------------------------------------------
# edge files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sorted_by_src", [True, False])
def test_edge_files_byte_identical_and_cross_read(tmp_path, seed,
                                                  sorted_by_src):
    g = _graph(seed, n_edges=40 + 37 * seed)
    ref_path, port_path = str(tmp_path / "r.bin"), str(tmp_path / "p.bin")
    rio.write_edge_file(ref_path, g, sorted_by_src=sorted_by_src)
    pio.write_edge_file(port_path, port(g), sorted_by_src=sorted_by_src)
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    # each package reads the other's file: same records in file order
    got = pio.read_edge_file(ref_path, device="cpu")
    want = rio.read_edge_file(port_path)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(pio.read_vertex_labels(ref_path),
                                  rio.read_vertex_labels(ref_path))
    for chunk in (1, 16, 1000):
        ref_chunks = list(rio.stream_edge_chunks(ref_path, chunk))
        got_chunks = list(pio.stream_edge_chunks(port_path, chunk))
        assert len(got_chunks) == len(ref_chunks)
        for a, b in zip(got_chunks, ref_chunks):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == (chunk,)
                np.testing.assert_array_equal(x, y)


def test_edge_file_header_faults(tmp_path):
    g = port(_graph())
    path = str(tmp_path / "g.bin")
    pio.write_edge_file(path, g)
    good = os.path.getsize(path)
    with open(path, "r+b") as f:        # truncated mid-record
        f.truncate(good - 10)
    with pytest.raises(pio.ChunkIOError, match="requires"):
        pio.read_edge_file(path, device="cpu")
    with pytest.raises(pio.ChunkIOError):
        list(pio.stream_edge_chunks(path, 16))
    pio.write_edge_file(path, g)
    with open(path, "ab") as f:         # trailing garbage
        f.write(b"\x00" * 7)
    with pytest.raises(pio.ChunkIOError, match="requires"):
        pio.read_vertex_labels(path)
    pio.write_edge_file(path, g)
    with open(path, "r+b") as f:        # negative count in the header
        f.seek(8)
        f.write(np.int64(-4).tobytes())
    with pytest.raises(pio.ChunkIOError, match="corrupt"):
        pio.read_edge_file(path, device="cpu")
    with open(path, "wb") as f:         # too short for any header
        f.write(b"\x01\x02")
    with pytest.raises(pio.ChunkIOError, match="too short"):
        pio.read_edge_file(path, device="cpu")
    with pytest.raises(pio.ChunkIOError, match="missing"):
        pio.read_edge_file(str(tmp_path / "nope.bin"), device="cpu")


# ---------------------------------------------------------------------------
# chunk directories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_edges", [7, 16, 10_000])
def test_chunk_dirs_byte_identical(tmp_path, chunk_edges):
    g = _graph(n_edges=120)
    lo, hi, lab = _canonical(g)
    # shuffled input: both writers sort by (lo, hi) first
    perm = np.random.default_rng(1).permutation(lo.size)
    vlab = np.asarray(g.vlabels)
    m_ref = rio.write_chunk_dir(str(tmp_path / "r"), g.n_vertices, vlab,
                                lo[perm], hi[perm], lab[perm],
                                chunk_edges=chunk_edges)
    m_port = pio.write_chunk_dir(str(tmp_path / "p"), g.n_vertices, vlab,
                                 lo[perm], hi[perm], lab[perm],
                                 chunk_edges=chunk_edges)
    assert m_port == m_ref
    _same_dirs(tmp_path / "r", tmp_path / "p")
    # streamed in uneven sorted blocks, the same directory
    order = np.lexsort((hi, lo))
    w = pio.ChunkDirWriter(str(tmp_path / "s"), g.n_vertices, vlab,
                           chunk_edges=chunk_edges)
    for block in np.array_split(order, [1, 4, 5, 30, 31, 90]):
        w.add(lo[block], hi[block], lab[block])
    assert w.close() == m_ref
    _same_dirs(tmp_path / "r", tmp_path / "s")
    # each package reads the other's chunks and manifest
    assert pio.load_manifest(str(tmp_path / "r")) == \
        rio.load_manifest(str(tmp_path / "p"))
    for entry in m_ref["chunks"]:
        np.testing.assert_array_equal(
            pio.read_chunk(str(tmp_path / "r"), entry, g.n_vertices),
            rio.read_chunk(str(tmp_path / "p"), entry, g.n_vertices))
    for a, b in zip(pio.load_chunk_sidecars(str(tmp_path / "r"), g.n_vertices),
                    rio.load_chunk_sidecars(str(tmp_path / "p"), g.n_vertices)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_chunk_dir_writer_validates(tmp_path):
    w = pio.ChunkDirWriter(str(tmp_path / "cd"), 10, np.zeros(10, np.int64))
    w.add([0], [3], [1])
    with pytest.raises(ValueError, match="canonical"):
        w.add([5], [5], [0])            # lo == hi
    with pytest.raises(ValueError, match="canonical"):
        w.add([3], [12], [0])           # out of range
    with pytest.raises(ValueError, match="increasing"):
        w.add([0], [2], [0])            # key order violated
    w.add([0, 4], [4, 7], [0, 1])
    assert w.close()["n_records"] == 3
    with pytest.raises(RuntimeError, match="closed"):
        w.close()
    with pytest.raises(ValueError, match="positive"):
        pio.ChunkDirWriter(str(tmp_path / "x"), 10, np.zeros(10), chunk_edges=0)


@pytest.fixture
def chunk_dir(tmp_path):
    g = _graph(n_edges=120)
    lo, hi, lab = _canonical(g)
    root = str(tmp_path / "cd")
    manifest = pio.write_chunk_dir(root, g.n_vertices, np.asarray(g.vlabels),
                                   lo, hi, lab, chunk_edges=16)
    return root, manifest, g.n_vertices


def _chunk_path(root, manifest, i=0):
    return os.path.join(root, manifest["chunks"][i]["file"])


def test_chunk_faults(chunk_dir, monkeypatch):
    root, manifest, n = chunk_dir
    entry = manifest["chunks"][0]
    fp = _chunk_path(root, manifest)
    data = open(fp, "rb").read()

    def put(raw):
        with open(fp, "wb") as f:
            f.write(raw)

    put(data[:-8])                                     # truncated
    with pytest.raises(pio.ChunkIOError, match="bytes"):
        pio.read_chunk(root, entry, n)
    put(b"\xde\xad\xbe\xef" * 2 + data[8:])            # bad magic
    with pytest.raises(pio.ChunkIOError, match="magic"):
        pio.read_chunk(root, entry, n)
    put(data[:16] + np.int64(n + 7).tobytes() + data[24:])  # lo_min drift
    with pytest.raises(pio.ChunkIOError, match="disagrees"):
        pio.read_chunk(root, entry, n)
    put(data)
    with pytest.raises(pio.ChunkIOError, match="non-canonical"):
        pio.read_chunk(root, entry, n_vertices=2)      # endpoints past V
    with monkeypatch.context() as mp:

        def flaky(*args, **kw):
            raise OSError("simulated device read failure")

        mp.setattr(pio.np, "memmap", flaky)
        with pytest.raises(pio.ChunkIOError, match="could not be mapped"):
            pio.read_chunk(root, entry, n)
    os.remove(fp)
    with pytest.raises(pio.ChunkIOError, match="missing"):
        pio.read_chunk(root, entry, n)


def test_manifest_and_sidecar_faults(chunk_dir):
    root, manifest, n = chunk_dir
    mpath = os.path.join(root, pio.MANIFEST_NAME)
    for broken, match in (
        ({k: v for k, v in manifest.items() if k != "chunks"}, "missing field"),
        ({**manifest, "chunks": [{k: v for k, v in e.items() if k != "hi_last"}
                                 for e in manifest["chunks"]]}, "missing"),
    ):
        with open(mpath, "w") as f:
            json.dump(broken, f)
        with pytest.raises(pio.ChunkIOError, match=match):
            pio.load_manifest(root)
    with open(mpath, "w") as f:
        f.write("{ not json")
    with pytest.raises(pio.ChunkIOError, match="JSON"):
        pio.load_manifest(root)
    os.remove(mpath)
    with pytest.raises(pio.ChunkIOError, match="no manifest"):
        pio.load_manifest(root)
    vpath = os.path.join(root, "vlabels.bin")
    with open(vpath, "r+b") as f:
        f.truncate(os.path.getsize(vpath) - 8)
    with pytest.raises(pio.ChunkIOError, match="expected"):
        pio.load_chunk_sidecars(root, n)
    os.remove(os.path.join(root, "degrees.bin"))
    with pytest.raises(pio.ChunkIOError):
        pio.load_chunk_sidecars(root, n)


# ---------------------------------------------------------------------------
# iter_update_batches, every source kind
# ---------------------------------------------------------------------------


def _assert_batches_equal(got, want, *, same_dtypes=True):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, EdgeBatch)
        for name in RefEdgeBatch._fields:
            x, y = getattr(a, name), getattr(b, name)
            np.testing.assert_array_equal(x, y, name)
            if same_dtypes:
                assert x.dtype == y.dtype, name


@pytest.mark.parametrize("chunk", [1, 7, 64, 1000])
def test_iter_update_batches_every_source(tmp_path, chunk):
    g = _graph(n_edges=70)
    path = str(tmp_path / "g.bin")
    rio.write_edge_file(path, g, sorted_by_src=False)
    _assert_batches_equal(pio.iter_update_batches(path, chunk),
                          rio.iter_update_batches(path, chunk))
    # a graph's directed records (the port's src/dst are int64 where the
    # reference's are int32, so only the values are compared)
    _assert_batches_equal(pio.iter_update_batches(port(g), chunk),
                          rio.iter_update_batches(g, chunk),
                          same_dtypes=False)
    tuples = graph_chunks(g, 13)
    _assert_batches_equal(pio.iter_update_batches(tuples, chunk),
                          rio.iter_update_batches(tuples, chunk))
    rng = np.random.default_rng(chunk)
    batches = [RefEdgeBatch(src=rng.integers(0, 36, k), dst=rng.integers(0, 36, k),
                            elabels=rng.integers(0, 2, k),
                            insert=rng.random(k) < 0.6, valid=rng.random(k) < 0.9)
               for k in (0, 1, 5, 9)]
    ported = [EdgeBatch(*b) for b in batches]
    _assert_batches_equal(pio.iter_update_batches(ported, chunk),
                          rio.iter_update_batches(batches, chunk))
    for b in pio.iter_update_batches(ported, chunk):
        assert b.src.shape[0] >= chunk
