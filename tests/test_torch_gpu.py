"""The CUDA kernels against their plain versions, on the card.

Marked ``gpu``; each test skips with a reason where no CUDA device is
present.  Run on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (
    BatchQueryEngine,
    IncrementalIndex,
    QueryPlanner,
    SubgraphQueryEngine,
    device_join_search,
)
from repro_torch.core.cni import LOG_SAT64, default_max_p
from repro_torch.graphs import (
    GraphStore,
    random_labeled_graph,
    random_update_batches,
    random_walk_query,
    to_host,
)
from repro_torch.kernels.candidate_filter import ops as cf_ops
from repro_torch.kernels.candidate_filter import ref as cf_ref
from repro_torch.kernels.cni_encode import ops as enc_ops
from repro_torch.kernels.cni_encode import ref as enc_ref
from repro_torch.kernels.cni_update import ops as upd_ops
from repro_torch.kernels.cni_update import ref as upd_ref
from repro_torch.kernels.embed_join import ops, ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.serve import GraphQueryService, GraphServiceConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def random_level(r, t, c, n, j, seed, device):
    rng = np.random.default_rng(seed)
    cand = np.sort(rng.choice(n, size=min(c, n), replace=False))
    arrays = (
        rng.integers(0, n, size=(r, t)).astype(np.int32),
        rng.random(r) < 0.8,
        np.pad(cand, (0, c - cand.size)).astype(np.int32),
        (np.arange(c) < cand.size) & (rng.random(c) < 0.9),
        np.where(rng.random((n, n)) < 0.3, rng.integers(0, 3, size=(n, n)),
                 -1).astype(np.int32),
        rng.integers(0, t, size=j).astype(np.int32),
        rng.integers(0, 3, size=j).astype(np.int32),
        rng.random(j) < 0.7,
    )
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


SHAPES = [(64, 3, 32, 50, 2), (100, 1, 33, 40, 1), (1013, 5, 640, 700, 3),
          (301, 16, 200, 90, 4), (4096, 2, 1024, 1100, 1)]


@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_equal_plain_versions(cuda, shape):
    args = random_level(*shape, seed=sum(shape), device=cuda)
    before = ops.launch_counts()
    grid = ops.embed_join(*args)
    counts = ops.embed_join_count(*args)
    torch.testing.assert_close(grid, ref.embed_join_grid_ref(*args), rtol=0, atol=0)
    torch.testing.assert_close(counts, ref.embed_join_count_ref(*args), rtol=0, atol=0)
    row_off = counts.cumsum(0) - counts
    total = int(counts.sum())
    for row_base in (0, 777):
        fill = torch.full((total + 9,), -7, dtype=torch.int64, device=cuda)
        got = ops.embed_join_emit(fill.clone(), *args, row_off, row_base)
        want = ref.embed_join_emit_ref(fill.clone(), *args, row_off, row_base)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    after = ops.launch_counts()
    assert after["embed_join_grid"] - before["embed_join_grid"] == 1
    assert after["embed_join_count"] - before["embed_join_count"] == 1
    assert after["embed_join_emit"] - before["embed_join_emit"] == 2


# the count and emit kernels' widest block pass: 8 warps x 32 lanes x K 8
PASS = 8 * 32 * 8

EDGE_SHAPES = {  # (R, T, C, N, J) at the edges of the kernels' blocks
    "C_one_pass_K4": (300, 4, 1024, 1100, 2),
    "C_one_more_K4": (300, 4, 1025, 1100, 2),
    "C_one_pass": (64, 3, PASS, PASS + 100, 2),
    "C_one_more": (64, 3, PASS + 1, PASS + 100, 2),
    "C_three_passes_ragged": (40, 3, 3 * PASS + 77, 3 * PASS + 177, 2),
    "R1": (1, 3, 640, 700, 2),
    "T16_two_rows_a_block": (600, 16, 1100, 1200, 3),
}


def edge_level(name, device):
    """The operands of one edge case: a random level, or one of them with
    every row dead or a single inert constraint."""
    if name == "all_rows_invalid":
        args = list(random_level(300, 3, 640, 700, 2, seed=1, device=device))
        args[1] = torch.zeros_like(args[1])
    elif name == "inert_J1":
        args = list(random_level(500, 3, 1024, 1100, 1, seed=2, device=device))
        args[7] = torch.zeros_like(args[7])
    else:
        shape = EDGE_SHAPES[name]
        args = random_level(*shape, seed=sum(shape), device=device)
    return tuple(args)


def emit_guarded(args, row_off, row_base, cap, guard=64):
    """The emit kernel into the first ``cap`` slots of a buffer filled with
    -7; returns the whole buffer, so a write past ``cap`` shows."""
    buf = torch.full((cap + guard,), -7, dtype=torch.int64, device=args[0].device)
    ops.embed_join_emit(buf[:cap], *args, row_off, row_base)
    return buf


@pytest.mark.parametrize("name", [*EDGE_SHAPES, "all_rows_invalid", "inert_J1"])
def test_count_and_emit_at_block_edges(cuda, name):
    """Count and emit equal their plain versions bit for bit: candidate
    lists of one block pass, one more, three and a ragged tail; one row;
    every row dead; a single inert constraint; 16 columns."""
    args = edge_level(name, cuda)
    counts = ops.embed_join_count(*args)
    want = ref.embed_join_count_ref(*args)
    torch.testing.assert_close(counts, want, rtol=0, atol=0)
    row_off = want.cumsum(0) - want
    total = int(want.sum())
    if name == "all_rows_invalid":
        assert total == 0
    got = emit_guarded(args, row_off, 5, total + 9)
    plain = torch.full_like(got, -7)
    ref.embed_join_emit_ref(plain[:total + 9], *args, row_off, 5)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert bool((got[total:] == -7).all())


GRID_EDGES = [*EDGE_SHAPES, "all_rows_invalid", "inert_J1"]


@pytest.mark.parametrize("name", GRID_EDGES)
def test_grid_equals_plain_version_at_block_edges(cuda, name):
    """The grid kernel (the count kernel's row blocks, a byte a cell) equals
    its plain version bit for bit at ragged (R, C): candidate lists of one
    block pass, one more, three and a tail; one row; every row dead; a
    single inert constraint; 16 columns.  One launch a call."""
    args = edge_level(name, cuda)
    before = ops.embed_join.launches
    grid = ops.embed_join(*args)
    assert ops.embed_join.launches == before + 1
    want = ref.embed_join_grid_ref(*args)
    assert grid.dtype == torch.bool and grid.shape == want.shape
    torch.testing.assert_close(grid, want, rtol=0, atol=0)
    if name == "all_rows_invalid":
        assert not bool(grid.any())


def test_emit_drops_slots_past_a_short_buffer(cuda):
    """An idx_map shorter than the total keeps the first survivors in slot
    order; no slot at or past its end is written."""
    args = random_level(1013, 5, 2100, 2200, 2, seed=11, device=cuda)
    want = ref.embed_join_count_ref(*args)
    row_off = want.cumsum(0) - want
    cap = int(want.sum()) // 3
    got = emit_guarded(args, row_off, 0, cap)
    plain = torch.full_like(got, -7)
    ref.embed_join_emit_ref(plain[:cap], *args, row_off, 0)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert bool((got[cap:] == -7).all())


def test_emit_cell_ids_past_int32(cuda):
    """A row_base that puts the cell ids past 2^31 (the reference's int32
    ids wrap there, C1): the kernel's int64 ids equal the plain version's."""
    args = random_level(700, 4, 1024, 1100, 2, seed=12, device=cuda)
    want = ref.embed_join_count_ref(*args)
    row_off = want.cumsum(0) - want
    total = int(want.sum())
    row_base = (1 << 31) // 1024 + 3
    got = emit_guarded(args, row_off, row_base, total)
    plain = torch.full_like(got, -7)
    ref.embed_join_emit_ref(plain[:total], *args, row_off, row_base)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert int(got[:total].min()) >= 1 << 31


@pytest.mark.parametrize("shape", [(4096, 2, 1024, 1100, 1), (40, 3, 3 * PASS + 77,
                                                              3 * PASS + 177, 2)])
def test_count_and_emit_are_deterministic(cuda, shape):
    """A second call equals the first bit for bit (no atomics)."""
    args = random_level(*shape, seed=sum(shape) + 1, device=cuda)
    first = ops.embed_join_count(*args)
    second = ops.embed_join_count(*args)
    assert torch.equal(first, second)
    row_off = first.cumsum(0) - first
    total = int(first.sum())
    a = emit_guarded(args, row_off, 1, total)
    b = emit_guarded(args, row_off, 1, total)
    assert torch.equal(a, b)


# the level loop's launches: a HUMAN level (N about 1,120 after the filter,
# a hundred-odd candidates, one or two matched neighbours), one past a
# 4,096-row slice, and a candidate list the emit takes in two windows
LIVE_SHAPES = [(2048, 8, 96, 1120, 1), (6000, 12, 130, 1120, 2),
               (40, 3, 3 * PASS + 77, 3 * PASS + 177, 2)]


@pytest.mark.parametrize("shape", LIVE_SHAPES)
def test_live_count_and_table_emit_equal_plain_versions(cuda, shape):
    """The null-mask count and the next-table emit, over row slices as the
    level loop launches them, against their plain versions."""
    r, t, c, n, _ = shape
    table, _, cand, _, elab, q_pos, q_lab, _ = random_level(
        *shape, seed=sum(shape) + 3, device=cuda)
    cand = cand[: min(c, n)].contiguous()  # an exact list: every one live
    live = (table, torch.ones(r, dtype=torch.bool, device=cuda), cand,
            torch.ones(cand.shape[0], dtype=torch.bool, device=cuda), elab,
            q_pos, q_lab, torch.ones(q_pos.shape[0], dtype=torch.bool,
                                     device=cuda))
    slices = [(lo, min(lo + 4096, r)) for lo in range(0, r, 4096)]
    before = ops.launch_counts()
    counts = torch.empty(r, dtype=torch.int32, device=cuda)
    for lo, hi in slices:
        ops.count_live(counts[lo:hi], table[lo:hi], cand, elab, q_pos, q_lab)
    assert torch.equal(counts, ref.embed_join_count_ref(*live))
    scan = torch.zeros(r + 1, dtype=torch.int64, device=cuda)
    torch.cumsum(counts, 0, dtype=torch.int64, out=scan[1:])
    total = int(scan[-1])
    assert total > 0
    out = torch.full((total + 9, t + 1), -7, dtype=torch.int32, device=cuda)
    for lo, hi in slices:  # into the first ``total`` rows: the rest stay -7
        ops.emit_table_live(out[:total], table[lo:hi], cand, elab, q_pos,
                            q_lab, scan[lo:hi])
    want = ref.embed_join_emit_table_ref(
        torch.full_like(out, -7), *live, scan[:r])
    assert torch.equal(out, want)
    after = ops.launch_counts()
    assert after["embed_join_count"] - before["embed_join_count"] == len(slices)
    assert (after["embed_join_emit_table"] - before["embed_join_emit_table"]
            == len(slices))


def test_matrix_fill_on_card_equals_host_build(cuda):
    """The (N, N) edge-label matrix filled on the card from an edge list
    with repeated (src, dst) pairs holds what the host build leaves: the
    last label of each pair."""
    from repro_torch.core.search import _dense_edge_labels, _edge_label_matrix
    from repro_torch.graphs.csr import Graph

    rng = np.random.default_rng(7)
    n, e = 1120, 12000
    src = rng.integers(0, n, size=e).astype(np.int32)
    dst = rng.integers(0, n, size=e).astype(np.int32)
    src[e // 2:] = src[: e - e // 2]  # every pair of the first half repeats
    dst[e // 2:] = dst[: e - e // 2]
    elab = rng.integers(0, 4, size=e).astype(np.int32)
    want = _dense_edge_labels(Graph(np.zeros(n, np.int32), src, dst, elab), n)
    got = _edge_label_matrix(*(torch.as_tensor(x, device=cuda)
                               for x in (src, dst, elab)), n)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_device_join_on_card_equals_cpu(cuda):
    g = random_labeled_graph(3000, 12000, 6, n_edge_labels=2, seed=5, device="cpu")
    q = random_walk_query(g, 5, sparse=True, seed=9, device="cpu")
    cand = (to_host(g).vlabels[:, None] == to_host(q).vlabels[None, :])
    want = device_join_search(g, q, cand, device="cpu", max_embeddings=5000)
    got = device_join_search(g, q, cand, device=cuda, max_embeddings=5000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("enumerator", ["device", "host"])
def test_engine_on_card_equals_cpu(cuda, enumerator):
    g = random_labeled_graph(2000, 8000, 8, n_edge_labels=2, seed=42, device="cpu")
    q = random_walk_query(g, 6, sparse=True, seed=7, device="cpu")
    want, s_cpu = SubgraphQueryEngine(g, khop=2, enumerator=enumerator,
                                      device="cpu").query(q)
    got, s_gpu = SubgraphQueryEngine(g, khop=2, enumerator=enumerator).query(q)
    np.testing.assert_array_equal(got, want)
    assert s_gpu.ilgf_iterations == s_cpu.ilgf_iterations
    assert s_gpu.candidate_pairs == s_cpu.candidate_pairs


def random_counts(rng, n_rows, n_labels, d_max, *, hubs=0, over=0):
    """Count rows with row sums <= d_max, a zero row every seventh, ``hubs``
    saturating rows (d_max neighbours of the top label) and ``over`` rows
    whose degree exceeds d_max (as a query row's can)."""
    counts = rng.multinomial(d_max, np.ones(n_labels) / n_labels,
                             size=n_rows).astype(np.int32)
    counts = (counts * rng.random((n_rows, 1))).astype(np.int32)
    counts[::7] = 0
    counts[:hubs] = 0
    counts[:hubs, -1] = d_max
    counts[hubs:hubs + over, -1] = d_max + 5
    return counts


ENCODE_CASES = [  # (rows, labels, d_max, hubs, over)
    (8, 1, 1, 0, 2), (257, 3, 8, 0, 2), (1013, 2, 64, 40, 3),
    (4099, 6, 59, 100, 10), (300, 4, 200, 20, 5), (70001, 16, 70, 500, 7),
]


@pytest.mark.parametrize("case", ENCODE_CASES)
def test_cni_encode_equals_plain_version(cuda, case):
    n, n_labels, d_max, hubs, over = case
    counts = random_counts(np.random.default_rng(n), n, n_labels, d_max,
                           hubs=hubs, over=over)
    max_p = default_max_p(d_max, n_labels)
    x = torch.as_tensor(counts, device=cuda)
    before = enc_ops.cni_encode.launches
    deg, cni, cni_log = enc_ops.cni_encode(x, d_max, max_p)
    assert enc_ops.cni_encode.launches == before + 1
    deg_p, cni_p, log_p = enc_ref.cni_encode_ref(x, d_max, max_p)
    torch.testing.assert_close(deg, deg_p, rtol=0, atol=0)
    torch.testing.assert_close(cni, cni_p, rtol=0, atol=0)
    # float32 logsumexp summed in another order (the kernel in position
    # order, the plain version by torch's reduction): 1e-5 absolute, or two
    # float32 ulps (2^-22 relative) where the digest exceeds 64 and one ulp
    # is already 7.6e-6 or more (long rows at d_max 70-200 reach 130+)
    torch.testing.assert_close(cni_log, log_p, rtol=2.0**-22, atol=1e-5)
    if hubs:
        assert bool((cni[:hubs] == 1 << 62).all())  # the saturated corner is hit
    assert bool(torch.isneginf(cni_log[deg == 0]).all())


def test_cni_encode_batched_shape(cuda):
    counts = random_counts(np.random.default_rng(3), 3 * 500, 4, 30)
    x = torch.as_tensor(counts.reshape(3, 500, 4), device=cuda)
    deg, cni, cni_log = enc_ops.cni_encode(x, 30, default_max_p(30, 4))
    assert deg.shape == cni.shape == cni_log.shape == (3, 500)
    _, cni_flat, _ = enc_ops.cni_encode(x.reshape(-1, 4), 30, default_max_p(30, 4))
    torch.testing.assert_close(cni.reshape(-1), cni_flat, rtol=0, atol=0)


def random_digests(rng, lead, n, n_labels, mode):
    """Digests with shared values across sides (equal-digest cells),
    saturated entries and, in log mode, values one float32 step either side
    of the eps boundary of a query value."""
    ords = rng.integers(0, n_labels + 1, size=lead + (n,)).astype(np.int32)
    deg = rng.integers(0, 6, size=lead + (n,)).astype(np.int32)
    if mode == "exact":
        cni = rng.integers(0, 50, size=lead + (n,)).astype(np.int64)
        cni[rng.random(cni.shape) < 0.1] = 1 << 62
    else:
        cni = (rng.integers(0, 40, size=lead + (n,)) / 4.0).astype(np.float32)
        cni[rng.random(cni.shape) < 0.05] = np.float32(LOG_SAT64)
        cni[rng.random(cni.shape) < 0.05] = -np.inf
    return ords, deg, cni


def boundary_cells(data, query):
    """In place: data rows 0-7 carry query vertex 0's label and log values
    one float32 step either side of cu - tol and cu + tol (tol = 1e-4 *
    max(1, |cu|)), at equal degree (rows 0-3) and at a larger one (4-7)."""
    od, dd, cd = data
    oq, dq, cq = query
    oq[..., 0] = np.maximum(oq[..., 0], 1)
    cq[..., 0] = np.where(np.isfinite(cq[..., 0]), cq[..., 0], 2.5)
    cu = cq[..., 0]
    tol = np.float32(1e-4) * np.maximum(np.float32(1), np.abs(cu))
    lo, hi = cu - tol, cu + tol
    vals = [np.nextafter(lo, -np.inf), lo, hi, np.nextafter(hi, np.inf)]
    for k in range(8):
        od[..., k] = oq[..., 0]
        dd[..., k] = dq[..., 0] + (k >= 4)
        cd[..., k] = vals[k % 4]


@pytest.mark.parametrize("mode", ["exact", "log"])
@pytest.mark.parametrize("lead,v,u", [
    ((), 1000, 7), ((), 33, 1), ((4,), 2051, 16),
    # V not a multiple of a chunk's 256 rows, B 4, ragged output spans
    ((4,), 1000, 1), ((4,), 777, 3), ((4,), 3001, 16), ((4,), 1283, 33),
    ((), 70_001, 10),
])
def test_candidate_filter_equals_plain_version(cuda, mode, lead, v, u):
    rng = np.random.default_rng(v + u)
    data = random_digests(rng, lead, v, 3, mode)
    query = random_digests(rng, lead, u, 3, mode)
    if mode == "log":
        boundary_cells(data, query)
    args = [torch.as_tensor(a, device=cuda) for a in (*data, *query)]
    before = cf_ops.candidate_filter.launches
    got = cf_ops.candidate_filter(*args, mode=mode)
    assert cf_ops.candidate_filter.launches == before + 1
    want = cf_ref.candidate_filter_ref(*args, mode=mode)
    assert got.shape == lead + (v, u)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["cni", "cni_log"])
def test_batch_engine_on_card_equals_cpu(cuda, variant):
    g = random_labeled_graph(2000, 8000, 8, n_edge_labels=2, seed=42, device="cpu")
    queries = [random_walk_query(g, 5 + i % 4, sparse=bool(i % 2), seed=70 + i,
                                 device="cpu") for i in range(6)]
    want = BatchQueryEngine(g, filter_variant=variant, device="cpu").query_batch(queries)
    enc0, cf0 = enc_ops.cni_encode.launches, cf_ops.candidate_filter.launches
    got = BatchQueryEngine(g, filter_variant=variant,
                           enumerator="device").query_batch(queries)
    assert enc_ops.cni_encode.launches > enc0
    assert cf_ops.candidate_filter.launches > cf0
    for (e_gpu, s_gpu), (e_cpu, s_cpu) in zip(got, want):
        np.testing.assert_array_equal(e_gpu, e_cpu)
        assert s_gpu.ilgf_iterations == s_cpu.ilgf_iterations
        assert s_gpu.candidate_pairs == s_cpu.candidate_pairs


# cni_update at its launch plan's edges, after the encode cases: L 8 (a
# row to 8 lanes, 4 rows a warp) and 16; d_max 128-300 (positions taken 64
# at a time, the sum in a second pass); one label spanning windows; F not a
# multiple of the rows a tile (10 at L 200) or a block; a row filling a
# warp's 2048-int shared-memory tile alone; rows longer than a tile (a warp
# a row, not staged), one and several windows
UPDATE_CASES = ENCODE_CASES + [
    (4099, 8, 64, 100, 10), (5003, 16, 256, 30, 7), (2053, 44, 128, 50, 9),
    (3001, 1, 128, 10, 5), (100003, 200, 64, 2000, 50), (97, 1500, 64, 5, 3),
    (89, 2100, 64, 5, 3), (61, 3000, 300, 4, 3),
]


@pytest.mark.parametrize("real", [False, True], ids=["zero_delta", "real_delta"])
@pytest.mark.parametrize("case", UPDATE_CASES)
def test_cni_update_equals_plain_version_and_encode(cuda, case, real):
    n, n_labels, d_max, hubs, over = case
    rng = np.random.default_rng(n + 1)
    rows = random_counts(rng, n, n_labels, d_max, hubs=hubs, over=over)
    delta = np.zeros_like(rows)
    if real:  # gains and losses, every seventh row emptied; hubs kept
        delta = np.maximum(rng.integers(-2, 3, size=rows.shape), -rows)
        delta[hubs::7] = -rows[hubs::7]
        delta[:hubs] = np.abs(delta[:hubs])
    max_p = default_max_p(d_max, n_labels)
    x = torch.as_tensor(rows, device=cuda)
    dx = torch.as_tensor(delta.astype(np.int32), device=cuda)
    before = upd_ops.cni_update.launches
    new_rows, deg, cni, cni_log = upd_ops.cni_update(x, dx, d_max, max_p)
    assert upd_ops.cni_update.launches == before + 1
    rows_p, deg_p, cni_p, log_p = upd_ref.cni_update_ref(x, dx, d_max, max_p)
    torch.testing.assert_close(new_rows, rows_p, rtol=0, atol=0)
    torch.testing.assert_close(deg, deg_p, rtol=0, atol=0)
    torch.testing.assert_close(cni, cni_p, rtol=0, atol=0)
    # the plain version sums the logsumexp in another order: as for
    # cni_encode above, 1e-5 absolute or two float32 ulps
    torch.testing.assert_close(cni_log, log_p, rtol=2.0**-22, atol=1e-5)
    # the shared row walk: the new rows encode to the same bits
    for got, want in zip((deg, cni, cni_log),
                         enc_ops.cni_encode(new_rows, d_max, max_p)):
        assert torch.equal(got, want)
    if hubs:
        assert bool((cni[:hubs] == 1 << 62).all())


def test_incremental_index_on_card_equals_scratch_and_cpu(cuda):
    g = random_labeled_graph(3000, 15000, 6, n_edge_labels=2, seed=11,
                             device="cpu")
    batches = random_update_batches(g, 4, 600, delete_frac=0.35, seed=12)
    stores = {}
    for dev in ("cpu", "cuda"):
        store = GraphStore.from_graph(g, device=dev)
        store.attach_index(IncrementalIndex())
        before = upd_ops.cni_update.launches
        for b in batches:
            store.apply(b)
        assert upd_ops.cni_update.launches - before == (4 if dev == "cuda" else 0)
        stores[dev] = store
    idx = stores["cuda"].index
    assert idx.device == stores["cuda"].device
    assert idx.counts.device.type == "cuda"
    fresh = IncrementalIndex(d_max=idx.d_max)
    fresh.rebuild(stores["cuda"])
    for name in ("counts", "deg", "cni", "cni_log"):
        assert torch.equal(getattr(idx, name), getattr(fresh, name)), name
    cpu = stores["cpu"].index
    for name in ("counts", "deg", "cni"):
        assert torch.equal(getattr(idx, name).cpu(), getattr(cpu, name)), name
    torch.testing.assert_close(idx.cni_log.cpu(), cpu.cni_log, rtol=2.0**-22,
                               atol=1e-5)
    assert idx.stats == cpu.stats


@pytest.mark.parametrize("variant", ["cni", "cni_log"])
def test_store_engines_on_card_equal_cpu(cuda, variant):
    g = random_labeled_graph(2000, 8000, 8, n_edge_labels=2, seed=42,
                             device="cpu")
    batches = random_update_batches(g, 2, 400, delete_frac=0.35, seed=3)
    stores = []
    for dev in ("cpu", "cuda"):
        store = GraphStore.from_graph(g, device=dev)
        store.attach_index(IncrementalIndex())
        for b in batches:
            store.apply(b)
        stores.append(store)
    snap = stores[0].snapshot().graph
    queries = [random_walk_query(snap, 5 + i % 3, sparse=True, seed=50 + i,
                                 device="cpu") for i in range(4)]
    out = []
    for store, dev in zip(stores, ("cpu", None)):
        eng = SubgraphQueryEngine(store, filter_variant=variant,
                                  enumerator="device",
                                  planner=QueryPlanner.for_data(store),
                                  device=dev)
        out.append(([eng.query(q) for q in queries],
                    BatchQueryEngine(store, filter_variant=variant,
                                     enumerator="device",
                                     device=dev).query_batch(queries)))
    (seq_c, bat_c), (seq_g, bat_g) = out
    for (e_c, s_c), (e_g, s_g), (b_c, _), (b_g, _) in zip(seq_c, seq_g, bat_c,
                                                          bat_g):
        np.testing.assert_array_equal(e_g, e_c)
        np.testing.assert_array_equal(b_g, b_c)
        assert s_g.extras["store_prefilter_alive"] == \
            s_c.extras["store_prefilter_alive"]
        assert s_g.extras["plan"]["order"] == s_c.extras["plan"]["order"]


# ---------------------------------------------------------------------------
# the LM serving path: flash_attention, wkv6, decode_step, ServeEngine
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (b, hq, hkv, sq, skv, d, causal, window, q_offset, kv_len)
    (2, 4, 2, 128, 128, 32, True, None, 0, None),   # the CPU tests' cases
    (1, 8, 8, 96, 96, 16, True, None, 0, None),
    (1, 4, 1, 64, 64, 64, True, 32, 0, None),
    (2, 2, 2, 80, 80, 32, False, None, 0, None),
    (2, 4, 2, 1, 100, 32, True, None, 99, 100),     # decode offset
    (8, 32, 8, 1, 512, 64, True, None, 200, 201),   # granite decode
    (1, 32, 8, 300, 300, 64, True, None, 0, None),  # ragged prefill
    (1, 4, 2, 33, 200, 128, True, 50, 100, 133),    # chunked prefill, window
    (1, 32, 8, 1000, 1000, 64, True, None, 0, None),  # prefill, ragged tiles
    (1, 32, 8, 2048, 2048, 64, True, None, 0, None),  # prefill at full length
    (8, 32, 8, 1, 512, 64, True, 40, 300, 301),     # windowed decode
    (2, 8, 2, 5, 512, 64, True, None, 200, 205),    # decode, Sq 5
    (2, 4, 2, 1, 100, 48, True, None, 60, 61),      # D 48: padded columns
    (1, 4, 2, 40, 40, 80, True, None, 0, None),     # D 80 prefill: padded
]
# the hybrid, encdec and vlm families' shapes: a group of 5 (hymba's 25/5
# heads, R 8 with 3 idle rows) decoding with the 1,024 window past position
# 1,024 and its windowed prefill; a group of 6 at D 128 (internvl2's 48/8,
# R 4: the second row group half idle); non-causal calls with Sq != Skv
# both ways, Sq 1 against F frames among them (seamless's encoder and
# cross-attention)
FAMILY_FLASH_CASES = [
    (8, 25, 5, 1, 1152, 64, True, 1024, 1099, 1100),  # hymba decode
    (8, 25, 5, 1, 1152, 64, True, 1024, 1024, 1025),  # ... one key out
    (2, 25, 5, 1100, 1100, 64, True, 1024, 0, None),  # ... windowed prefill
    (4, 25, 5, 512, 512, 64, True, 1024, 0, None),    # ... training prefill
    (8, 48, 8, 1, 512, 128, True, None, 93, 94),      # internvl decode
    (8, 48, 8, 1, 512, 128, True, None, 511, 512),    # ... full cache
    (2, 48, 8, 768, 768, 128, True, None, 0, None),   # ... prefill + patches
    (4, 16, 16, 128, 128, 64, False, None, 0, None),  # seamless encoder
    (4, 16, 16, 512, 128, 64, False, None, 0, None),  # cross prefill
    (8, 16, 16, 1, 128, 64, False, None, 0, None),    # cross decode
    (2, 16, 16, 40, 200, 64, False, None, 0, None),   # Sq < Skv, ragged
    (2, 16, 16, 100, 33, 64, False, None, 0, None),   # Sq > Skv, ragged
    (3, 16, 16, 1, 77, 64, False, None, 0, None),     # Sq 1, ragged F
]
FLASH_CASES += FAMILY_FLASH_CASES
# the decode sweep: kv_len across tile and cluster edges, GQA groups 1, 4, 8
FLASH_CASES += [(4, 8 * g, 8, 1, 512, d, True, None, n - 1, n)
                for n in (1, 31, 32, 33, 94, 129, 512) for g in (1, 4, 8)
                for d in (64, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_equals_plain_version(cuda, case, dtype):
    b, hq, hkv, sq, skv, d, causal, window, q_offset, kv_len = case
    gen = torch.Generator(cuda).manual_seed(sum(case[:6]))
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    want = fa_ref.mha_plain(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [
    (8, 32, 8, 1, 512, 64, True, None, 0, 0),       # decode, kv_len 0
    (2, 8, 2, 5, 512, 64, True, None, 200, 0),      # decode, Sq 5
    (1, 32, 8, 300, 300, 64, True, None, 0, 0),     # prefill, kv_len 0
    (1, 4, 2, 64, 128, 128, True, None, -40, None),  # prefill, rows before
])                                                   # every key
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_row_that_sees_no_key_is_zero(cuda, case, dtype):
    """ROADMAP C12: both kernels give 0 on a row that sees no key, as the
    plain version does, and the plain version's value on every other row."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset, kv_len = case
    gen = torch.Generator(cuda).manual_seed(sq + skv)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    got = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    want = fa_ref.mha_plain(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)
    seen = fa_ref.visible_mask(sq, skv, causal=causal, window=window,
                               q_offset=q_offset, kv_len=kv_len,
                               device=cuda).any(-1)
    assert not seen.all()
    assert torch.equal(got[:, :, ~seen], torch.zeros_like(got[:, :, ~seen]))
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [
    (8, 32, 8, 1, 512, 64, True, None, 93, 94),     # granite decode
    (8, 32, 8, 1, 512, 64, True, None, 511, 512),   # full cache: a cluster
    (1, 32, 8, 2048, 2048, 64, True, None, 0, None),  # prefill
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_deterministic(cuda, case, dtype):
    """Two calls on the same inputs are equal bit for bit: every sum runs
    in a fixed order, with no atomics."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset, kv_len = case
    gen = torch.Generator(cuda).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    first = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    second = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    assert torch.equal(first, second)


@pytest.mark.parametrize("case", FAMILY_FLASH_CASES)
def test_flash_attention_at_family_shapes(cuda, case):
    """The hybrid, encdec and vlm shapes in float32: within 2e-5 of the
    plain version, and a second call equal bit for bit."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset, kv_len = case
    gen = torch.Generator(cuda).manual_seed(sq + skv + hq)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    got = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    again = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    assert torch.equal(got, again)
    want = fa_ref.mha_plain(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", [
    (8, 32, 4, 1, 512, 128, True, None, 93, 94),     # qwen3-moe decode
    (8, 32, 4, 1, 512, 128, True, None, 511, 512),   # ... full cache
    (4, 32, 4, 512, 512, 128, True, None, 0, None),  # ... training prefill
])
def test_flash_attention_at_qwen3_moe_shapes(cuda, case):
    """D 128 with 8 query heads a KV head, float32."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset, kv_len = case
    gen = torch.Generator(cuda).manual_seed(sq + skv)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    got = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    want = fa_ref.mha_plain(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,sq,q_offset,kv_len", [
    (8, 1, 93, 94), (8, 1, 511, 512), (4, 512, 0, None)])
def test_flash_attention_in_the_mla_layout(cuda, b, sq, q_offset, kv_len):
    """minicpm3-4b's naive MLA call: 40 heads, QK width 96 (nope 64 + the
    rope key 32 broadcast over the heads), V 64 padded to 96; the wrapper
    pads 96 to the kernel's 128, float32."""
    gen = torch.Generator(cuda).manual_seed(sq)
    skv = 512 if kv_len is not None else sq
    q = torch.randn((b, 40, sq, 96), generator=gen, device=cuda)
    k_nope = torch.randn((b, 40, skv, 64), generator=gen, device=cuda)
    k_rope = torch.randn((b, 1, skv, 32), generator=gen, device=cuda)
    k = torch.cat([k_nope, k_rope.expand(b, 40, skv, 32)], dim=-1)
    v = torch.nn.functional.pad(
        torch.randn((b, 40, skv, 64), generator=gen, device=cuda), (0, 32))
    got = fa_ops.flash_attention(q, k, v, True, None, q_offset, kv_len)
    want = fa_ref.mha_plain(q, k, v, q_offset=q_offset, kv_len=kv_len)
    assert got.shape == q.shape
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert bool((got[..., 64:] == 0).all())  # V's zero columns stay zero


# MLA's widths read in place: (b, h, hkv, sq, skv, d, dv, causal, window,
# q_offset, kv_len); ragged S and kv_len, hq = hkv as MLA's and GQA groups
# (R 4 and 8 in the decode kernel)
MLA_WIDTH_CASES = [
    (2, 4, 4, 100, 100, 96, 64, True, None, 0, None),      # ragged prefill
    (1, 8, 8, 1000, 1000, 96, 64, True, None, 0, None),
    (2, 4, 4, 100, 100, 192, 128, True, None, 0, None),
    (1, 8, 8, 1000, 1000, 192, 128, True, None, 0, None),
    (2, 4, 2, 77, 77, 192, 128, False, None, 0, None),     # non-causal, GQA
    (1, 4, 4, 64, 64, 192, 128, True, 40, 0, None),        # window
    (1, 4, 4, 33, 300, 192, 128, True, None, 200, 233),    # offset chunk
]
MLA_WIDTH_CASES += [(8, 8 * g, 8, 1, 512, d, dv, True, None, n - 1, n)
                    for n in (1, 31, 94, 129, 512) for g in (1, 4, 8)
                    for d, dv in ((96, 64), (192, 128))]
MLA_WIDTH_CASES += [(2, 4, 4, 5, 300, 192, 128, True, None, 200, 205),
                    (2, 4, 4, 40, 40, 24, 16, True, None, 0, None),  # padded
                    (2, 4, 4, 1, 64, 24, 16, True, None, 30, 31)]


def mla_width_inputs(case, dtype, cuda):
    """q, k (D wide) and v (Dv wide) as the naive MLA layer makes them: k a
    concatenation of a per-head part and a rope part broadcast over the
    heads, v a permuted view (an einsum's (B, S, H, Dv) output)."""
    b, hq, hkv, sq, skv, d, dv = case[:7]
    gen = torch.Generator(cuda).manual_seed(sum(case[:7]))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(dtype)

    rope = d // 3
    q = randn(b, hq, sq, d)
    k = torch.cat([randn(b, hkv, skv, d - rope),
                   randn(b, 1, skv, rope).expand(b, hkv, skv, rope)], dim=-1)
    v = randn(b, skv, hkv, dv).permute(0, 2, 1, 3)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_WIDTH_CASES)
def test_flash_attention_at_mla_widths(cuda, case, dtype, monkeypatch):
    """QK 96 / V 64 (minicpm3-4b) and QK 192 / V 128 (deepseek-v3) against
    the plain version, the output Dv wide; at a built pair the wrapper
    copies nothing (q, k and the permuted v are read where they lie), and
    the reduced MLA's 24 / 16 runs padded to 32 / 32."""
    b, hq, hkv, sq, skv, d, dv, causal, window, q_offset, kv_len = case
    q, k, v = mla_width_inputs(case, dtype, cuda)
    seen = []
    aligned = fa_ops._aligned
    monkeypatch.setattr(fa_ops, "_aligned", lambda x, w: seen.append(
        (x, aligned(x, w))) or seen[-1][1])
    before = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    built = (d, dv) in fa_ops.KERNEL_WIDTHS
    assert all((x is y) == built for x, y in seen) and len(seen) == 3
    want = fa_ref.mha_plain(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_len=kv_len)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got.shape == (b, hq, sq, dv) and got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again = fa_ops.flash_attention(q, k, v, causal, window, q_offset, kv_len)
    assert torch.equal(got, again)


def test_flash_attention_refuses_widths_past_the_built_pairs(cuda):
    q = torch.zeros((1, 2, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="past every width"):
        fa_ops.flash_attention(q, q, q, True, None, 0, 1)
    v = torch.zeros((1, 2, 1, 192), device=cuda)
    with pytest.raises(ValueError, match="past every width"):
        fa_ops.flash_attention(v, v, v, True, None, 0, 1)


@pytest.mark.parametrize("d,dv", [(96, 64), (192, 128)])
def test_flash_attention_function_grads_at_mla_widths(cuda, d, dv):
    """The autograd Function at MLA's widths: dv comes back Dv wide, and
    the grads are the plain version's VJP."""
    case = (2, 4, 4, 70, 70, d, dv)
    q, k, v = mla_width_inputs(case, torch.float32, cuda)
    gen = torch.Generator(cuda).manual_seed(d)
    cot = torch.randn((2, 4, 70, dv), generator=gen, device=cuda)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(*leaves, True, None)
    assert fa_ops.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, cot)
    plain = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    want_out = fa_ref.mha_plain(*plain)
    want = torch.autograd.grad(want_out, plain, cot)
    torch.testing.assert_close(out, want_out, rtol=2e-5, atol=2e-5)
    assert got[2].shape == v.shape
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


WKV_CASES = [  # (b, h, t, dk, dv)
    (2, 3, 70, 16, 16), (1, 2, 64, 32, 16), (1, 1, 128, 64, 64),
    (8, 64, 1, 64, 64), (1, 4, 1000, 64, 64), (2, 2, 17, 128, 128),
    (2, 3, 45, 128, 64), (1, 2, 9, 100, 48),
]


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_equals_plain_version(cuda, case):
    b, h, t, dk, dv = case
    gen = torch.Generator(cuda).manual_seed(sum(case))

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    r, k, v = randn(b, h, t, dk), randn(b, h, t, dk), randn(b, h, t, dv)
    w = torch.rand((b, h, t, dk), generator=gen, device=cuda) * 0.79 + 0.2
    u, s0 = randn(h, dk), randn(b, h, dk, dv)
    before = wkv_ops.wkv6.launches
    o, s = wkv_ops.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == before + 1
    o_p, s_p = wkv_ref.wkv6_plain(r, k, v, w, u, s0)
    # the kernel follows the plain version's float32 evaluation order
    torch.testing.assert_close(o, o_p, rtol=0, atol=0)
    torch.testing.assert_close(s, s_p, rtol=0, atol=0)
    # split-T equals full-T
    half = t // 2
    if half:
        o1, s1 = wkv_ops.wkv6(r[:, :, :half], k[:, :, :half], v[:, :, :half],
                              w[:, :, :half], u, s0)
        o2, s2 = wkv_ops.wkv6(r[:, :, half:], k[:, :, half:], v[:, :, half:],
                              w[:, :, half:], u, s1)
        torch.testing.assert_close(torch.cat([o1, o2], 2), o, rtol=0, atol=0)
        torch.testing.assert_close(s2, s, rtol=0, atol=0)
    # bfloat16 inputs: the same arithmetic on the widened values
    rb, kb, vb, wb = (x.bfloat16() for x in (r, k, v, w))
    ob, sb = wkv_ops.wkv6(rb, kb, vb, wb, u, s0)
    ob_p, sb_p = wkv_ref.wkv6_plain(rb, kb, vb, wb, u, s0)
    assert ob.dtype == torch.bfloat16
    torch.testing.assert_close(ob, ob_p, rtol=0, atol=0)
    torch.testing.assert_close(sb, sb_p, rtol=0, atol=0)


WKV_BWD_CASES = [  # (b, h, t, dk, dv)
    (2, 3, 70, 16, 16), (1, 2, 64, 32, 16), (2, 2, 17, 128, 128),
    (4, 8, 33, 64, 64), (1, 2, 21, 24, 40), (3, 2, 1, 64, 64),
    (1, 1, 9, 100, 72),
]


def leaf_err(got, want):
    """Largest difference over the leaf's largest value."""
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("case", WKV_BWD_CASES)
def test_wkv6_backward_equals_plain_backward(cuda, case, with_state):
    """The backward kernel against ``ref.wkv6_backward_plain`` and the
    autograd VJP of ``wkv6_plain`` on the card: each leaf within 1e-5 of its
    largest value (float32 sums in another order), one launch a call, and
    a second call equal bit for bit; bfloat16 inputs within 1e-2 (each grad
    rounded to bfloat16 once); a None cotangent on either output."""
    b, h, t, dk, dv = case
    gen = torch.Generator(cuda).manual_seed(sum(case) + with_state)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    inputs = [randn(b, h, t, dk), randn(b, h, t, dk), randn(b, h, t, dv),
              torch.exp(-torch.exp(randn(b, h, t, dk) * 0.5 - 1.0)),
              randn(h, dk), randn(b, h, dk, dv) if with_state else None]
    g_o, g_s = randn(b, h, t, dv), randn(b, h, dk, dv)
    before = wkv_ops.wkv6_backward.launches
    got = wkv_ops.wkv6_backward(*inputs, g_o, g_s)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6_backward.launches == before + 1
    again = wkv_ops.wkv6_backward(*inputs, g_o, g_s)
    want = wkv_ref.wkv6_backward_plain(*inputs, g_o, g_s)
    leaves = [x.clone().requires_grad_(True) for x in inputs if x is not None]
    o_p, s_p = wkv_ref.wkv6_plain(*leaves[:5], leaves[5] if with_state else None)
    want_ag = torch.autograd.grad((o_p, s_p), leaves, (g_o, g_s))
    assert (got[5] is None) == (not with_state)
    for i, (gg, aa, ww) in enumerate(zip(got, again, want)):
        if ww is None:
            continue
        assert gg.dtype == ww.dtype and gg.shape == ww.shape
        assert torch.equal(gg, aa), i
        assert leaf_err(gg, ww) <= 1e-5, (i, leaf_err(gg, ww))
        assert leaf_err(gg, want_ag[i]) <= 1e-5, (i, leaf_err(gg, want_ag[i]))
    for g_o_, g_s_ in ((None, g_s), (g_o, None), (None, None)):
        got = wkv_ops.wkv6_backward(*inputs, g_o_, g_s_)
        want = wkv_ref.wkv6_backward_plain(*inputs, g_o_, g_s_)
        for gg, ww in zip(got, want):
            if ww is not None:
                assert float((gg - ww).abs().max()) <= 1e-5 * max(
                    float(ww.abs().max()), 1e-30)
    low = [x.bfloat16() for x in inputs[:4]] + inputs[4:]
    got = wkv_ops.wkv6_backward(*low, g_o.bfloat16(), g_s)
    want = wkv_ref.wkv6_backward_plain(*low, g_o.bfloat16(), g_s)
    for gg, ww in zip(got, want):
        if ww is not None:
            assert gg.dtype == ww.dtype
            assert leaf_err(gg, ww) <= 1e-2


def lm_pair(arch, cuda):
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg_auto = dataclasses.replace(get_config(arch).reduced(), attn_impl="auto")
    params = M.init_params(cfg_auto, torch.Generator().manual_seed(0), "cpu")
    return cfg_auto, params, copy.deepcopy(params).to(cuda)


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b"])
def test_decode_step_on_card_equals_cpu(cuda, arch):
    from repro_torch.models import model as M

    cfg, p_cpu, p_gpu = lm_pair(arch, cuda)
    name = "flash_attention" if arch.startswith("granite") else "wkv6"
    kernel = fa_ops.flash_attention if name == "flash_attention" else wkv_ops.wkv6
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(3, 6))
    caches = [M.init_cache(cfg, 3, 16, device="cpu"),
              M.init_cache(cfg, 3, 16, device=cuda)]
    before = kernel.launches
    for t in range(6):
        want, caches[0] = M.decode_step(p_cpu, cfg, caches[0], toks[:, t:t + 1], t)
        got, caches[1] = M.decode_step(p_gpu, cfg, caches[1], toks[:, t:t + 1], t)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert kernel.launches - before == 6 * cfg.n_layers
    full, _ = M.forward(p_gpu, cfg, torch.as_tensor(toks, device=cuda))
    want_full, _ = M.forward(p_cpu, cfg, torch.as_tensor(toks))
    torch.testing.assert_close(full.cpu(), want_full, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b"])
def test_serve_engine_on_card_equals_cpu(cuda, arch):
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg, p_cpu, p_gpu = lm_pair(arch, cuda)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab, size=int(rng.integers(2, 10))),
             int(rng.integers(4, 12))) for _ in range(8)]
    out = []
    for params in (p_cpu, p_gpu):
        eng = ServeEngine(params, cfg, ServeConfig(max_batch=4, max_len=96,
                                                   eos_token=-1))
        assert eng.device == params.device
        for prompt, max_new in reqs:
            eng.submit(prompt, max_new)
        out.append(eng.run_to_completion())
    assert out[1] == out[0]


@pytest.mark.parametrize("arch,absorb", [("qwen3-moe-30b-a3b", False),
                                         ("minicpm3-4b", True),
                                         ("minicpm3-4b", False),
                                         ("deepseek-v3-671b", True),
                                         ("deepseek-v3-671b", False)])
def test_families_on_card_equal_cpu(cuda, arch, absorb):
    """Reduced qwen3-moe, minicpm3 and deepseek-v3 (absorbed and naive
    decode): forward and 6 decode steps on the card against the CPU run of
    the same params, 1e-4; one flash_attention launch a layer and step (both
    of deepseek's stacks), none in the absorbed decode, and one more in a
    forward with an MTP head."""
    import dataclasses

    from repro_torch.models import model as M

    cfg, p_cpu, p_gpu = lm_pair(arch, cuda)
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla_absorb=absorb)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(3, 6))
    caches = [M.init_cache(cfg, 3, 16, device="cpu"),
              M.init_cache(cfg, 3, 16, device=cuda)]
    before = fa_ops.flash_attention.launches
    for t in range(6):
        want, caches[0] = M.decode_step(p_cpu, cfg, caches[0], toks[:, t:t + 1], t)
        got, caches[1] = M.decode_step(p_gpu, cfg, caches[1], toks[:, t:t + 1], t)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert fa_ops.flash_attention.launches - before == (
        0 if absorb else 6 * cfg.n_layers)
    before = fa_ops.flash_attention.launches
    full, aux = M.forward(p_gpu, cfg, torch.as_tensor(toks, device=cuda))
    assert fa_ops.flash_attention.launches - before == cfg.n_layers + cfg.mtp
    want_full, want_aux = M.forward(p_cpu, cfg, torch.as_tensor(toks))
    torch.testing.assert_close(full.cpu(), want_full, rtol=1e-4, atol=1e-4)
    assert float(aux["moe_dropped"]) == float(want_aux["moe_dropped"])
    if cfg.mtp:
        torch.testing.assert_close(aux["mtp_logits"].cpu(),
                                   want_aux["mtp_logits"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "seamless-m4t-large-v2",
                                  "internvl2-26b"])
def test_families2_on_card_equal_plain(cuda, arch):
    """Reduced hymba, seamless and internvl2 on the card: ``forward`` with
    frames or patches, 6 decode steps (after ``prefill_encoder``) and
    ``loss_fn``'s loss and grads on the kernels against the plain version
    on the card and against the CPU run, 1e-4; one flash_attention launch a
    layer and step (two in a decoder_cross layer, and one an encoder layer
    in ``prefill_encoder``)."""
    import dataclasses

    from repro_torch.configs.registry import frontend_len
    from repro_torch.models import model as M

    cfg, p_cpu, p_gpu = lm_pair(arch, cuda)
    plain = dataclasses.replace(cfg, attn_impl="ref")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(3, 6))
    n_front = frontend_len(cfg, 6)
    front = (rng.standard_normal((3, n_front, cfg.d_model)).astype(np.float32)
             if n_front else None)
    per_layer = 2 if cfg.n_encoder_layers else 1
    runs = []
    for params, c in ((p_gpu, cfg), (p_gpu, plain), (p_cpu, cfg)):
        dev = params.device
        before = fa_ops.flash_attention.launches
        full, _ = M.forward(params, c, toks, frontend=front)
        cache = M.init_cache(c, 3, 16, device=dev, enc_memory_len=(
            n_front if cfg.n_encoder_layers else 0))
        if cfg.n_encoder_layers:
            cache = M.prefill_encoder(params, c, front, cache)
        steps = [M.decode_step(params, c, cache, toks[:, t:t + 1], t)[0].cpu()
                 for t in range(6)]
        launches = fa_ops.flash_attention.launches - before
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        if front is not None:
            batch["frontend"] = front
        loss, _ = M.loss_fn(params, c, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
        params.requires_grad_(False)
        runs.append((full.cpu(), torch.stack(steps), loss.detach().cpu(),
                     [g.cpu() for g in grads], launches))
    kern = runs[0]
    n_enc = cfg.n_encoder_layers
    assert kern[4] == 7 * cfg.n_layers * per_layer + 2 * n_enc
    assert runs[1][4] == runs[2][4] == 0
    for other in runs[1:]:
        for a, b in zip(kern[:3], other[:3]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        for a, b in zip(kern[3], other[3]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the graph-query service on the card
# ---------------------------------------------------------------------------


def _service_stream(device, ckpt_dir=None):
    """A small store-backed service on ``device``: waves of queries between
    ticks and two mutations; returns the service, its finished triples and
    the kernels' launch counts over the stream."""
    g = random_labeled_graph(3000, 15000, 6, n_edge_labels=2, seed=11,
                             device="cpu")
    store = GraphStore.from_graph(g, degree_cap=32, device=device)
    store.attach_index(IncrementalIndex())
    svc = GraphQueryService(store, GraphServiceConfig(
        max_slots=4, max_query_vertices=8, max_query_labels=8,
        enumerator="device", plan_queries=True, max_queue_depth=6,
        tenant_quota=5, checkpoint_dir=ckpt_dir, checkpoint_async=False))
    kernels = (ops, enc_ops, cf_ops, upd_ops)
    for m in kernels:
        m.reset_launches()
    done = []
    batches = random_update_batches(g, 2, 200, delete_frac=0.35, seed=12)
    for wave in range(3):
        for i in range(6):
            q = random_walk_query(g, 4 + i % 3, sparse=bool(i % 2),
                                  seed=100 * wave + i, device="cpu")
            try:
                svc.submit(q, tenant=f"t{i % 2}", priority=i % 2)
            except Exception as err:  # noqa: BLE001 — rejections are counted
                assert type(err).__name__ == "AdmissionRejected"
        done += svc.tick()
        if wave < len(batches):
            b = batches[wave]
            edges = np.stack([b.src, b.dst], 1)
            svc.remove_edges(edges[~b.insert & b.valid])
            svc.add_edges(edges[b.insert & b.valid])
    done += svc.run_to_completion()
    launches = {k: v for m in kernels for k, v in m.launch_counts().items()}
    return svc, done, launches


def test_service_on_card_equals_cpu(cuda):
    got_svc, got, launches = _service_stream("cuda")
    want_svc, want, _ = _service_stream("cpu")
    assert [r for r, _, _ in got] == [r for r, _, _ in want]
    for (_, emb, st), (_, w_emb, w_st) in zip(got, want):
        np.testing.assert_array_equal(emb, w_emb)
        assert st.ilgf_iterations == w_st.ilgf_iterations
        assert st.extras["service"]["epoch"] == w_st.extras["service"]["epoch"]
    snap, w_snap = got_svc.metrics_snapshot(), want_svc.metrics_snapshot()
    for name, fam in w_snap.items():
        if fam["type"] != "histogram" and name != "repro_process_peak_rss_bytes":
            assert snap[name]["series"] == fam["series"], name
    assert got_svc.rejections == want_svc.rejections
    for name in ("embed_join_count", "embed_join_emit_table", "cni_encode",
                 "candidate_filter", "cni_update"):
        assert launches[name] > 0, name


def test_restore_on_card_equals_cpu_snapshot(cuda, tmp_path):
    svc, _, _ = _service_stream("cpu", ckpt_dir=str(tmp_path))
    svc.shutdown()
    before = enc_ops.cni_encode.launches
    restored = GraphQueryService.restore(str(tmp_path), device="cuda")
    torch.cuda.synchronize()
    assert enc_ops.cni_encode.launches == before  # warm: no cni_encode
    idx, want = restored.store.index, svc.store.index
    assert idx.counts.device.type == "cuda"
    assert restored.store.epoch == svc.store.epoch
    for name in ("counts", "deg", "cni", "cni_log"):
        assert torch.equal(getattr(idx, name).cpu(), getattr(want, name)), name
    for a, b in zip(restored.store.alive_edges(), svc.store.alive_edges()):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# stream filter, graph-database index and out-of-core store on the card
# ---------------------------------------------------------------------------


def _launches():
    return {k: v for m in (ops, enc_ops, cf_ops, upd_ops)
            for k, v in m.launch_counts().items()}


@pytest.mark.parametrize("sorted_stream", [True, False])
def test_stream_on_card_equals_cpu(cuda, tmp_path, sorted_stream):
    from repro_torch.core import scan_filter, stream_filter_file
    from repro_torch.graphs import max_degree, write_edge_file

    g = random_labeled_graph(2000, 9000, 6, n_edge_labels=2, seed=5,
                             device="cpu")
    q = random_walk_query(g, 6, sparse=True, seed=6, device="cpu")
    path = str(tmp_path / "g.bin")
    write_edge_file(path, g, sorted_by_src=sorted_stream)
    before = _launches()
    runs = [stream_filter_file(path, g.vlabels, q, chunk_edges=512,
                               d_max=max_degree(g), sorted_stream=sorted_stream,
                               device=dev) for dev in ("cuda", "cpu")]
    after = _launches()
    got, want = runs
    assert tuple(got.stats) == tuple(want.stats)
    np.testing.assert_array_equal(got.prefilter_alive, want.prefilter_alive)
    for x, y in zip(got.retained, want.retained):
        assert x.device.type == "cuda"
        assert torch.equal(x.cpu(), y)
    assert torch.equal(got.ilgf_result.alive.cpu(), want.ilgf_result.alive)
    assert torch.equal(got.ilgf_result.candidates.cpu(),
                       want.ilgf_result.candidates)
    for name in ("cni_encode", "candidate_filter"):
        assert after[name] > before[name], name
    np.testing.assert_array_equal(
        scan_filter(g, q, chunk_edges=1000, device="cuda"),
        scan_filter(g, q, chunk_edges=1000, device="cpu"))


def test_graph_index_on_card_equals_cpu(cuda):
    from repro_torch.core import GraphDatabaseIndex

    graphs = [random_labeled_graph(20 + i % 41, int(1.1 * (20 + i % 41)), 20,
                                   seed=1000 + i, device="cpu")
              for i in range(100)]
    before = enc_ops.cni_encode.launches
    got = GraphDatabaseIndex(graphs, device="cuda")
    assert enc_ops.cni_encode.launches == before + 1  # one encode for all
    want = GraphDatabaseIndex(graphs, device="cpu")
    for a, b in zip(got.entries, want.entries):
        assert a.digests.keys() == b.digests.keys()
        for lab in b.digests:
            np.testing.assert_allclose(a.digests[lab], b.digests[lab],
                                       rtol=0, atol=1e-5)
    for s in range(8):
        i = (37 * s) % len(graphs)
        q = random_walk_query(graphs[i], 4 + s % 5, seed=s, device="cpu")
        cands = got.candidates(q)
        assert cands == want.candidates(q) and i in cands
        res, w_res = got.query(q), want.query(q)
        assert set(res) == set(w_res)
        for k in w_res:
            np.testing.assert_array_equal(res[k], w_res[k])


def _ooc_stream(device, root):
    from repro_torch.graphs import OutOfCoreGraphStore

    g = random_labeled_graph(3000, 15000, 8, seed=42, device="cpu")
    store = OutOfCoreGraphStore.from_graph(g, storage_dir=root,
                                           chunk_edges=1024, degree_cap=64,
                                           device=device)
    queries = [random_walk_query(g, 5, seed=60 + i, device="cpu")
               for i in range(4)]
    out = []
    for b in random_update_batches(g, 3, 2048, delete_frac=0.35, seed=1):
        res = store.apply(b)
        out.append(("apply", res.n_inserted, res.n_deleted, res.n_skipped,
                    res.applied.elabels.tolist()))
        for q in queries:
            emb, st = SubgraphQueryEngine(store, enumerator="device",
                                          device=device).query(q)
            out.append(("query", emb.tolist(), st.extras["ooc"]["chunks_read"]))
        for emb, _ in BatchQueryEngine(store, device=device).query_batch(queries):
            out.append(("batch", emb.tolist()))
    out.append(("compact", store.compact()))
    for q in queries:
        out.append(("query", SubgraphQueryEngine(store, device=device).query(
            q)[0].tolist()))
    return store, out


def test_ooc_store_on_card_equals_cpu(cuda, tmp_path):
    before = _launches()
    got_store, got = _ooc_stream("cuda", str(tmp_path / "card"))
    after = _launches()
    want_store, want = _ooc_stream("cpu", str(tmp_path / "host"))
    assert got == want
    idx, cpu = got_store.index, want_store.index
    for name in ("counts", "deg", "cni"):
        assert torch.equal(getattr(idx, name).cpu(), getattr(cpu, name)), name
    torch.testing.assert_close(idx.cni_log.cpu(), cpu.cni_log, rtol=2.0**-22,
                               atol=1e-5)
    fresh = IncrementalIndex(d_max=idx.d_max)
    fresh.rebuild(got_store)  # streamed from the chunks, on the card
    for name in ("counts", "deg", "cni", "cni_log"):
        assert torch.equal(getattr(idx, name), getattr(fresh, name)), name
    for name in ("embed_join_count", "embed_join_emit_table", "cni_encode",
                 "candidate_filter", "cni_update"):
        assert after[name] > before[name], name


# ---------------------------------------------------------------------------
# the multi-device path: logical shards on one card
# ---------------------------------------------------------------------------


def _mesh(device, n=4):
    from repro_torch.core import device_mesh

    return device_mesh(n, devices=[device] * n)


def _sharded_store(device, g, n_shards=4):
    from repro_torch.core import ShardedIncrementalIndex
    from repro_torch.graphs import ShardedGraphStore

    store = ShardedGraphStore.from_graph(g, n_shards=n_shards, degree_cap=64,
                                         device=device)
    store.attach_index(ShardedIncrementalIndex())
    return store


def test_meshed_query_on_card_equals_cpu(cuda):
    g = random_labeled_graph(1500, 6000, 6, seed=5, device="cpu")
    queries = [random_walk_query(g, 5, sparse=bool(i % 2), seed=70 + i,
                                 device="cpu") for i in range(3)]
    eng = SubgraphQueryEngine(g, mesh=_mesh("cuda:0"), enumerator="device",
                              device="cuda")
    cpu = SubgraphQueryEngine(g, mesh=_mesh("cpu"), enumerator="device",
                              device="cpu")
    for q in queries:
        got, st = eng.query(q)
        want, w_st = cpu.query(q)
        np.testing.assert_array_equal(got, want)
        assert st.ilgf_iterations == w_st.ilgf_iterations
        assert st.extras["enum"]["enum_shards"] == 4


def test_meshed_batch_on_card_equals_cpu(cuda):
    g = random_labeled_graph(1500, 6000, 6, seed=6, device="cpu")
    queries = [random_walk_query(g, 4 + i % 3, sparse=bool(i % 2),
                                 seed=80 + i, device="cpu") for i in range(6)]
    got = BatchQueryEngine(g, mesh=_mesh("cuda:0"), enumerator="device",
                           device="cuda").query_batch(queries)
    want = BatchQueryEngine(g, enumerator="device",
                            device="cpu").query_batch(queries)
    for (e1, s1), (e2, s2) in zip(got, want):
        np.testing.assert_array_equal(e1, e2)
        assert s1.ilgf_iterations == s2.ilgf_iterations


def test_meshed_service_on_card_equals_cpu(cuda):
    g = random_labeled_graph(600, 2000, 5, n_edge_labels=2, seed=9,
                             device="cpu")
    queries = [random_walk_query(g, 4, sparse=True, seed=90 + i,
                                 device="cpu") for i in range(6)]

    def run(device):
        store = _sharded_store(device, g)
        svc = GraphQueryService(store, GraphServiceConfig(
            max_slots=4, max_query_vertices=8, max_query_labels=8,
            enumerator="device", mesh=_mesh(device if device == "cpu"
                                            else "cuda:0")))
        for q in queries:
            svc.submit(q)
        out = {rid: emb for rid, emb, _ in svc.tick()}
        svc.add_edges([[0, 599], [1, 300], [2, 450]])
        svc.remove_edges([[0, 599]])
        out.update((rid, emb) for rid, emb, _ in svc.run_to_completion())
        svc.shutdown()
        return store, out

    before = _launches()
    store, got = run("cuda")
    after = _launches()
    cpu_store, want = run("cpu")
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    for name in ("counts", "deg", "cni"):
        assert torch.equal(getattr(store.index, name).cpu(),
                           getattr(cpu_store.index, name)), name
    for name in ("embed_join_count", "embed_join_emit_table", "cni_encode",
                 "candidate_filter", "cni_update"):
        assert after[name] > before[name], name


def test_device_mesh_needs_devices_beyond_the_visible_cards(cuda):
    from repro_torch.core import device_mesh

    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="devices are visible"):
        device_mesh(n + 1)
    assert device_mesh(n + 1, devices="cuda:0").n_shards == n + 1
    assert device_mesh().n_shards == n


def test_sharded_wrappers_count_one_launch_per_shard(cuda):
    from repro_torch.core import distributed_ilgf, ilgf
    from repro_torch.core.distributed import prepare_sharded_edges

    g = random_labeled_graph(2000, 8000, 6, seed=3, device="cuda")
    q = random_walk_query(g, 5, sparse=False, seed=4, device="cuda")
    for n in (1, 2, 4):
        mesh = _mesh("cuda:0", n)
        prepared = prepare_sharded_edges(g, mesh)
        before = _launches()
        res = distributed_ilgf(g, q, mesh, prepared=prepared)
        after = _launches()
        want = n * (res.iterations + 1)  # each round and the final match
        # cni_encode once more: the query's digest
        assert after["cni_encode"] - before["cni_encode"] == want + 1
        assert after["candidate_filter"] - before["candidate_filter"] == want
        ref_res = ilgf(g, q)
        assert torch.equal(res.alive, ref_res.alive)
        assert torch.equal(res.candidates, ref_res.candidates)
    # the sharded index: one cni_update launch per touched shard
    store = _sharded_store("cuda", g, 4)
    before = _launches()
    store.add_edges([[0, 10], [600, 1999]])  # shards 0, and 1 and 3
    after = _launches()
    assert after["cni_update"] - before["cni_update"] == 3


# ---------------------------------------------------------------------------
# training: the kernels under autograd
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hq,hkv,s,window,causal", [
    (4, 2, 80, None, True), (8, 1, 300, 64, True), (4, 4, 33, None, False)])
def test_flash_attention_function_grads_on_card(cuda, hq, hkv, s, window,
                                                causal):
    """With grad on, the call launches the kernel (the counter rises) and
    its grads are the plain version's VJP."""
    gen = torch.Generator(cuda).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               for shape in ((2, hq, s, 64), (2, hkv, s, 64), (2, hkv, s, 64)))
    cot = torch.randn((2, hq, s, 64), generator=gen, device=cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(*leaves, causal, window)
    assert fa_ops.flash_attention.launches == before + 1
    got = torch.autograd.grad(out, leaves, cot)
    plain = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want_out = fa_ref.mha_plain(*plain, causal=causal, window=window)
    want = torch.autograd.grad(want_out, plain, cot)
    torch.testing.assert_close(out, want_out, rtol=2e-5, atol=2e-5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_state", [True, False])
def test_wkv6_function_grads_on_card(cuda, with_state):
    """With grad on, the call launches the forward kernel and its backward
    the backward kernel (one launch each); the grads are the plain
    version's autograd VJP within 1e-5 of each leaf's largest value (the
    kernel sums in another order, so a grad near zero differs by more than
    1e-6 of itself)."""
    gen = torch.Generator(cuda).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    b, h, t, d = 2, 4, 40, 64
    inputs = [randn(b, h, t, d), randn(b, h, t, d), randn(b, h, t, d),
              torch.rand((b, h, t, d), generator=gen, device=cuda) * 0.79 + 0.2,
              randn(h, d)] + ([randn(b, h, d, d)] if with_state else [])
    cot = (randn(b, h, t, d), randn(b, h, d, d))
    leaves = [x.clone().requires_grad_(True) for x in inputs]
    before = wkv_ops.launch_counts()
    o, s = wkv_ops.wkv6(*leaves, *(() if with_state else (None,)))
    assert wkv_ops.wkv6.launches == before["wkv6"] + 1
    got = torch.autograd.grad((o, s), leaves, cot)
    assert wkv_ops.wkv6_backward.launches == before["wkv6_backward"] + 1
    plain = [x.clone().requires_grad_(True) for x in inputs]
    o_p, s_p = wkv_ref.wkv6_plain(*plain, *(() if with_state else (None,)))
    want = torch.autograd.grad((o_p, s_p), plain, cot)
    torch.testing.assert_close(o, o_p, rtol=0, atol=0)
    for g, w in zip(got, want):
        assert leaf_err(g, w) <= 1e-5, leaf_err(g, w)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-7b"])
def test_loss_grads_on_card_launch_kernels(cuda, arch, remat):
    """``loss_fn`` with grads on the card launches each layer's kernel in
    the forward, and again in a full remat's recompute; loss and grads
    equal the CPU's."""
    import dataclasses

    from repro_torch.models import model as M

    cfg, p_cpu, p_gpu = lm_pair(arch, cuda)
    cfg = dataclasses.replace(cfg, remat=remat)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 24)),
             "labels": rng.integers(0, cfg.vocab, size=(2, 24))}
    kernel = fa_ops.flash_attention if arch != "rwkv6-7b" else wkv_ops.wkv6
    out = []
    for params in (p_cpu, p_gpu):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        before = kernel.launches
        loss, _ = M.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
        out.append((loss.detach().cpu(), [g.cpu() for g in grads],
                    kernel.launches - before))
    (loss_c, grads_c, n_cpu), (loss_g, grads_g, n_gpu) = out
    assert n_cpu == 0
    assert n_gpu == cfg.n_layers * (2 if remat == "full" else 1)
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-5, atol=1e-6)
    for g, c in zip(grads_g, grads_c):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("ce_chunk", [0, 128])
def test_deepseek_loss_grads_on_card(cuda, ce_chunk):
    """Reduced deepseek-v3 (a dense and a MoE layer, MLA, the MTP head)
    under remat "full": both loss routes on the card equal the CPU's, with
    ``mtp_loss``; the two stacks' layers launch flash_attention in the
    forward and the recompute, the MTP layer once."""
    import dataclasses

    from repro_torch.models import model as M

    cfg, p_cpu, p_gpu = lm_pair("deepseek-v3-671b", cuda)
    cfg = dataclasses.replace(cfg, remat="full", ce_chunk=ce_chunk)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, 24)),
             "labels": rng.integers(0, cfg.vocab, size=(2, 24))}
    out = []
    for params in (p_cpu, p_gpu):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        before = fa_ops.flash_attention.launches
        loss, metrics = M.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True, materialize_grads=True)
        out.append((loss.detach().cpu(), metrics["mtp_loss"].detach().cpu(),
                    [g.cpu() for g in grads],
                    fa_ops.flash_attention.launches - before))
    (loss_c, mtp_c, grads_c, n_cpu), (loss_g, mtp_g, grads_g, n_gpu) = out
    assert n_cpu == 0 and n_gpu == 2 * cfg.n_layers + 1
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mtp_g, mtp_c, rtol=1e-5, atol=1e-6)
    for g, c in zip(grads_g, grads_c):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-5)


def test_trainer_on_card_equals_cpu(cuda):
    import copy

    from repro_torch.train import Trainer, TrainerConfig

    cfg, p_cpu, _ = lm_pair("granite-3-2b", cuda)
    hists = []
    for device in ("cpu", cuda):
        tr = Trainer(cfg, TrainerConfig(steps=4, lr=3e-3, warmup=1, log_every=1),
                     global_batch=4, seq_len=32, device=device)
        before = fa_ops.flash_attention.launches
        params, state, hist = tr.run(params=copy.deepcopy(p_cpu).to(device))
        assert params.embed.device.type == torch.device(device).type
        assert state.step.device.type == torch.device(device).type
        hists.append((hist, fa_ops.flash_attention.launches - before))
    (h_cpu, n_cpu), (h_gpu, n_gpu) = hists
    assert n_cpu == 0 and n_gpu == 4 * cfg.n_layers
    np.testing.assert_allclose([m["loss"] for _, m in h_gpu],
                               [m["loss"] for _, m in h_cpu], rtol=1e-4)
