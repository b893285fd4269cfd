#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                     # every phase, one card
    python3 chip_smoke.py --phases 1,2,3      # device, build, kernel checks

Phases:

1. device   — the card's name and power limit (nvidia-smi); no card, no run.
2. build    — nvcc builds the embed-join kernels from ``csrc/``; prints
              ptxas's resource lines and the build seconds.
3. kernels  — each kernel against its plain PyTorch version at the shapes
              of real join levels (recorded from a HUMAN query and a
              join-heavy query) plus ragged edges; exact equality; each
              kernel's device time (CUDA-graph replay), its eager wrapper
              time and its plain version's eager time (CUDA events), and
              its bound.
4. HUMAN    — ``SubgraphQueryEngine(g, enumerator="device")`` on the
              paper's HUMAN stand-in (4,675 V / 44 labels), four
              random-walk queries, each held bit for bit against the DFS
              oracle on the filtered graph and against the host join engine.
5. join     — the same on ``random_labeled_graph(8000, 40000, 8)`` with
              4-6-vertex sparse queries (join tables of thousands of rows).
6. scale    — a uniform graph with LiveJournal's cardinalities
              (4,847,571 V / 68,993,773 E / 200 labels), one 10-vertex
              dense query; peak device memory, ILGF rounds, phase seconds.
7. counts   — kernel launches during phases 4-6 (reset just before phase 4,
              read just after phase 6); the count and emit kernels must have
              launched.

Any failure propagates: the script exits non-zero and prints no result.
The last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet), used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
# 32-bit scalar rate outside the tensor cores (the float32 figure; the
# kernels' integer compares run on the same CUDA cores)
SCALAR_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    name = torch.cuda.get_device_name(0)
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {name} count {torch.cuda.device_count()}")
    return name


def phase_build(ops):
    built = ops.library()
    log(f"[2 build] {built.path.name}: {built.seconds:.2f} s")
    log(built.log.strip())
    return built


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def record_levels(ops, search, engine, query):
    """Run one device-join query and return the operands of each count
    launch (one per row slice of each level), recorded on the way."""
    calls = []

    def recording(*args):
        calls.append(args)  # the join replaces tables, never writes them
        return ops.embed_join_count(*args)

    # the search module sees a recording stand-in for the ops module
    search.ops = types.SimpleNamespace(
        embed_join=ops.embed_join, embed_join_count=recording,
        embed_join_emit=ops.embed_join_emit)
    try:
        engine.query(query)
    finally:
        search.ops = ops
    return calls


def cells(args) -> int:
    table, _, cand, *_ = args
    return table.shape[0] * cand.shape[0]


def ragged_variants(args, rng):
    """Edge cases around one real level: R not a multiple of 32 with a dead
    tail, an inert single constraint, a 16-column table, all on the
    level's real 128-padded candidate list (invalid tail included)."""
    table, row_valid, cand, cand_valid, elab, qp, ql, qv = args
    dev = table.device
    out = []
    r = min(table.shape[0], 1000) - 19  # 981 or 109: not a multiple of 32
    rv = row_valid[:r].clone()
    rv[-7:] = False
    out.append(("ragged_rows", (table[:r].contiguous(), rv, cand, cand_valid,
                                elab, qp, ql, qv)))
    out.append(("inert_J1", (table, row_valid, cand, cand_valid, elab,
                             qp[:1].contiguous(), ql[:1].contiguous(),
                             torch.zeros(1, dtype=torch.bool, device=dev))))
    # 16 columns: the level's real rows, then 11 random vertex ids (extra
    # injectivity work) and one inert constraint on a random column
    n = elab.shape[0]
    r16 = min(table.shape[0], 301)
    extra = torch.as_tensor(rng.integers(0, n, size=(r16, 16 - table.shape[1])),
                            dtype=torch.int32, device=dev)
    t16 = torch.cat([table[:r16], extra], dim=1).contiguous()
    qp16 = torch.cat([qp, torch.tensor([12], dtype=torch.int32, device=dev)])
    ql16 = torch.cat([ql, torch.tensor([0], dtype=torch.int32, device=dev)])
    qv16 = torch.cat([qv, torch.tensor([False], device=dev)])
    out.append(("T16", (t16, row_valid[:r16].contiguous(), cand, cand_valid,
                        elab, qp16, ql16, qv16)))
    return out


def check_level(ops, ref, name, args, row_base):
    """Exact kernel-vs-plain check of all three kernels on one level;
    returns the largest absolute difference seen (0 when they agree)."""
    count_k = ops.embed_join_count(*args)
    count_p = ref.embed_join_count_ref(*args)
    grid_k = ops.embed_join(*args)
    grid_p = ref.embed_join_grid_ref(*args)
    row_off = count_p.cumsum(0) - count_p
    total = int(count_p.sum())
    fill = torch.full((total + 5,), -7, dtype=torch.int64, device=args[0].device)
    emit_k = ops.embed_join_emit(fill.clone(), *args, row_off, row_base)
    emit_p = ref.embed_join_emit_ref(fill.clone(), *args, row_off, row_base)
    torch.cuda.synchronize()
    errs = {
        "embed_join_count": int((count_k.long() - count_p.long()).abs().max()),
        "embed_join_grid": int((grid_k.long() - grid_p.long()).abs().max()),
        "embed_join_emit": int((emit_k - emit_p).abs().max()),
    }
    table, _, cand, _, _, qp, *_ = args
    log(f"  {name}: R={table.shape[0]} T={table.shape[1]} C={cand.shape[0]} "
        f"J={qp.shape[0]} row_base={row_base} survivors={total} "
        f"max_abs_err={errs}")
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version on "
                             f"{name}: {bad}")
    if not bool((emit_k[total:] == -7).all()):
        raise AssertionError(f"emit kernel wrote past the survivors on {name}")
    return errs


def time_ms(fn, iters: int) -> float:
    """Eager time per call: CUDA events around ``iters`` calls after a
    warm-up, so host-side launch work counts when it is the slower side."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time per launch: ``per_graph`` launches captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no Python
    or launch overhead sits between the kernels."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * per_graph)


def bound_of(args, out_bytes: int, extra_in_bytes: int = 0):
    """Least time for one join level: bytes each input must be read once
    (elab only at the (mapped neighbour, candidate) entries this level's
    data needs) and each output written once, against the compares."""
    table, row_valid, cand, cand_valid, elab, qp, ql, qv = args
    live = table[row_valid]
    n_cand = int(cand_valid.sum())
    mapped = live[:, qp[qv].long()]
    distinct = int(torch.unique(mapped).numel()) if mapped.numel() else 0
    in_bytes = (table.numel() * 4 + row_valid.numel() + cand.numel() * 4
                + cand_valid.numel() + distinct * n_cand * 4
                + 9 * qp.numel() + extra_in_bytes)
    ops_count = live.shape[0] * n_cand * (int(qv.sum()) + table.shape[1])
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops_count / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(ops, ref, search, core, graphs, dev):
    rng = np.random.default_rng(0)
    human = graphs.paper_dataset("HUMAN", device=dev)
    q_h = graphs.random_walk_query(human, 16, sparse=True, seed=4, device=dev)
    levels_h = record_levels(ops, search,
                             core.SubgraphQueryEngine(human, enumerator="device"), q_h)
    heavy = graphs.random_labeled_graph(8000, 40000, 8, seed=42, device=dev)
    q_j = graphs.random_walk_query(heavy, 6, sparse=True, seed=3, device=dev)
    levels_j = record_levels(ops, search,
                             core.SubgraphQueryEngine(heavy, enumerator="device"), q_j)
    real_h = max(levels_h, key=cells)
    real_j = max(levels_j, key=cells)
    log(f"[3 kernels] recorded {len(levels_h)} HUMAN and {len(levels_j)} "
        f"join-heavy level slices; checking the largest of each")
    max_err = {"embed_join_count": 0, "embed_join_grid": 0, "embed_join_emit": 0}
    cases = [("HUMAN_level", real_h), ("join_level", real_j)]
    cases += ragged_variants(real_j, rng)
    for i, (name, args) in enumerate(cases):
        errs = check_level(ops, ref, name, args, row_base=0 if i == 0 else 4096 + i)
        for k, v in errs.items():
            max_err[k] = max(max_err[k], v)

    # times at the join-heavy level (the largest real level)
    args = real_j
    table = args[0]
    count_p = ref.embed_join_count_ref(*args)
    row_off = count_p.cumsum(0) - count_p
    total = int(count_p.sum())
    idx = torch.zeros(total, dtype=torch.int64, device=table.device)
    r, c = table.shape[0], args[2].shape[0]
    fns = {
        "embed_join_count": (lambda: ops.embed_join_count(*args),
                             lambda: ref.embed_join_count_ref(*args),
                             bound_of(args, out_bytes=4 * r)),
        "embed_join_grid": (lambda: ops.embed_join(*args),
                            lambda: ref.embed_join_grid_ref(*args),
                            bound_of(args, out_bytes=r * c)),
        "embed_join_emit": (lambda: ops.embed_join_emit(idx, *args, row_off, 0),
                            lambda: ref.embed_join_emit_ref(idx, *args, row_off, 0),
                            bound_of(args, out_bytes=8 * total,
                                     extra_in_bytes=8 * r)),
    }
    timings = {}
    for name, (kern, plain, (bound_ms, bound_by)) in fns.items():
        ms = device_ms(kern)
        eager_ms = time_ms(kern, 200)
        plain_ms = time_ms(plain, 20)
        timings[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        log(f"  time {name}: kernel {ms:.5f} ms on the device "
            f"({eager_ms:.5f} ms per eager wrapper call), plain "
            f"{plain_ms:.5f} ms per eager call, bound {bound_ms:.5f} ms "
            f"({bound_by}) at R={r} C={c} "
            f"T={table.shape[1]} J={args[5].shape[0]} survivors={total}")
    return max_err, timings


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------


def oracle(core, graphs, engine, q):
    """DFS oracle on the filtered graph (as examples/quickstart.py checks)."""
    res = core.ilgf(engine.data, q)
    alive = res.alive.cpu().numpy()
    sub, old_ids = graphs.induced_subgraph(engine.data, alive)
    emb = core.host_dfs_search(sub, q, res.candidates.cpu().numpy()[alive])
    return old_ids[emb] if emb.size else emb


def run_queries(core, graphs, g, queries, tag):
    eng_dev = core.SubgraphQueryEngine(g, enumerator="device")
    eng_host = core.SubgraphQueryEngine(g, enumerator="host")
    for n_q, sparse, seed in queries:
        q = graphs.random_walk_query(g, n_q, sparse=sparse, seed=seed, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, st = eng_dev.query(q)
        wall = time.perf_counter() - t0
        emb_host, _ = eng_host.query(q)
        truth = oracle(core, graphs, eng_dev, q)
        enum = st.extras["enum"]
        log(f"  {tag} q{n_q} {'sparse' if sparse else 'dense'} seed={seed}: "
            f"alive {st.vertices_after}/{st.vertices_before} in "
            f"{st.ilgf_iterations} rounds, {st.n_embeddings} embeddings, "
            f"filter {st.filter_seconds:.4f} s, search {st.search_seconds:.4f} s, "
            f"wall {wall:.4f} s, levels {enum['device_rounds']}, "
            f"max table {enum['max_table_rows']} rows")
        if emb.shape != (truth.shape[0], n_q) or emb.shape[0] == 0:
            raise AssertionError(f"{tag} q{n_q}: shape {emb.shape}, oracle "
                                 f"{truth.shape} (random-walk queries match)")
        if not np.array_equal(emb, truth):
            raise AssertionError(f"{tag} q{n_q}: device join != DFS oracle")
        if not np.array_equal(emb_host, truth):
            raise AssertionError(f"{tag} q{n_q}: host join != DFS oracle")
        cap = max(1, truth.shape[0] // 2)
        if not np.array_equal(eng_dev.query(q, max_embeddings=cap)[0], truth[:cap]):
            raise AssertionError(f"{tag} q{n_q}: max_embeddings={cap} prefix differs")


def phase_human(core, graphs):
    g = graphs.paper_dataset("HUMAN", device="cuda")
    log(f"[4 HUMAN] {g.n_vertices} V / {g.n_edges} E / "
        f"{len(np.unique(g.vlabels.cpu().numpy()))} labels, "
        f"d_max {graphs.max_degree(g)}")
    run_queries(core, graphs, g,
                [(8, True, 1), (10, False, 2), (12, True, 3), (16, True, 4)],
                "HUMAN")


def phase_join(core, graphs):
    g = graphs.random_labeled_graph(8000, 40000, 8, seed=42, device="cuda")
    log(f"[5 join] {g.n_vertices} V / {g.n_edges} E / 8 labels")
    run_queries(core, graphs, g, [(4, True, 1), (5, True, 2), (6, True, 3)],
                "join")


def phase_scale(core, graphs, scale: float):
    n_v, n_e = int(4_847_571 * scale), int(68_993_773 * scale)
    log(f"[6 scale] uniform graph with LiveJournal cardinalities, scale "
        f"factor {scale} -> {n_v} V / {n_e} E / 200 labels")
    t0 = time.perf_counter()
    g = graphs.random_labeled_graph(n_v, n_e, 200, seed=7, device="cuda")
    torch.cuda.synchronize()
    log(f"  host generation + upload {time.perf_counter() - t0:.1f} s, "
        f"{g.n_edges} edges after dedup, d_max {graphs.max_degree(g)}")
    torch.cuda.reset_peak_memory_stats()
    run_queries(core, graphs, g, [(10, False, 3)], "scale")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="1,2,3,4,5,6,7",
                        help="comma-separated phase numbers to run")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="common factor on phase 6's V and E")
    args = parser.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, graphs
    from repro_torch.core import search
    from repro_torch.kernels.embed_join import ops, ref

    t_start = time.perf_counter()
    kind = phase_device()
    phase_build(ops)
    max_err = timings = None
    if 3 in phases:
        max_err, timings = phase_kernels(ops, ref, search, core, graphs, "cuda")
    ops.reset_launches()
    per_phase = {}
    for num, fn in ((4, lambda: phase_human(core, graphs)),
                    (5, lambda: phase_join(core, graphs)),
                    (6, lambda: phase_scale(core, graphs, args.scale))):
        if num in phases:
            before = ops.launch_counts()
            t0 = time.perf_counter()
            fn()
            after = ops.launch_counts()
            per_phase[num] = {k: after[k] - before[k] for k in after}
            log(f"  phase {num}: {time.perf_counter() - t0:.1f} s, "
                f"launches {per_phase[num]}")
    launches = ops.launch_counts()
    if 7 in phases:
        log(f"[7 counts] launches during phases 4-6: {launches}")
        for name in ("embed_join_count", "embed_join_emit", "embed_join_grid"):
            if launches[name] == 0:
                raise AssertionError(f"{name} never launched on the main path")
    if timings is not None:
        kernels = []
        for name, replaces in (
            ("embed_join_count", "src/repro/kernels/embed_join/kernel.py:174"),
            ("embed_join_grid", "src/repro/kernels/embed_join/kernel.py:129"),
            ("embed_join_emit", "src/repro/kernels/embed_join/ops.py:155"),
        ):
            kernels.append({
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/embed_join/csrc/embed_join.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max_err[name], **timings[name],
                "library_ms": None,
            })
        log(json.dumps({"kernels": kernels}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
