"""One run of one cell: make the data from the seed, build the service, warm
it up, serve the cell's closed-loop traffic for the window, check every
answer against the plain reference, and print the result line.

    python3 cnibench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The window opens at the first timed submit and stays open for at least
``--seconds``; it closes at the first tick after that which returns
results, so that the rate counts whole queries over the time they took.
Queries still in flight then are cancelled and not counted.  With
``--trace 1`` the program's spans are recorded over the whole window and
``torch.profiler`` over a steady stretch of it that the traffic file
states (``profile``: its start and length in seconds from the window's
opening, cut at the window's close); the result then carries the
per-layer metrics.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from cnib import checks, profiling, queries, spec, sub_seed

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CLOSE_WAIT_S = 120.0  # the longest the window waits past --seconds for a result


class Completed(NamedTuple):
    rid: int
    pool_index: int
    t_submit: float
    t_done: float
    levels: int | None      # join levels (EnumReport.levels)
    embeddings: np.ndarray


class Readings(NamedTuple):
    """What the metric readers (``metrics/<name>.py``) read."""

    setup_s: float
    t_open: float
    t_close: float
    completed: list         # Completed, returned inside the window
    spans: list             # the program's finished spans (traced runs)
    profile: object         # profiling.Profile or None
    shapes: dict            # the service's slot shapes
    peak_bytes: int | None  # device peak from the service's construction on

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def process_start() -> float:
    """This process's start on the ``perf_counter`` clock (the kernel's
    record of it; the interpreter's own start-up is set-up too)."""
    try:
        with open("/proc/self/stat", encoding="ascii") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


T_PROCESS = process_start()


def port_graph(q: queries.Query):
    """A query as the port's ``Graph``: both directions of each edge,
    sorted by source then destination, numpy fields."""
    from repro_torch.graphs.csr import Graph

    e = np.asarray(q.edges, dtype=np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    el = np.concatenate([q.elabels, q.elabels]).astype(np.int32)
    order = np.lexsort((dst, src))
    return Graph(vlabels=np.asarray(q.vlabels, dtype=np.int32), src=src[order],
                 dst=dst[order], elabels=el[order])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def steal_s() -> float:
    """CPU seconds that the hypervisor has taken from this machine's cores
    since boot (``/proc/stat``), or NaN where it is not reported."""
    try:
        with open("/proc/stat", encoding="ascii") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return float("nan")


def host_load(ru0, ru1, steal0: float, wall_s: float) -> str:
    """What the host gave this process over the window, for the log."""
    cpu = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime - ru0.ru_stime)
    return (f"host: {cpu:.3f} s of CPU in {wall_s:.3f} s, "
            f"{ru1.ru_nivcsw - ru0.ru_nivcsw} involuntary and "
            f"{ru1.ru_nvcsw - ru0.ru_nvcsw} voluntary context switches, "
            f"{steal_s() - steal0:.2f} s stolen from the machine's cores, "
            f"{torch.get_num_threads()} torch threads on "
            f"{len(os.sched_getaffinity(0))} cores, load {os.getloadavg()[0]:.2f}")


def make_data(cell: spec.Cell, seed: int, device):
    """The graph and the query pool (warm-up queries last), from the seed."""
    cfg, traffic = cell.config, cell.traffic
    gen = spec.load_module("generators", cfg["generator"])
    graph = gen.make_graph(cfg["graph"], sub_seed(seed, "graph"), device)
    q = traffic["query"]
    pool = queries.draw_pool(graph, q["shape"], q["sizes"],
                             int(traffic["pool"]) + int(traffic["warmup_queries"]),
                             sub_seed(seed, "queries"))
    sync(device)
    return graph, pool


def serve_window(svc, qgraphs, n_timed: int, clients: int, seconds: float,
                 trace: bool, traffic: dict, device, log):
    """The closed loop: ``clients`` clients, each submitting its next query
    as soon as its last one returns.  Returns (t_open, t_close, completed,
    failed, profile)."""
    from repro_torch.serve.graph_service import AdmissionRejected

    prof_at = float(traffic["profile"]["start_s"])
    prof_len = float(traffic["profile"]["seconds"])
    recorder = profiling.Recorder(torch.device(device).type == "cuda") if trace else None
    if recorder is not None:
        recorder.warm_up()
    profile = None
    inflight: dict[int, tuple[int, float]] = {}
    completed: list[Completed] = []
    failed = 0
    next_q = 0

    def submit_next():
        nonlocal next_q, failed
        i = next_q % n_timed
        if next_q and i == 0:
            log(f"the pool of {n_timed} queries is used up; it starts again")
        next_q += 1
        try:
            rid = svc.submit(qgraphs[i])
        except AdmissionRejected as err:
            failed += 1
            log(f"query {i} rejected: {err}")
            return
        inflight[rid] = (i, time.perf_counter())

    t_open = time.perf_counter()
    for _ in range(clients):
        submit_next()
    t_due = t_open + seconds
    prof_state = 0  # 0 not started, 1 recording, 2 done
    while True:
        now = time.perf_counter()
        if recorder is not None:
            if prof_state == 0 and now >= t_open + prof_at:
                recorder.start()
                prof_state = 1
            elif prof_state == 1 and now >= recorder.t0 + prof_len:
                recorder.stop()
                prof_state = 2
        try:
            out = svc.tick()
        except Exception as err:  # the program failed: the run is not correct
            failed += len(inflight)
            log(f"tick raised {type(err).__name__}: {err}")
            t_close = time.perf_counter()
            break
        t_done = time.perf_counter()
        for rid, emb, stats in out:
            i, t_sub = inflight.pop(rid)
            enum = stats.extras.get("enum")
            completed.append(Completed(rid, i, t_sub, t_done,
                                       None if enum is None else len(enum.levels),
                                       np.asarray(emb)))
        if (out and t_done >= t_due) or t_done >= t_due + CLOSE_WAIT_S:
            t_close = t_done
            break
        for _ in out:
            submit_next()
        if not inflight:
            log("no query in flight: every client's query failed")
            t_close = t_done
            break
    if prof_state == 1:
        recorder.stop()
    if prof_state:
        profile = recorder.read()
    return t_open, t_close, completed, failed, profile


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             log=lambda msg: print(msg, file=sys.stderr, flush=True)) -> dict:
    """One run; returns the result line as a dict (``checks`` last)."""
    from repro_torch import obsv
    from repro_torch.graphs.csr import Graph
    from repro_torch.serve.graph_service import GraphQueryService, GraphServiceConfig

    cuda = torch.device(device).type == "cuda"
    traffic = cell.traffic
    clients = int(traffic["clients"])
    n_timed = int(traffic["pool"])

    t0 = time.perf_counter()
    graph, pool = make_data(cell, seed, device)
    qgraphs = [port_graph(q) for q in pool]
    deg = torch.bincount(graph["src"], minlength=graph["vlabels"].numel())
    log(f"data: {graph['vlabels'].numel()} vertices, {graph['src'].numel()} directed "
        f"edges, degrees up to {int(deg.max())}; {len(pool)} queries; "
        f"{time.perf_counter() - t0:.3f} s")
    del deg
    gen_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    svc = GraphQueryService(
        Graph(graph["vlabels"], graph["src"], graph["dst"], graph["elabels"]),
        GraphServiceConfig(max_slots=clients, enumerator="device"), device=device)
    for i in range(n_timed, len(pool)):  # warm-up: the queries after the pool
        svc.submit(qgraphs[i])
    svc.run_to_completion()
    sync(device)
    t_setup_end = time.perf_counter()

    tracer = obsv.Tracer() if trace else None
    prev = obsv.set_tracer(tracer) if trace else None
    ru0, steal0 = resource.getrusage(resource.RUSAGE_SELF), steal_s()
    try:
        t_open, t_close, completed, failed, profile = serve_window(
            svc, qgraphs, n_timed, clients, seconds, trace, traffic, device, log)
    finally:
        if trace:
            obsv.set_tracer(prev)
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    setup_s = t_open - T_PROCESS
    log(f"set-up {setup_s:.3f} s (to the end of warm-up {t_setup_end - T_PROCESS:.3f} s); "
        f"window {t_close - t_open:.3f} s, {len(completed)} queries returned")
    log(host_load(ru0, ru1, steal0, t_close - t_open))
    peak = torch.cuda.max_memory_allocated() if cuda else None
    shapes = {"slots": clients, "n_vertices": svc.n_vertices,
              "max_query_vertices": svc.cfg.max_query_vertices,
              "max_query_labels": svc.cfg.max_query_labels}
    svc.shutdown(drain=False)
    del svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    readings = Readings(setup_s, t_open, t_close, completed,
                        tracer.spans if tracer is not None else [], profile,
                        shapes, peak)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.load_module("metrics", m["name"]).read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    t_ref = time.perf_counter()
    ref = spec.load_module("references", cell.config["reference"])
    index = ref.build_index(graph, cell.config.get("reference_device", device))
    found = checks.compare([(c.pool_index, c.embeddings) for c in completed],
                           pool, ref, index, failed=failed)
    del index
    log(f"reference: {len(completed)} answers checked in "
        f"{time.perf_counter() - t_ref:.3f} s")
    wrong = next(c.value for c in found if c.name == "wrong")

    result = {
        "correct": all(c.ok for c in found),
        "attempted": len(completed) + failed,
        "failed": failed + wrong,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": max(gen_peak, peak or 0),
        },
    }
    if trace and profile is not None:
        result["device"]["busy_s"] = profiling.busy_seconds(profile)
        result["device"]["window_s"] = profile.window_s
        result["breakdown"] = {
            "device_ops": profiling.top_ops(profile),
            "idle_gaps": profiling.labelled_gaps(profile, readings.spans),
        }
    result["checks"] = {c.name: c.as_json() for c in found}
    for c in found:
        log(f"check {c.name} {c.value} {c.op} {c.limit}: {'ok' if c.ok else 'FAILED'}")
    return result


def forbidden_modules() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
