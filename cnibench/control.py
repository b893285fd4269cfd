"""The control of a cell's comparison: the plain reference put in the
program's place with one guarantee of the configuration broken, which the
comparison has to catch.

    python3 cnibench/control.py --workload <name> --seeds 11,12,13 --queries 30

For each seed it makes the cell's graph and query pool at the cell's own
size, answers the first ``--queries`` queries of the pool (about as many as
a run completes) with ``embeddings(..., drop_last_edges=True)`` (the last
query vertex matched to every vertex of its label, its edges unchecked),
and prints one JSON line of the comparison's numbers per seed.  The
benchmark's own runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))

import torch  # noqa: E402

from cnib import checks, main, spec  # noqa: E402


def control_checks(cell, seed: int, n_queries: int, device) -> dict:
    """The comparison's numbers with the control in the program's place."""
    graph, pool = main.make_data(cell, seed, device)
    ref = spec.load_module("references", cell.config["reference"])
    index = ref.build_index(graph, cell.config.get("reference_device", device))
    answers = [(i, ref.embeddings(index, q.vlabels, q.edges, q.elabels,
                                  drop_last_edges=True))
               for i, q in enumerate(pool[:n_queries])]
    found = checks.compare(answers, pool, ref, index, failed=0)
    return {c.name: c.value for c in found} | {"correct": all(c.ok for c in found)}


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--queries", type=int, required=True)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_checks(cell, seed, args.queries, "cuda")
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0} | out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
