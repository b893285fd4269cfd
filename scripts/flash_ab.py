#!/usr/bin/env python3
"""Time ``flash_attention`` of two checkouts of the repository on one card,
in turns: A, B, B, A (each turn a fresh process that builds its checkout's
kernel and times it), at the shapes the LM path gives it.

    python3 scripts/flash_ab.py <checkout A> <checkout B> [--rounds 2]

Each shape's time is the device time of one call (a CUDA graph of 20 calls
replayed 10 times, CUDA events), as ``chip_smoke.py`` times a kernel.  The
card's name, power limit and SM clock are printed beside the times.  Both
checkouts must take (q, k, v) of one width; a checkout that reads V at
its own width is called with V as wide as q and k.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

# (name, (b, hq, hkv, sq, skv, d), kwargs): phase 3's prefill and decode,
# phase 14's training prefill, phase 15's D 128 prefill
SHAPES = [
    ("prefill_2048_d64", (1, 32, 8, 2048, 2048, 64), {}),
    ("train_prefill_d64", (4, 32, 8, 512, 512, 64), {}),
    ("train_prefill_d128", (4, 32, 4, 512, 512, 128), {}),
    ("decode_d64", (8, 32, 8, 1, 512, 64), {"q_offset": 93, "kv_len": 94}),
]

CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch.kernels.flash_attention import ops
ops.library()
gen = torch.Generator("cuda").manual_seed(0)
out = {}
for name, (b, hq, hkv, sq, skv, d), kw in json.loads(sys.argv[2]):
    q = torch.randn((b, hq, sq, d), generator=gen, device="cuda")
    k, v = (torch.randn((b, hkv, skv, d), generator=gen, device="cuda")
            for _ in range(2))
    fn = lambda: ops.flash_attention(q, k, v, **kw)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    out[name] = start.elapsed_time(stop) / 200
print(json.dumps(out))
"""


def run(checkout: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, checkout,
                           json.dumps(SHAPES)], capture_output=True,
                          text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    print(smi("name,power.limit"))
    times = {"a": [], "b": []}
    for _ in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            times[side].append(run(getattr(args, side)))
            print(f"{side} ({Path(getattr(args, side)).resolve().name}): "
                  f"{times[side][-1]}; sm clock {smi('clocks.sm')}",
                  flush=True)
    for name, *_ in SHAPES:
        a = sorted(t[name] for t in times["a"])
        b = sorted(t[name] for t in times["b"])
        print(f"{name}: A {a[len(a) // 2]:.5f} ms (runs {a}), B "
              f"{b[len(b) // 2]:.5f} ms (runs {b}), B/A "
              f"{b[len(b) // 2] / a[len(a) // 2]:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
