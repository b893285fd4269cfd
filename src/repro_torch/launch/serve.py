"""Serving launcher: batched decode with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --requests 6 --max-new 16 --device cpu

``--device`` defaults to CUDA.  Params are random, drawn from a generator
seeded with ``--seed``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_architectures
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_architectures())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = M.init_params(cfg, torch.Generator(dev).manual_seed(args.seed), dev)
    eng = ServeEngine(
        params, cfg,
        ServeConfig(max_batch=args.max_batch, max_len=args.max_len,
                    eos_token=-1),
    )
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for _ in range(args.requests):
        plen = int(rng.integers(2, 8))
        eng.submit(rng.integers(0, cfg.vocab, size=plen), args.max_new)
    done = eng.run_to_completion()
    dt = time.perf_counter() - t0
    toks = sum(len(t) for _, t in done)
    print(f"[serve] {cfg.name} on {dev}: {len(done)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    return done


if __name__ == "__main__":
    main()
