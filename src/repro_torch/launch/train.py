"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --steps 30 --batch 8 --seq 128 --device cpu

``--device`` defaults to CUDA.  ``--reduced`` trains the smoke-scale
variant of the architecture; params are random, drawn from a generator
seeded with ``--seed``, and the data is ``SyntheticLMDataset``'s.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, list_architectures
from repro_torch.device import resolve_device
from repro_torch.train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_architectures())
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced smoke config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--micro-batches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    tcfg = TrainerConfig(
        steps=args.steps,
        lr=args.lr,
        micro_batches=args.micro_batches,
        checkpoint_dir=args.ckpt,
        grad_compression=args.grad_compression,
    )
    trainer = Trainer(cfg, tcfg, global_batch=args.batch, seq_len=args.seq,
                      seed=args.seed, dtype=torch.float32, device=dev)
    _, _, history = trainer.run(
        generator=torch.Generator(dev).manual_seed(args.seed))
    if history:
        first, last = history[0][1]["loss"], history[-1][1]["loss"]
        print(f"[train] {cfg.name} on {dev}: loss {first:.4f} -> {last:.4f} "
              f"over {args.steps} steps")
    return history


if __name__ == "__main__":
    main()
