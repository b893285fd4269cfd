"""Perf variants of a dry-run cell (port of ``repro.launch.perf``): re-plan
one cell on ``meta`` under named variants (sharding-rule overrides, config
overrides, micro-batching) and record the roofline terms and memory.

    PYTHONPATH=src python -m repro_torch.launch.perf \
        --cell granite-3-2b:train_4k --variant ce_chunk8

Records land in ``results/torch_perf/<arch>__<shape>__<variant>.json``.  A
variant whose config field the port's ``ModelConfig`` lacks raises
``KeyError`` naming it (``docs/GPU_PLANNING.md``); none does today.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.launch.dryrun import memory_analysis, param_dtype, scaled_costs
from repro_torch.launch.mesh import make_policy, make_production_mesh
from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS_BY_DTYPE

RESULTS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "results", "torch_perf")

# the reference's named variants, composable as a comma-separated list
VARIANTS: dict[str, dict] = {
    "baseline": {},
    # pure FSDP: no tensor parallelism; the batch splits over every axis and
    # the weights over (data, model)
    "fsdp_pure": {
        "rules": {
            "batch": ("pod", "data", "model"),
            "heads": None, "kv_heads": None, "ff": None, "vocab": None,
            "experts": None, "fsdp": ("data", "model"),
        },
        "force_fsdp": True,
    },
    "remat_dots": {"cfg": {"remat": "dots"}},
    "remat_none": {"cfg": {"remat": "none"}},
    # MoE: bigger or smaller dispatch groups
    "moe_group_2048": {"cfg_moe": {"group_size": 2048}},
    "moe_group_128": {"cfg_moe": {"group_size": 128}},
    # decode: the cache's sequence over data, or not split at all
    "kv_seq_sharded": {"rules": {"kv_seq": "data"}},
    "kv_seq_replicated": {"rules": {"kv_seq": None}},
    "mla_absorbed": {"cfg": {"mla_absorb": True}},
    # stream the CE over vocab chunks (vp / 8 each): no (B, S, V) logits
    "ce_chunk8": {"cfg_fn": "ce_chunk8"},
    # the scatter/gather MoE slot plan: no one-hot dispatch tensor
    "moe_gather": {"cfg_moe": {"dispatch": "gather"}},
    # sequence parallelism: residual activations split over the model axis
    "seq_parallel": {"rules": {"seq": "model"}},
    "kv_seq_model": {"rules": {"kv_seq": "model"}},
    # gradient accumulation: 8 sequential micro-batches a step
    "microbatch8": {"micro_batches": 8},
}


def _replace(obj, fields: dict, variant: str):
    """``dataclasses.replace`` that raises ``KeyError`` naming the variant
    when the port's config lacks one of ``fields``."""
    have = {f.name for f in dataclasses.fields(obj)}
    missing = sorted(set(fields) - have)
    if missing:
        raise KeyError(f"variant {variant!r}: the port's "
                       f"{type(obj).__name__} has no field {missing}")
    return dataclasses.replace(obj, **fields)


def _apply_cfg_fn(cfg, name: str):
    if name == "ce_chunk8":
        from repro_torch.models.model import vocab_padded

        return _replace(cfg, {"ce_chunk": vocab_padded(cfg) // 8}, name)
    raise KeyError(name)


def apply_variant(cfg, pol, names: list[str]):
    mb = 1
    for name in names:
        v = VARIANTS[name]
        if "rules" in v:
            pol.rules.update(v["rules"])
        if v.get("force_fsdp"):
            pol.enable_fsdp = True
        if "cfg" in v:
            cfg = _replace(cfg, v["cfg"], name)
        if "cfg_moe" in v and cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=_replace(cfg.moe, v["cfg_moe"],
                                                        name))
        if "cfg_fn" in v:
            cfg = _apply_cfg_fn(cfg, v["cfg_fn"])
        mb = max(mb, v.get("micro_batches", 1))
    return cfg, pol, mb


def run_variant(arch: str, shape_name: str, variant: str, *,
                save: bool = True) -> dict:
    names = variant.split(",")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    pol = make_policy(cfg, make_production_mesh(multi_pod=False))
    cfg, pol, mb = apply_variant(cfg, pol, names)
    dtype = param_dtype(cfg)

    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "param_dtype": str(dtype).removeprefix("torch.")}
    t0 = time.time()
    rec["memory_analysis"] = memory_analysis(cfg, shape, pol, mb, dtype)
    rec["scaled"] = scaled_costs(cfg, shape, pol, mb, dtype)
    rec["plan_seconds"] = round(time.time() - t0, 1)
    sc = rec["scaled"]
    rec["terms"] = {
        "compute_s": sc["flops_per_device"] / PEAK_FLOPS_BY_DTYPE[
            rec["param_dtype"]],
        "memory_s": sc["bytes_per_device"] / HBM_BW,
        "collective_s": sc["collective_bytes_per_device"] / NVLINK_BW,
    }
    rec["dominant"] = max(rec["terms"], key=rec["terms"].get)
    if save:
        os.makedirs(os.path.abspath(RESULTS_DIR), exist_ok=True)
        path = os.path.join(
            os.path.abspath(RESULTS_DIR),
            f"{arch}__{shape_name}__{variant.replace(',', '+')}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", default="baseline")
    args = ap.parse_args(argv)
    arch, shape = args.cell.split(":")
    rec = run_variant(arch, shape, args.variant)
    t = rec["terms"]
    print(
        f"{args.cell} [{args.variant}]: compute={t['compute_s']:.3e}s "
        f"memory={t['memory_s']:.3e}s collective={t['collective_s']:.3e}s "
        f"dominant={rec['dominant']} temp_mem="
        f"{rec['memory_analysis']['temp_size_in_bytes'] / 1e9:.1f}GB")


if __name__ == "__main__":
    main()
