"""Architecture registry: the ten published configurations, copied as data
from the reference, ``get_config(name)`` / ``--arch <id>``, and the
reference's input-shape grid (a copy: the port imports nothing of the
reference):

    train_4k     seq 4,096   global_batch 256   (train_step)
    prefill_32k  seq 32,768  global_batch 32    (prefill forward)
    decode_32k   seq 32,768  global_batch 128   (serve_step, 1 new token)
    long_500k    seq 524,288 global_batch 1     (serve_step; sub-quadratic only)

The port serves and trains every family: dense GQA (``granite-*``,
``starcoder2-15b``), MLA (``minicpm3-4b``), MoE (``qwen3-moe-30b-a3b``),
MoE with MLA, a first_k_dense stack and an MTP head
(``deepseek-v3-671b``), RWKV (``rwkv6-7b``), hybrid attention + Mamba
(``hymba-1.5b``), encoder-decoder (``seamless-m4t-large-v2``) and a
vision prefix (``internvl2-26b``).
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
}

ARCHITECTURES = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.CONFIG


def list_architectures() -> tuple[str, ...]:
    return ARCHITECTURES


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if runnable; otherwise the skip reason (the reference's text)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: 500k dense-KV decode out of scope (DESIGN.md §5)"
    return None


def all_cells():
    """The 40 cells as (arch, shape, skip_reason|None)."""
    out = []
    for arch in ARCHITECTURES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            out.append((arch, shape.name, shape_applicable(cfg, shape)))
    return out


def frontend_len(cfg: ModelConfig, seq_len: int) -> int:
    """Stub frontend length (DESIGN.md §5): audio frames = seq // 4 (at
    least 64), vision = ``cfg.frontend_seq`` (256 by default) patches."""
    if cfg.frontend == "audio":
        return max(64, seq_len // 4)
    if cfg.frontend == "vision":
        return cfg.frontend_seq or 256
    return 0
