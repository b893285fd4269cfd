"""Architecture registry: the ten published configurations, copied as data
from the reference, and ``get_config(name)`` / ``--arch <id>``.

The port serves and trains the dense GQA (``granite-*``,
``starcoder2-15b``), MLA (``minicpm3-4b``), MoE (``qwen3-moe-30b-a3b``),
MoE with MLA, a first_k_dense stack and an MTP head
(``deepseek-v3-671b``) and RWKV (``rwkv6-7b``) families; building the
params or cache of another config (hybrid, encdec, vlm) raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import importlib

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


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.CONFIG


def list_architectures() -> tuple[str, ...]:
    return ARCHITECTURES
