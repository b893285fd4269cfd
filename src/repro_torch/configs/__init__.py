"""Presets of the port: the CNI engine's defaults and the ten model
architectures (``get_config(name)`` / ``--arch <id>``)."""

from repro_torch.configs.cni_engine import CONFIG, CniEngineConfig
from repro_torch.configs.registry import ARCHITECTURES, get_config, list_architectures

__all__ = ["ARCHITECTURES", "CONFIG", "CniEngineConfig", "get_config",
           "list_architectures"]
