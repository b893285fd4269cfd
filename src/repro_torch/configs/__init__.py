"""Engine presets of the port."""

from repro_torch.configs.cni_engine import CONFIG, CniEngineConfig

__all__ = ["CONFIG", "CniEngineConfig"]
