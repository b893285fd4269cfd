"""The LM substrate of the port: configs, layers, the RWKV-6 block and
model assembly (``init_params``, ``init_cache``, ``forward``, ``loss_fn``,
``decode_step``) for the dense (GQA and MLA), MoE and RWKV families."""

from repro_torch.models.config import ModelConfig, RWKVConfig
from repro_torch.models.convert import (
    cache_from_numpy,
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.models.model import (
    LM,
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    vocab_padded,
)

__all__ = ["LM", "ModelConfig", "RWKVConfig", "cache_from_numpy",
           "decode_step", "forward", "init_cache", "init_params", "loss_fn",
           "params_from_numpy", "params_to_numpy", "state_from_numpy",
           "state_to_numpy", "vocab_padded"]
