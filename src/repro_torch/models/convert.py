"""Carry the reference's params and caches into the port.

The reference keeps params as a pytree with the layer weights stacked on a
leading axis (``tree["layers"]["attn"]["wq"]`` is (L, d, h, hd)); the port
keeps one module per layer in the same per-layer layout.  Both functions
take the tree with numpy (or array-like) leaves, e.g.
``jax.tree.map(np.asarray, params)``, and copy it to ``device`` (None means
CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import GQA, SwiGLU
from repro_torch.models.model import LM, Layer, model_kind
from repro_torch.models.ssm import RWKV6

_LAYER_KEYS = {"dense": {"norm1", "norm2", "attn", "ffn"},
               "rwkv": {"norm1", "norm2", "rwkv"}}


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=dev)


def _module(cls, tree: dict, i: int, dev):
    return cls(**{name: _tensor(tree[name][i], dev) for name in cls.NAMES})


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """The reference's ``init_params`` tree -> the port's ``LM``."""
    kind = model_kind(cfg)
    dev = resolve_device(device)
    top = {"embed", "layers", "final_norm"} | (
        set() if cfg.tie_embeddings else {"unembed"})
    if set(tree) != top or set(tree["layers"]) != _LAYER_KEYS[kind]:
        raise ValueError(f"{cfg.name}: expected keys {sorted(top)} with layer "
                         f"keys {sorted(_LAYER_KEYS[kind])}, got {sorted(tree)} "
                         f"and {sorted(tree.get('layers', {}))}")
    lt = tree["layers"]
    layers = []
    for i in range(cfg.n_layers):
        norms = _tensor(lt["norm1"][i], dev), _tensor(lt["norm2"][i], dev)
        if kind == "rwkv":
            layers.append(Layer(*norms, rwkv=_module(RWKV6, lt["rwkv"], i, dev)))
        else:
            layers.append(Layer(*norms, attn=_module(GQA, lt["attn"], i, dev),
                                ffn=_module(SwiGLU, lt["ffn"], i, dev)))
    return LM(_tensor(tree["embed"], dev), layers,
              _tensor(tree["final_norm"], dev),
              None if cfg.tie_embeddings else _tensor(tree["unembed"], dev))


def cache_from_numpy(tree, device=None):
    """The reference's ``init_cache`` tree (or one a decode returned) -> the
    port's cache: the same nested dict, each leaf a tensor."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {name: cache_from_numpy(t, dev) for name, t in tree.items()}
    return _tensor(tree, dev)
