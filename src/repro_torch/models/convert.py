"""Carry params, optimizer state and caches between the reference's layout
and the port's.

The reference keeps params as a pytree with the layer weights stacked on a
leading axis (``tree["layers"]["attn"]["wq"]`` is (L, d, h, hd)); the port
keeps one module per layer in the same per-layer layout, named as
``LM.named_parameters()`` names them (``"layers.3.attn.wq"``).  The
``*_from_numpy`` functions take the tree with numpy (or array-like)
leaves, e.g. ``jax.tree.map(np.asarray, params)``, and copy it to
``device`` (None means CUDA); the ``*_to_numpy`` functions give that tree
back with numpy leaves, which is what a checkpoint stores.  ``state_*``
carry any dict keyed like the params (the optimizer's ``m`` and ``v``),
whose leaves may be tensors or tuples of tensors (a factored second
moment's (row, col) statistics, each stacked on the layer axis as the
reference's are).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import GQA, MLA, MoE, SwiGLU
from repro_torch.models.model import LM, Layer, model_kind
from repro_torch.models.ssm import RWKV6

_LAYER_KEYS = {"dense": {"norm1", "norm2", "attn", "ffn"},
               "moe": {"norm1", "norm2", "attn", "ffn"},
               "rwkv": {"norm1", "norm2", "rwkv"}}


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=dev)


def _module(cls, tree: dict, i: int, dev):
    return cls(**{name: _tensor(tree[name][i], dev) for name in cls.NAMES})


def _moe(cfg: ModelConfig, tree: dict, i: int, dev) -> MoE:
    """Layer ``i``'s MoE FFN; ``router_bias`` and the ``shared`` SwiGLU are
    there exactly when the config asks for them."""
    mo = cfg.moe
    want = set(MoE.NAMES) | ({"router_bias"} if mo.router_aux_free_bias
                             else set()) | ({"shared"} if mo.n_shared else set())
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: expected ffn keys {sorted(want)}, got "
                         f"{sorted(tree)}")
    return MoE(**{name: _tensor(tree[name][i], dev) for name in MoE.NAMES},
               router_bias=(_tensor(tree["router_bias"][i], dev)
                            if mo.router_aux_free_bias else None),
               shared=(_module(SwiGLU, tree["shared"], i, dev)
                       if mo.n_shared else None))


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """The reference's ``init_params`` tree -> the port's ``LM`` (a moe
    layer's ``ffn`` holds the nested ``shared`` tree and the optional
    ``router_bias``)."""
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
            attn = _module(MLA if cfg.mla is not None else GQA, lt["attn"], i,
                           dev)
            ffn = (_moe(cfg, lt["ffn"], i, dev) if kind == "moe"
                   else _module(SwiGLU, lt["ffn"], i, dev))
            layers.append(Layer(*norms, attn=attn, ffn=ffn))
    return LM(_tensor(tree["embed"], dev), layers,
              _tensor(tree["final_norm"], dev),
              None if cfg.tie_embeddings else _tensor(tree["unembed"], dev))


def cache_from_numpy(tree, device=None):
    """The reference's ``init_cache`` tree (or one a decode returned) -> the
    port's cache: the same nested dict (GQA's k/v, MLA's ckv/k_rope or
    RWKV's states), each leaf a tensor."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {name: cache_from_numpy(t, dev) for name, t in tree.items()}
    return _tensor(tree, dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def state_to_numpy(cfg: ModelConfig, named: dict) -> dict:
    """A dict keyed like the params -> the reference's stacked tree, numpy
    leaves; a tuple leaf stays a tuple of stacked arrays."""
    tree: dict = {}
    stacks: dict = {}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] != "layers":
            tree[name] = (tuple(_host(x) for x in leaf)
                          if isinstance(leaf, tuple) else _host(leaf))
            continue
        stacks.setdefault(tuple(parts[2:]), {})[int(parts[1])] = leaf
    for path, by_layer in stacks.items():
        if sorted(by_layer) != list(range(cfg.n_layers)):
            raise ValueError(f"{cfg.name}: layers {sorted(by_layer)} of "
                             f"{'.'.join(path)}, expected {cfg.n_layers}")
        leaves = [by_layer[i] for i in range(cfg.n_layers)]
        node = tree.setdefault("layers", {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = (
            tuple(np.stack([_host(x) for x in part]) for part in zip(*leaves))
            if isinstance(leaves[0], tuple)
            else np.stack([_host(x) for x in leaves]))
    return tree


def state_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The inverse of ``state_to_numpy``: the reference's stacked tree ->
    a dict keyed like the params (``LM.named_parameters()`` order)."""
    dev = resolve_device(device)

    def leaf(a, i=None):
        if isinstance(a, tuple):
            return tuple(leaf(x, i) for x in a)
        return _tensor(a if i is None else np.asarray(a)[i], dev)

    def layer_items(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                yield from layer_items(node[key], prefix + (key,))
            else:
                yield prefix + (key,), node[key]

    layer_leaves = dict(layer_items(tree["layers"], ()))
    named = {"embed": leaf(tree["embed"]),
             "final_norm": leaf(tree["final_norm"])}
    if not cfg.tie_embeddings:
        named["unembed"] = leaf(tree["unembed"])
    for i in range(cfg.n_layers):
        for path in _layer_names(cfg):
            named[".".join(("layers", str(i)) + path)] = leaf(
                layer_leaves[path], i)
    return named


def _layer_names(cfg: ModelConfig) -> list[tuple[str, ...]]:
    """One layer's parameter paths in ``named_parameters`` order."""
    kind = model_kind(cfg)
    norms = [("norm1",), ("norm2",)]
    if kind == "rwkv":
        return norms + [("rwkv", n) for n in RWKV6.NAMES]
    attn = MLA.NAMES if cfg.mla is not None else GQA.NAMES
    names = norms + [("attn", n) for n in attn]
    if kind != "moe":
        return names + [("ffn", n) for n in SwiGLU.NAMES]
    names += [("ffn", n) for n in MoE.NAMES]
    if cfg.moe.router_aux_free_bias:
        names.append(("ffn", "router_bias"))
    if cfg.moe.n_shared:
        names += [("ffn", "shared", n) for n in SwiGLU.NAMES]
    return names


def params_to_numpy(cfg: ModelConfig, lm: LM) -> dict:
    """The port's ``LM`` -> the reference's ``init_params`` tree (stacked,
    numpy leaves); the inverse of ``params_from_numpy``."""
    return state_to_numpy(cfg, dict(lm.named_parameters()))


def stacked_groups(names) -> list[list[str]]:
    """Param names grouped by the reference's stacked leaf they slice
    (``"layers.0.attn.wq"`` and ``"layers.1.attn.wq"`` together), in first
    appearance order: what a per-tensor statistic of the reference spans."""
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        key = ".".join(parts[:1] + parts[2:]) if parts[0] == "layers" else name
        groups.setdefault(key, []).append(name)
    return list(groups.values())
