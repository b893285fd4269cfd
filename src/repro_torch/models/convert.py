"""Carry params, optimizer state and caches between the reference's layout
and the port's.

The reference keeps params as a pytree with the layer weights stacked on a
leading axis (``tree["layers"]["attn"]["wq"]`` is (L, d, h, hd)); the port
keeps one module per layer in the same per-layer layout, named as
``LM.named_parameters()`` names them (``"layers.3.attn.wq"``).  Three
stacks are stacked so: ``layers``, with ``first_k_dense`` ``dense_layers``
(``"dense_layers.0.ffn.w_gate"``) and with an encoder ``encoder``
(``"encoder.0.attn.wq"``); the MTP head's one layer, ``mtp_layer``, is an
unstacked subtree in both (``"mtp_layer.attn.wq"`` is
``tree["mtp_layer"]["attn"]["wq"]``), beside the top-level ``mtp_proj``.
A hybrid layer holds ``mamba``, a decoder_cross layer ``xattn`` and
``norm_x``; ``frontend_adapter`` and ``enc_norm`` are top-level.  The
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
from repro_torch.models.model import LM, Layer, _main_kind
from repro_torch.models.ssm import RWKV6, Mamba

_LAYER_KEYS = {"dense": {"norm1", "norm2", "attn", "ffn"},
               "moe": {"norm1", "norm2", "attn", "ffn"},
               "rwkv": {"norm1", "norm2", "rwkv"},
               "hybrid": {"norm1", "norm2", "attn", "mamba", "ffn"},
               "encoder": {"norm1", "norm2", "attn", "ffn"},
               "decoder_cross": {"norm1", "norm2", "norm_x", "attn", "xattn",
                                 "ffn"}}


def _stacks(cfg: ModelConfig) -> dict[str, tuple[str, int]]:
    """The stacked layer trees, in ``named_parameters`` order: name ->
    (layer kind, depth)."""
    out = {}
    if cfg.n_encoder_layers:
        out["encoder"] = ("encoder", cfg.n_encoder_layers)
    if cfg.first_k_dense:
        out["dense_layers"] = ("dense", cfg.first_k_dense)
    out["layers"] = (_main_kind(cfg), cfg.n_layers - cfg.first_k_dense)
    return out


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), device=dev)


def _at(a, i):
    """Layer ``i`` of a stacked leaf, or the leaf itself when ``i`` is None
    (an unstacked layer tree)."""
    return a if i is None else a[i]


def _module(cls, tree: dict, i, dev):
    return cls(**{name: _tensor(_at(tree[name], i), dev) for name in cls.NAMES})


def _moe(cfg: ModelConfig, tree: dict, i, dev) -> MoE:
    """Layer ``i``'s MoE FFN; ``router_bias`` and the ``shared`` SwiGLU are
    there exactly when the config asks for them."""
    mo = cfg.moe
    want = set(MoE.NAMES) | ({"router_bias"} if mo.router_aux_free_bias
                             else set()) | ({"shared"} if mo.n_shared else set())
    if set(tree) != want:
        raise ValueError(f"{cfg.name}: expected ffn keys {sorted(want)}, got "
                         f"{sorted(tree)}")
    return MoE(**{name: _tensor(_at(tree[name], i), dev) for name in MoE.NAMES},
               router_bias=(_tensor(_at(tree["router_bias"], i), dev)
                            if mo.router_aux_free_bias else None),
               shared=(_module(SwiGLU, tree["shared"], i, dev)
                       if mo.n_shared else None))


def _layer(cfg: ModelConfig, kind: str, lt: dict, i, dev, where: str) -> Layer:
    """One ``Layer`` of ``kind`` from the layer tree ``lt`` (layer ``i`` of
    a stack, or the whole tree when ``i`` is None)."""
    if set(lt) != _LAYER_KEYS[kind]:
        raise ValueError(f"{cfg.name}: expected {where} keys "
                         f"{sorted(_LAYER_KEYS[kind])}, got {sorted(lt)}")
    norms = _tensor(_at(lt["norm1"], i), dev), _tensor(_at(lt["norm2"], i), dev)
    if kind == "rwkv":
        return Layer(*norms, rwkv=_module(RWKV6, lt["rwkv"], i, dev))
    extra = {}
    if kind == "hybrid":
        extra["mamba"] = _module(Mamba, lt["mamba"], i, dev)
    if kind == "decoder_cross":
        extra["xattn"] = _module(GQA, lt["xattn"], i, dev)
        extra["norm_x"] = _tensor(_at(lt["norm_x"], i), dev)
    attn = _module(MLA if cfg.mla is not None else GQA, lt["attn"], i, dev)
    ffn = (_moe(cfg, lt["ffn"], i, dev) if kind == "moe"
           else _module(SwiGLU, lt["ffn"], i, dev))
    return Layer(*norms, attn=attn, ffn=ffn, **extra)


def _top_params(cfg: ModelConfig) -> list[str]:
    """The LM's own (unstacked) tensors, in ``named_parameters`` order."""
    return (["embed", "final_norm"]
            + ([] if cfg.tie_embeddings else ["unembed"])
            + (["mtp_proj"] if cfg.mtp else [])
            + (["frontend_adapter"] if cfg.frontend != "none" else [])
            + (["enc_norm"] if cfg.n_encoder_layers else []))


def _top_keys(cfg: ModelConfig) -> set:
    return (set(_top_params(cfg)) | set(_stacks(cfg))
            | ({"mtp_layer"} if cfg.mtp else set()))


def params_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> LM:
    """The reference's ``init_params`` tree -> the port's ``LM`` (a moe
    layer's ``ffn`` holds the nested ``shared`` tree and the optional
    ``router_bias``; deepseek-v3's ``dense_layers``, ``mtp_layer`` and
    ``mtp_proj``, and the ``encoder`` stack, ``enc_norm`` and
    ``frontend_adapter`` come across beside ``layers``)."""
    dev = resolve_device(device)
    top = _top_keys(cfg)
    if set(tree) != top:
        raise ValueError(f"{cfg.name}: expected keys {sorted(top)}, got "
                         f"{sorted(tree)}")
    stacks = {name: [_layer(cfg, kind, tree[name], i, dev, name)
                     for i in range(n)]
              for name, (kind, n) in _stacks(cfg).items()}
    mtp = {}
    if cfg.mtp:
        mtp = dict(mtp_layer=_layer(cfg, "dense", tree["mtp_layer"], None, dev,
                                    "mtp_layer"),
                   mtp_proj=_tensor(tree["mtp_proj"], dev))
    front = {name: _tensor(tree[name], dev)
             for name in ("frontend_adapter", "enc_norm") if name in top}
    return LM(_tensor(tree["embed"], dev), stacks["layers"],
              _tensor(tree["final_norm"], dev),
              None if cfg.tie_embeddings else _tensor(tree["unembed"], dev),
              dense_layers=stacks.get("dense_layers", ()),
              encoder=stacks.get("encoder", ()), **mtp, **front)


def cache_from_numpy(tree, device=None):
    """The reference's ``init_cache`` tree (or one a decode returned) -> the
    port's cache: the same nested dict (GQA's k/v, MLA's ckv/k_rope, RWKV's
    states or hybrid's attn + mamba, under ``layers`` and, with a
    first_k_dense stack, ``dense_layers``; an encdec's ``memory``), each
    leaf a tensor."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {name: cache_from_numpy(t, dev) for name, t in tree.items()}
    return _tensor(tree, dev)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _host_leaf(leaf):
    return tuple(_host(x) for x in leaf) if isinstance(leaf, tuple) \
        else _host(leaf)


def _nest(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def state_to_numpy(cfg: ModelConfig, named: dict) -> dict:
    """A dict keyed like the params -> the reference's tree, numpy leaves:
    the layers of each stack stacked, ``mtp_layer`` nested unstacked; a
    tuple leaf stays a tuple of (stacked) arrays."""
    tree: dict = {}
    stacks: dict = {}
    depth = {name: n for name, (_, n) in _stacks(cfg).items()}
    for name, leaf in named.items():
        parts = name.split(".")
        if parts[0] in depth:
            stacks.setdefault((parts[0], tuple(parts[2:])), {})[
                int(parts[1])] = leaf
        else:
            _nest(tree, parts, _host_leaf(leaf))
    for (stack, path), by_layer in stacks.items():
        if sorted(by_layer) != list(range(depth[stack])):
            raise ValueError(f"{cfg.name}: {stack} {sorted(by_layer)} of "
                             f"{'.'.join(path)}, expected {depth[stack]}")
        leaves = [by_layer[i] for i in range(depth[stack])]
        _nest(tree, (stack,) + path, (
            tuple(np.stack([_host(x) for x in part]) for part in zip(*leaves))
            if isinstance(leaves[0], tuple)
            else np.stack([_host(x) for x in leaves])))
    return tree


def state_from_numpy(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The inverse of ``state_to_numpy``: the reference's tree -> a dict
    keyed like the params (``LM.named_parameters()`` order)."""
    dev = resolve_device(device)

    def leaf(a, i=None):
        if isinstance(a, tuple):
            return tuple(leaf(x, i) for x in a)
        return _tensor(a if i is None else np.asarray(a)[i], dev)

    def layer_leaf(node, path):
        for key in path:
            node = node[key]
        return node

    # the LM's own tensors first, then its modules, as named_parameters
    named = {name: leaf(tree[name]) for name in _top_params(cfg)}
    for stack, (kind, n) in _stacks(cfg).items():
        for i in range(n):
            for path in _layer_names(cfg, kind):
                named[".".join((stack, str(i)) + path)] = leaf(
                    layer_leaf(tree[stack], path), i)
    if cfg.mtp:
        for path in _layer_names(cfg, "dense"):
            named[".".join(("mtp_layer",) + path)] = leaf(
                layer_leaf(tree["mtp_layer"], path))
    return named


def _layer_names(cfg: ModelConfig, kind: str) -> list[tuple[str, ...]]:
    """One ``kind`` layer's parameter paths in ``named_parameters`` order."""
    norms = [("norm1",), ("norm2",)]
    if kind == "rwkv":
        return norms + [("rwkv", n) for n in RWKV6.NAMES]
    if kind == "decoder_cross":
        norms.append(("norm_x",))
    attn = MLA.NAMES if cfg.mla is not None else GQA.NAMES
    names = norms + [("attn", n) for n in attn]
    if kind != "moe":
        names += [("ffn", n) for n in SwiGLU.NAMES]
        if kind == "hybrid":
            names += [("mamba", n) for n in Mamba.NAMES]
        if kind == "decoder_cross":
            names += [("xattn", n) for n in GQA.NAMES]
        return names
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


STACKED = ("layers", "dense_layers", "encoder")


def stacked_groups(names) -> list[list[str]]:
    """Param names grouped by the reference's stacked leaf they slice
    (``"layers.0.attn.wq"`` and ``"layers.1.attn.wq"`` together, and so
    for ``dense_layers`` and ``encoder``), in first appearance order: what a per-tensor
    statistic of the reference spans.  Every other name, ``mtp_layer``'s
    unstacked leaves too, is a group of its own."""
    groups: dict = {}
    for name in names:
        parts = name.split(".")
        key = ".".join(parts[:1] + parts[2:]) if parts[0] in STACKED else name
        groups.setdefault(key, []).append(name)
    return list(groups.values())
