"""Gradient utilities over dicts of tensors keyed like the params:
global-norm clipping and per-tensor int8 gradient compression.

Compression is symmetric per tensor: ``round(x / scale)`` clipped to
[-127, 127] with ``scale = max(|x|) / 127``, decompressed as ``q * scale``
(``torch.round`` rounds half to even, as ``jnp.round`` does, so the
integers equal the reference's).  The trainer applies it before the
update, where a data-parallel all-reduce would carry a quarter of the
bytes.
"""

from __future__ import annotations

import torch


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The factor that brings a global norm down to ``max_norm`` (1 when
    it is already within)."""
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)


def clip_by_global_norm(tree: dict, max_norm: float):
    """(the tree scaled to at most ``max_norm``, its norm before)."""
    norm = global_norm(tree)
    scale = clip_scale(norm, max_norm)
    return {k: (x * scale).to(x.dtype) for k, x in tree.items()}, norm


def compress_int8(tree: dict, groups=None):
    """Per-tensor symmetric int8: returns (q_tree, scale_tree).  ``groups``
    lists names that share one scale, as the layers of one stacked leaf do
    in the reference (``models.convert.stacked_groups``); by default each
    name has its own."""
    q_tree, scale_tree = {}, {}
    for names in groups if groups is not None else [[n] for n in tree]:
        amax = torch.stack([tree[n].float().abs().max() for n in names]).max()
        scale = torch.clamp_min(amax, 1e-12) / 127.0
        for name in names:
            q_tree[name] = torch.clamp(torch.round(tree[name].float() / scale),
                                       -127, 127).to(torch.int8)
            scale_tree[name] = scale
    return q_tree, scale_tree


def decompress_int8(q_tree: dict, scale_tree: dict, like_tree: dict) -> dict:
    return {name: (q_tree[name].float() * scale_tree[name]).to(x.dtype)
            for name, x in like_tree.items()}
