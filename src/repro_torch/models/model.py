"""Model assembly of the port: init, prefill ``forward`` and one-token
``decode_step`` for the dense GQA and RWKV families.

Layers run as a Python loop over a ``ModuleList`` (the reference scans
params stacked on a layer axis).  The cache keeps the reference's stacked
layout, a dict of tensors with a leading layer axis, so a reference cache
carries across (``convert.cache_from_numpy``); ``decode_step`` updates it
in place and returns it.  Vocab tables are padded to a multiple of 128 and
padded logit columns pinned to -1e30, as in the reference, so they never
win an argmax.  The other families (moe, MLA, hybrid, encdec, vlm), the
loss and the MTP head are not ported yet (ROADMAP A12).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

VOCAB_MULTIPLE = 128


def vocab_padded(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_MULTIPLE) * VOCAB_MULTIPLE


def model_kind(cfg: ModelConfig) -> str:
    """"dense" or "rwkv"; another family raises, naming its ROADMAP item."""
    if cfg.family == "rwkv":
        return "rwkv"
    if cfg.family == "dense" and cfg.mla is None:
        return "dense"
    what = "MLA attention" if cfg.mla is not None else f"the {cfg.family} family"
    raise NotImplementedError(f"{cfg.name}: {what} is not ported yet "
                              f"(ROADMAP item A12)")


class Layer(nn.Module):
    """One block: ``norm1``/``norm2`` and either ``attn`` + ``ffn`` (dense)
    or ``rwkv`` (time mix and channel mix)."""

    def __init__(self, norm1, norm2, *, attn=None, ffn=None, rwkv=None):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        self.attn, self.ffn, self.rwkv = attn, ffn, rwkv


class LM(nn.Module):
    """The params of one model: ``embed`` (V_pad, d), ``layers``,
    ``final_norm`` and, unless the embeddings are tied, ``unembed``
    (d, V_pad)."""

    def __init__(self, embed, layers, final_norm, unembed=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _layer_init(generator, cfg: ModelConfig, kind: str, dtype) -> Layer:
    ones = L.zeros_init((cfg.d_model,), dtype, generator.device, 1.0)
    if kind == "rwkv":
        return Layer(ones, ones.clone(), rwkv=S.rwkv6_init(generator, cfg, dtype))
    return Layer(ones, ones.clone(), attn=L.gqa_init(generator, cfg, dtype),
                 ffn=L.swiglu_init(generator, cfg.d_model, cfg.d_ff, dtype))


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=torch.float32) -> LM:
    """Random params drawn from ``generator`` (seed 0 on ``device`` when
    None) in the reference's shapes and scales.  ``device=None`` means
    CUDA.  The numbers differ from the reference's ``jax.random`` draws;
    tests carry reference params across with ``convert.params_from_numpy``."""
    kind = model_kind(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    vp = vocab_padded(cfg)
    embed = L.dense_init(generator, (vp, cfg.d_model), 1, dtype)
    layers = [_layer_init(generator, cfg, kind, dtype)
              for _ in range(cfg.n_layers)]
    final_norm = L.zeros_init((cfg.d_model,), dtype, generator.device, 1.0)
    unembed = (None if cfg.tie_embeddings
               else L.dense_init(generator, (cfg.d_model, vp), 0, dtype))
    return LM(embed, layers, final_norm, unembed)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Zeroed decode cache, stacked on a leading layer axis as the
    reference's: dense ``{"layers": {"attn": {"k", "v"}}}`` with k/v (L, B,
    Hkv, max_len, hd); RWKV ``{"layers": {"wkv", "tm_prev", "cm_prev"}}``.
    ``device=None`` means CUDA."""
    kind = model_kind(cfg)
    dev = resolve_device(device)
    n = cfg.n_layers

    def stacked(t):
        return torch.zeros((n, *t.shape), dtype=t.dtype, device=dev)

    if kind == "rwkv":
        one = S.rwkv6_state_init(cfg, batch, dtype, "meta")
        return {"layers": {name: stacked(t) for name, t in one.items()}}
    one = L.gqa_cache_init(cfg, batch, max_len, dtype, "meta")
    return {"layers": {"attn": {name: stacked(t) for name, t in one.items()}}}


def _layer_cache(tree, i: int):
    """Layer ``i``'s views into the stacked cache (writes land in it)."""
    if isinstance(tree, dict):
        return {name: _layer_cache(t, i) for name, t in tree.items()}
    return tree[i]


def _layer_apply(layer: Layer, x, cfg: ModelConfig, kind: str, *, impl: str,
                 positions, cache=None, cache_pos=None):
    """One block; a given layer cache is updated in place."""
    if kind == "rwkv":
        b, d = x.shape[0], cfg.d_model
        hd = cfg.rwkv.head_dim
        h = L.rms_norm(x, layer.norm1, cfg.norm_eps)
        tm_out, wkv_state, tm_prev = S.rwkv6_time_mix(
            layer.rwkv, h, cfg,
            wkv_state=cache["wkv"] if cache else torch.zeros(
                (b, d // hd, hd, hd), dtype=torch.float32, device=x.device),
            x_prev=cache["tm_prev"] if cache else x.new_zeros((b, d)),
            impl=impl,
        )
        x = x + tm_out
        h2 = L.rms_norm(x, layer.norm2, cfg.norm_eps)
        cm_out, cm_prev = S.rwkv6_channel_mix(
            layer.rwkv, h2,
            x_prev=cache["cm_prev"] if cache else x.new_zeros((b, d)))
        x = x + cm_out
        if cache is not None:
            cache["wkv"].copy_(wkv_state)
            cache["tm_prev"].copy_(tm_prev)
            cache["cm_prev"].copy_(cm_prev)
        return x

    h = L.rms_norm(x, layer.norm1, cfg.norm_eps)
    a_out, _ = L.gqa_apply(
        layer.attn, h, cfg, positions=positions,
        cache=cache["attn"] if cache else None, cache_pos=cache_pos,
        causal=True, impl=impl)
    x = x + a_out
    h2 = L.rms_norm(x, layer.norm2, cfg.norm_eps)
    return x + L.swiglu_apply(layer.ffn, h2)


def _embed(params: LM, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=params.device).long()
    return params.embed[tokens]


def _logits(params: LM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    vp = vocab_padded(cfg)
    w = params.embed.t() if cfg.tie_embeddings else params.unembed
    logits = (h @ w).float()
    if vp != cfg.vocab:
        neg = torch.full((vp,), -1e30, dtype=torch.float32, device=h.device)
        neg[: cfg.vocab] = 0.0
        logits = logits + neg
    return logits


@torch.no_grad()
def forward(params: LM, cfg: ModelConfig, tokens, *, last_only: bool = False):
    """Prefill forward, inference only: tokens (B, S) -> (logits (B, S|1,
    V_pad) float32, aux).  No loss and no MTP head yet (ROADMAP A12)."""
    kind = model_kind(cfg)
    impl = L.resolve_attn_impl(cfg)
    x = _embed(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for layer in params.layers:
        x = _layer_apply(layer, x, cfg, kind, impl=impl,
                         positions=positions).to(x.dtype)
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    return _logits(params, cfg, h), {"moe_dropped": 0.0}


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, cache: dict, tokens, pos):
    """One-token decode: tokens (B, 1), ``pos`` an int (the current length,
    shared by every row).  Returns (logits (B, 1, V_pad), cache), the cache
    updated in place."""
    kind = model_kind(cfg)
    impl = L.resolve_attn_impl(cfg)
    pos = int(pos)
    x = _embed(params, tokens)
    positions = pos + torch.arange(x.shape[1], device=x.device)
    for i, layer in enumerate(params.layers):
        x = _layer_apply(layer, x, cfg, kind, impl=impl, positions=positions,
                         cache=_layer_cache(cache["layers"], i),
                         cache_pos=pos).to(x.dtype)
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h), cache
