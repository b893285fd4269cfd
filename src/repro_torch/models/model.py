"""Model assembly of the port: init, the training/prefill ``forward``, the
next-token ``loss_fn`` and one-token ``decode_step`` for every family of
the reference: dense (GQA and MLA), MoE, RWKV, hybrid, encdec and vlm.

Layers run as a Python loop over a ``ModuleList`` (the reference scans
params stacked on a layer axis).  ``cfg.remat`` wraps each layer as the
reference's wraps its scan body: ``"full"`` recomputes the layer in the
backward (``torch.utils.checkpoint``), ``"dots"`` saves only the outputs of
matrix products without batch dimensions and recomputes the rest, and
``"none"`` saves everything; the three give equal losses and grads.  The
cache keeps the reference's stacked layout, a dict of tensors with a
leading layer axis, so a reference cache carries across
(``convert.cache_from_numpy``); ``decode_step`` updates it in place and
returns it.  Vocab tables are padded to a multiple of 128 and padded logit
columns pinned to -1e30, as in the reference, so they never win an argmax
nor enter the loss.

Families: dense (GQA attention, or MLA where ``cfg.mla`` is set), moe (the
same attention with the routed-expert FFN), rwkv, hybrid, encdec and vlm.
A moe layer's ``dropped_frac`` passes out of the remat wrapper beside the
hidden state, and ``forward``'s aux ``moe_dropped`` is its sum over the
layers, as the reference's scan sums it.  deepseek-v3's extras: ``cfg.first_k_dense``
leading dense layers (a SwiGLU at ``cfg.d_ff``) in ``dense_layers`` ahead
of the ``n_layers - first_k_dense`` main layers, and with ``cfg.mtp`` the
multi-token-prediction head (``mtp_proj`` and one dense ``mtp_layer``),
whose logits ``forward`` returns as aux ``mtp_logits`` and whose loss
``loss_fn`` adds at weight 0.3; the head is a training one and never
decodes.

hymba's hybrid layer runs attention and a Mamba branch (``ssm.py``) on the
same normed input and averages them; its cache holds ``{"attn", "mamba":
{"h", "conv"}}`` a layer.  seamless's encdec runs an ``encoder`` stack
(non-causal attention + SwiGLU) over ``frontend @ frontend_adapter``,
normed by ``enc_norm`` into the memory that each ``decoder_cross`` layer's
``xattn`` (a second GQA, after ``norm_x``) attends to, non-causally; the
cache adds ``memory`` (B, F, d), filled by ``prefill_encoder``, and every
decode step projects the memory's K and V again in every layer, as the
reference does (ROADMAP H15).  internvl's vlm prepends ``frontend @
frontend_adapter`` to the text and cuts that prefix off before the final
norm; its ``decode_step`` is text only, as the reference's ("prefix cache
semantics").  The Mamba scan, the cross-attention projections and the
prefix are plain torch on every device, as they are plain ``jnp`` in the
reference; every attention call, the encoder's and the cross-attention's
included, goes through ``attention_math``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

VOCAB_MULTIPLE = 128


def vocab_padded(cfg: ModelConfig) -> int:
    return -(-cfg.vocab // VOCAB_MULTIPLE) * VOCAB_MULTIPLE


MTP_WEIGHT = 0.3  # the MTP loss's weight in the total, as the reference's


def _main_kind(cfg: ModelConfig) -> str:
    """The kind of the main stack's layers: "dense" (GQA or MLA attention;
    also the vlm family's), "moe", "rwkv", "hybrid" or "decoder_cross"
    (encdec).  A ``first_k_dense`` stack and the MTP layer are "dense", an
    encoder stack "encoder"."""
    return {"rwkv": "rwkv", "hybrid": "hybrid", "moe": "moe",
            "encdec": "decoder_cross"}.get(cfg.family, "dense")


class Layer(nn.Module):
    """One block: ``norm1``/``norm2`` and either ``attn`` (GQA or MLA) +
    ``ffn`` (SwiGLU, or MoE in the moe family) or ``rwkv`` (time mix and
    channel mix); a hybrid layer adds ``mamba``, a decoder_cross layer
    ``norm_x`` and ``xattn`` (GQA over the encoder's memory)."""

    def __init__(self, norm1, norm2, *, attn=None, ffn=None, rwkv=None,
                 mamba=None, xattn=None, norm_x=None):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        self.norm_x = (None if norm_x is None
                       else nn.Parameter(norm_x, requires_grad=False))
        self.attn, self.ffn, self.rwkv = attn, ffn, rwkv
        self.mamba, self.xattn = mamba, xattn


class LM(nn.Module):
    """The params of one model: ``embed`` (V_pad, d), ``dense_layers`` (the
    ``first_k_dense`` stack, empty without one), ``layers``, ``final_norm``,
    unless the embeddings are tied ``unembed`` (d, V_pad), and with an MTP
    head ``mtp_layer`` (one dense ``Layer``) and ``mtp_proj`` (2d, d).  With
    a frontend (encdec, vlm) ``frontend_adapter`` (d, d); with an encoder
    (encdec) the ``encoder`` stack and ``enc_norm`` (d,)."""

    def __init__(self, embed, layers, final_norm, unembed=None, *,
                 dense_layers=(), mtp_layer=None, mtp_proj=None,
                 frontend_adapter=None, encoder=(), enc_norm=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.encoder = nn.ModuleList(encoder)
        self.dense_layers = nn.ModuleList(dense_layers)
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))
        self.mtp_layer = mtp_layer
        self.mtp_proj = (None if mtp_proj is None
                         else nn.Parameter(mtp_proj, requires_grad=False))
        self.frontend_adapter = (
            None if frontend_adapter is None
            else nn.Parameter(frontend_adapter, requires_grad=False))
        self.enc_norm = (None if enc_norm is None
                         else nn.Parameter(enc_norm, requires_grad=False))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _layer_init(generator, cfg: ModelConfig, kind: str, dtype) -> Layer:
    ones = L.zeros_init((cfg.d_model,), dtype, generator.device, 1.0)
    if kind == "rwkv":
        return Layer(ones, ones.clone(), rwkv=S.rwkv6_init(generator, cfg, dtype))
    attn_init = L.mla_init if cfg.mla is not None else L.gqa_init
    extra = {"attn": attn_init(generator, cfg, dtype)}
    if kind == "hybrid":
        extra["mamba"] = S.mamba_init(generator, cfg, dtype)
    if kind == "decoder_cross":
        extra["xattn"] = L.gqa_init(generator, cfg, dtype)
        extra["norm_x"] = ones.clone()
    extra["ffn"] = (L.moe_init(generator, cfg, dtype) if kind == "moe"
                    else L.swiglu_init(generator, cfg.d_model, cfg.d_ff,
                                       dtype))
    return Layer(ones, ones.clone(), **extra)


class _MetaGenerator(torch.Generator):
    """A generator whose draws land on ``meta``: shapes, no numbers."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device=None, dtype=torch.float32) -> LM:
    """Random params drawn from ``generator`` (seed 0 on ``device`` when
    None) in the reference's shapes and scales.  ``device=None`` means
    CUDA; on ``"meta"`` the params have shapes and dtypes only, and any
    ``generator`` is ignored (the planning tools, ``launch/dryrun.py``).
    The numbers differ from the reference's ``jax.random`` draws; tests
    carry reference params across with ``convert.params_from_numpy``."""
    kind = _main_kind(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = _MetaGenerator()
    elif generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    elif generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    vp = vocab_padded(cfg)
    embed = L.dense_init(generator, (vp, cfg.d_model), 1, dtype)
    front = {}
    if cfg.frontend != "none":
        front["frontend_adapter"] = L.dense_init(
            generator, (cfg.d_model, cfg.d_model), 0, dtype)
    if cfg.n_encoder_layers:
        front["encoder"] = [_layer_init(generator, cfg, "encoder", dtype)
                            for _ in range(cfg.n_encoder_layers)]
        front["enc_norm"] = L.zeros_init((cfg.d_model,), dtype,
                                         generator.device, 1.0)
    dense = [_layer_init(generator, cfg, "dense", dtype)
             for _ in range(cfg.first_k_dense)]
    layers = [_layer_init(generator, cfg, kind, dtype)
              for _ in range(cfg.n_layers - cfg.first_k_dense)]
    final_norm = L.zeros_init((cfg.d_model,), dtype, generator.device, 1.0)
    unembed = (None if cfg.tie_embeddings
               else L.dense_init(generator, (cfg.d_model, vp), 0, dtype))
    mtp = {}
    if cfg.mtp:
        mtp = dict(mtp_layer=_layer_init(generator, cfg, "dense", dtype),
                   mtp_proj=L.dense_init(generator, (2 * cfg.d_model,
                                                     cfg.d_model), 0, dtype))
    return LM(embed, layers, final_norm, unembed, dense_layers=dense, **mtp,
              **front)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None,
               enc_memory_len: int = 0) -> dict:
    """Zeroed decode cache, stacked on a leading layer axis as the
    reference's: GQA ``{"layers": {"attn": {"k", "v"}}}`` with k/v (L, B,
    Hkv, max_len, hd); MLA ``{"layers": {"attn": {"ckv", "k_rope"}}}`` with
    (L, B, max_len, kv_lora_rank) and (L, B, max_len, qk_rope_head_dim);
    RWKV ``{"layers": {"wkv", "tm_prev", "cm_prev"}}``; hybrid adds
    ``"mamba": {"h" (L, B, ED, n) float32, "conv" (L, B, W - 1, ED)}``
    beside ``"attn"``.  With a ``first_k_dense`` stack, ``"layers"`` holds
    the main stack's ``n_layers - first_k_dense`` and ``"dense_layers"`` the
    dense stack's (the same per-layer tree).  With an encoder, ``"memory"``
    (B, enc_memory_len, d), zeros until ``prefill_encoder`` fills it.
    ``device=None`` means CUDA."""
    kind = _main_kind(cfg)
    dev = resolve_device(device)
    if kind == "rwkv":
        one = S.rwkv6_state_init(cfg, batch, dtype, "meta")
    else:
        cache_init = (L.mla_cache_init if cfg.mla is not None
                      else L.gqa_cache_init)
        one = {"attn": cache_init(cfg, batch, max_len, dtype, "meta")}
        if kind == "hybrid":
            one["mamba"] = S.mamba_state_init(cfg, batch, dtype, "meta")

    def stacked(tree, n):
        if isinstance(tree, dict):
            return {name: stacked(t, n) for name, t in tree.items()}
        return torch.zeros((n, *tree.shape), dtype=tree.dtype, device=dev)

    out = {"layers": stacked(one, cfg.n_layers - cfg.first_k_dense)}
    if cfg.first_k_dense:
        out["dense_layers"] = stacked(one, cfg.first_k_dense)
    if cfg.n_encoder_layers:
        out["memory"] = torch.zeros((batch, enc_memory_len, cfg.d_model),
                                    dtype=dtype, device=dev)
    return out


def _stacked_specs(specs):
    """A layer's spec tree with the leading layer axis (never sharded)."""
    if isinstance(specs, dict):
        return {k: _stacked_specs(v) for k, v in specs.items()}
    return (None, *specs)


def _layer_specs(cfg: ModelConfig, kind: str) -> dict:
    """One ``kind`` layer's logical axes, named as ``_layer_init`` names its
    tensors (the reference's ``_layer_init`` spec tree)."""
    specs = {"norm1": (None,), "norm2": (None,)}
    if kind == "rwkv":
        return {**specs, "rwkv": dict(S.RWKV6.SPECS)}
    specs["attn"] = dict((L.MLA if cfg.mla is not None else L.GQA).SPECS)
    if kind == "hybrid":
        specs["mamba"] = dict(S.Mamba.SPECS)
    if kind == "decoder_cross":
        specs["xattn"] = dict(L.GQA.SPECS)
        specs["norm_x"] = (None,)
    if kind == "moe":
        mo = cfg.moe
        ffn = {k: v for k, v in L.MoE.SPECS.items()
               if k != "router_bias" or mo.router_aux_free_bias}
        if mo.n_shared:
            ffn["shared"] = dict(L.SwiGLU.SPECS)
        specs["ffn"] = ffn
    else:
        specs["ffn"] = dict(L.SwiGLU.SPECS)
    return specs


def param_specs(cfg: ModelConfig) -> dict:
    """The logical axes of every param, in the reference's stacked tree (the
    layout of ``convert.params_to_numpy``; a stacked leaf's layer axis is
    None): leaf for leaf the spec tree of the reference's ``init_params``."""
    specs = {"embed": ("vocab", "embed"), "final_norm": (None,)}
    if cfg.frontend != "none":
        specs["frontend_adapter"] = ("fsdp", None)
    if cfg.n_encoder_layers:
        specs["encoder"] = _stacked_specs(_layer_specs(cfg, "encoder"))
        specs["enc_norm"] = (None,)
    if cfg.first_k_dense:
        specs["dense_layers"] = _stacked_specs(_layer_specs(cfg, "dense"))
    specs["layers"] = _stacked_specs(_layer_specs(cfg, _main_kind(cfg)))
    if not cfg.tie_embeddings:
        specs["unembed"] = ("embed", "vocab")
    if cfg.mtp:
        specs["mtp_layer"] = _layer_specs(cfg, "dense")
        specs["mtp_proj"] = ("fsdp", None)
    return specs


def named_param_specs(cfg: ModelConfig) -> dict[str, tuple]:
    """``param_specs`` keyed like ``LM.named_parameters()``: one entry per
    layer of a stack (``"layers.3.attn.wq"``), without the layer axis."""
    depth = {"encoder": cfg.n_encoder_layers,
             "dense_layers": cfg.first_k_dense,
             "layers": cfg.n_layers - cfg.first_k_dense}
    out = {}

    def walk(tree, path, n):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,), n)
        elif n is None:
            out[".".join(path)] = tree
        else:
            for i in range(n):
                out[".".join((path[0], str(i)) + path[1:])] = tree[1:]

    for name, tree in param_specs(cfg).items():
        walk(tree, (name,), depth.get(name))
    return out


def cache_specs(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_cache``'s tree, leaf for leaf the spec tree
    of the reference's ``init_cache``."""
    kind = _main_kind(cfg)
    if kind == "rwkv":
        one = dict(S.RWKV6.STATE_SPECS)
    else:
        one = {"attn": dict((L.MLA if cfg.mla is not None
                             else L.GQA).CACHE_SPECS)}
        if kind == "hybrid":
            one["mamba"] = dict(S.Mamba.STATE_SPECS)
    out = {"layers": _stacked_specs(one)}
    if cfg.first_k_dense:
        out["dense_layers"] = _stacked_specs(one)
    if cfg.n_encoder_layers:
        out["memory"] = ("batch", None, None)
    return out


def _layer_cache(tree, i: int):
    """Layer ``i``'s views into the stacked cache (writes land in it)."""
    if isinstance(tree, dict):
        return {name: _layer_cache(t, i) for name, t in tree.items()}
    return tree[i]


def _layer_apply(layer: Layer, x, cfg: ModelConfig, kind: str, *, impl: str,
                 positions, cache=None, cache_pos=None, causal=True,
                 memory=None):
    """One block -> (x, dropped): ``dropped`` is the MoE FFN's
    ``dropped_frac`` (a 0-d float32 tensor), None in the other kinds.  A
    given layer cache is updated in place.  ``memory``: the encoder's
    output, which a decoder_cross layer attends to."""
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
        return x, None

    attn_apply = L.mla_apply if cfg.mla is not None else L.gqa_apply
    h = L.rms_norm(x, layer.norm1, cfg.norm_eps)
    a_out, _ = attn_apply(
        layer.attn, h, cfg, positions=positions,
        cache=cache["attn"] if cache else None, cache_pos=cache_pos,
        causal=causal, impl=impl)
    if kind == "hybrid":
        m_out, m_state = S.mamba_apply(
            layer.mamba, h, cfg, state=cache["mamba"] if cache else None)
        a_out = 0.5 * (a_out + m_out)  # hymba: fused parallel heads
        if cache is not None:
            cache["mamba"]["h"].copy_(m_state["h"])
            cache["mamba"]["conv"].copy_(m_state["conv"])
    x = x + a_out
    if kind == "decoder_cross":
        hx = L.rms_norm(x, layer.norm_x, cfg.norm_eps)
        # cross-attention: queries from the decoder, K/V from the memory
        x = x + _cross_attention(layer.xattn, hx, memory, impl)
    h2 = L.rms_norm(x, layer.norm2, cfg.norm_eps)
    if kind == "moe":
        f_out, aux = L.moe_apply(layer.ffn, h2, cfg)
        return x + f_out, aux["dropped_frac"]
    return x + L.swiglu_apply(layer.ffn, h2), None


def _cross_attention(p: L.GQA, xq, memory, impl: str) -> torch.Tensor:
    """GQA params reused for cross-attention: q from ``xq`` (B, Sq, d), K
    and V projected from ``memory`` (B, F, d) on every call (no rope), then
    non-causal attention over all F keys.  An empty memory (F 0: a cache
    made without ``enc_memory_len`` and never filled by
    ``prefill_encoder``) raises ``ValueError``, as the reference fails
    there, rather than attend to nothing."""
    if memory.shape[1] == 0:
        raise ValueError("cross-attention over an empty encoder memory: "
                         "make the cache with init_cache(enc_memory_len=F) "
                         "and fill it with prefill_encoder")
    q = torch.einsum("bsd,dhk->bhsk", xq, p.wq)
    k = torch.einsum("bsd,dhk->bhsk", memory, p.wk)
    v = torch.einsum("bsd,dhk->bhsk", memory, p.wv)
    out = L.attention_math(q, k, v, impl, causal=False, window=None)
    return torch.einsum("bhsk,hkd->bsd", out, p.wo)


def _embed(params: LM, tokens) -> torch.Tensor:
    """The rows of ``embed``; ``F.embedding``'s backward sums each row's
    gradient in a fixed order on the card, where ``index_put`` would not."""
    tokens = torch.as_tensor(tokens, device=params.device).long()
    return F.embedding(tokens, params.embed)


def _logits(params: LM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    vp = vocab_padded(cfg)
    w = params.embed.t() if cfg.tie_embeddings else params.unembed
    logits = (h @ w).float()
    if vp != cfg.vocab:
        neg = torch.full((vp,), -1e30, dtype=torch.float32, device=h.device)
        neg[: cfg.vocab] = 0.0
        logits = logits + neg
    return logits


def _saves_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep matrix products without batch dimensions (the
    reference's ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    unbatched = op is torch.ops.aten.mm.default or (
        op is torch.ops.aten.bmm.default and args[0].shape[0] == 1)
    return (ckpt.CheckpointPolicy.MUST_SAVE if unbatched
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _rematted(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat`` when grads are being taken."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "full":
        return ckpt.checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _saves_dots))
    raise ValueError(f"unknown remat {cfg.remat!r}; expected 'none', 'full' "
                     f"or 'dots'")


def _frontend(params: LM, frontend) -> torch.Tensor:
    """``frontend`` (B, F, d) stub embeddings, numpy or a tensor, through
    ``frontend_adapter``."""
    return torch.as_tensor(frontend, device=params.device) \
        @ params.frontend_adapter


def _encode(params: LM, cfg: ModelConfig, frontend, impl: str):
    """The encoder stack (non-causal, under ``cfg.remat``) over the adapted
    frames, then ``enc_norm``: the memory (B, F, d)."""
    m = _frontend(params, frontend)
    positions = torch.arange(m.shape[1], device=m.device)

    def layer_fn(layer, h):
        return _layer_apply(layer, h, cfg, "encoder", impl=impl,
                            positions=positions, causal=False)[0].to(h.dtype)

    for layer in params.encoder:
        m = _rematted(cfg, layer_fn, layer, m)
    return L.rms_norm(m, params.enc_norm, cfg.norm_eps)


def forward(params: LM, cfg: ModelConfig, tokens, *, frontend=None,
            last_only: bool = False, return_hidden: bool = False):
    """Training/prefill forward: tokens (B, S) -> (logits (B, S|1, V_pad)
    float32, aux), or with ``return_hidden`` the final-normed hidden state
    (B, S|1, d) in the logits' place (the chunked CE's input).  ``aux``:
    ``moe_dropped`` and, with an MTP head and neither ``last_only`` nor
    ``return_hidden``, ``mtp_logits`` (B, S, V_pad).  ``frontend`` (B, F,
    d): encdec's frames, which the encoder turns into the memory, or vlm's
    patches, prepended to the text (its logits cover the text positions
    only); both families need it.  Grads flow when grad mode is on and the
    params require them."""
    kind = _main_kind(cfg)
    impl = L.resolve_attn_impl(cfg)
    x = _embed(params, tokens)
    memory, n_prefix = None, 0
    if cfg.frontend != "none" and frontend is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs "
                         f"frontend embeddings")
    if cfg.n_encoder_layers:
        memory = _encode(params, cfg, frontend, impl)
    elif cfg.frontend != "none":
        prefix = _frontend(params, frontend)
        n_prefix = prefix.shape[1]
        x = torch.cat([prefix, x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)

    def layer_fn(layer_kind, layer, h, memory):
        out, dropped = _layer_apply(layer, h, cfg, layer_kind, impl=impl,
                                    positions=positions, memory=memory)
        return out.to(h.dtype), dropped

    dropped = []
    for layer_kind, stack in (("dense", params.dense_layers),
                              (kind, params.layers)):
        for layer in stack:
            x, layer_dropped = _rematted(cfg, layer_fn, layer_kind, layer, x,
                                         memory)
            if layer_dropped is not None:
                dropped.append(layer_dropped)
    if cfg.frontend == "vision":
        x = x[:, n_prefix:]  # text positions only
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    # the reference sums the scan's per-layer dropped_frac (0 without MoE)
    aux = {"moe_dropped": torch.stack(dropped).sum() if dropped else 0.0}
    if return_hidden:
        return h, aux
    if cfg.mtp and not last_only:  # MTP is a training-time head
        aux["mtp_logits"] = _logits(params, cfg, _mtp_hidden(
            params, cfg, h, tokens, impl, positions))
    return _logits(params, cfg, h), aux


def _mtp_hidden(params: LM, cfg: ModelConfig, h, tokens, impl, positions):
    """DeepSeek-style MTP trunk, predicting token t + 2 from the final-normed
    ``h_t`` and the embedding of token t + 1 (zero at the last position):
    ``[h; emb(t + 1)] @ mtp_proj``, one dense layer (no remat, as the
    reference's), then ``final_norm`` again."""
    emb = _embed(params, tokens)
    emb_next = torch.cat([emb[:, 1:], torch.zeros_like(emb[:, :1])], dim=1)
    mtp_in = torch.cat([h, emb_next], dim=-1) @ params.mtp_proj
    mtp_h, _ = _layer_apply(params.mtp_layer, mtp_in, cfg, "dense", impl=impl,
                            positions=positions)
    return L.rms_norm(mtp_h, params.final_norm, cfg.norm_eps)


def _shifted_labels(labels: torch.Tensor) -> torch.Tensor:
    """The MTP head's labels: each position's label one step on, the last
    position masked (-1)."""
    return torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], -1)],
                     dim=1)


def _masked_mean_nll(lse, gold, labels) -> torch.Tensor:
    mask = (labels >= 0).float()
    return ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)


def _ce_chunk(m_run, s_run, gold, h, w_c, lab, start: int, vocab: int):
    """One vocab chunk of the streamed CE: the running (max, sumexp, gold)
    updated with columns ``start .. start + w_c.shape[1]``."""
    vc = w_c.shape[1]
    lg = (h @ w_c).float()
    if start + vc > vocab:  # mask padded vocab columns
        col = start + torch.arange(vc, device=lg.device)
        lg = torch.where(col < vocab, lg, torch.full_like(lg, -1e30))
    m_new = torch.maximum(m_run, lg.amax(-1))
    s_run = s_run * torch.exp(m_run - m_new) + torch.exp(
        lg - m_new[..., None]).sum(-1)
    # gold logit if the label lands in this chunk
    in_chunk = (lab >= start) & (lab < start + vc)
    idx = (lab - start).clamp(0, vc - 1)
    g_c = lg.gather(-1, idx[..., None])[..., 0]
    return m_new, s_run, torch.where(in_chunk, g_c, gold)


def _chunked_ce(params: LM, cfg: ModelConfig, h: torch.Tensor, labels):
    """Streaming CE: the unembed in vocab chunks of ``cfg.ce_chunk`` with a
    running (max, sumexp, gold) triple, so the (B, S, V) logits never
    exist; each chunk is recomputed in the backward (the reference's
    ``@jax.checkpoint`` body).  Returns (lse, gold), each (B, S)."""
    vp = vocab_padded(cfg)
    w = params.embed.t() if cfg.tie_embeddings else params.unembed
    vc = cfg.ce_chunk
    if vp % vc:
        raise ValueError(f"ce_chunk {vc} does not divide the padded vocab {vp}")
    lab = labels.clamp_min(0)
    m = torch.full(labels.shape, -1e30, dtype=torch.float32, device=h.device)
    s_sum = torch.zeros(labels.shape, dtype=torch.float32, device=h.device)
    gold = torch.full(labels.shape, -1e30, dtype=torch.float32, device=h.device)
    for start in range(0, vp, vc):
        args = (m, s_sum, gold, h, w[:, start:start + vc], lab, start,
                cfg.vocab)
        m, s_sum, gold = (
            ckpt.checkpoint(_ce_chunk, *args, use_reentrant=False)
            if torch.is_grad_enabled() else _ce_chunk(*args))
    return m + torch.log(s_sum.clamp_min(1e-30)), gold


def _full_ce(logits: torch.Tensor, labels: torch.Tensor):
    """(lse, gold) of full logits, each (B, S)."""
    lse = torch.logsumexp(logits, dim=-1)
    return lse, logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]


def loss_fn(params: LM, cfg: ModelConfig, batch: dict):
    """Masked next-token CE over ``batch["tokens"]`` and ``batch["labels"]``
    (B, S), numpy or tensors, and ``batch["frontend"]`` for the encdec and
    vlm families; labels below 0 are masked out.  With an MTP
    head, its CE against the labels shifted by one (the last position
    masked) is added at weight 0.3, from the full MTP logits or, under
    ``ce_chunk``, streamed from its hidden state.  Returns (loss, metrics)
    with metrics ``{"loss", "moe_dropped"}`` and, with MTP, ``"mtp_loss"``."""
    labels = torch.as_tensor(batch["labels"], device=params.device).long()
    if cfg.ce_chunk:
        # run the trunk only (skip _logits), then stream the CE
        h, aux = forward(params, cfg, batch["tokens"],
                         frontend=batch.get("frontend"), return_hidden=True)
        lse, gold = _chunked_ce(params, cfg, h, labels)
        if cfg.mtp:
            positions = torch.arange(h.shape[1], device=h.device)
            mtp_h = _mtp_hidden(params, cfg, h, batch["tokens"],
                                L.resolve_attn_impl(cfg), positions)
            mtp_ce = _chunked_ce(params, cfg, mtp_h, _shifted_labels(labels))
    else:
        logits, aux = forward(params, cfg, batch["tokens"],
                              frontend=batch.get("frontend"))
        lse, gold = _full_ce(logits, labels)
        if cfg.mtp:
            mtp_ce = _full_ce(aux["mtp_logits"], _shifted_labels(labels))
    loss = _masked_mean_nll(lse, gold, labels)
    metrics = {"loss": loss, "moe_dropped": aux["moe_dropped"]}
    if cfg.mtp:
        mtp_loss = _masked_mean_nll(*mtp_ce, _shifted_labels(labels))
        loss = loss + MTP_WEIGHT * mtp_loss
        metrics.update(loss=loss, mtp_loss=mtp_loss)
    return loss, metrics


@torch.no_grad()
def prefill_encoder(params: LM, cfg: ModelConfig, frontend, cache: dict):
    """Enc-dec: run the encoder once over ``frontend`` (B, F, d) and return
    the cache with its ``memory`` replaced by the result (in the cache's
    dtype), as the reference's."""
    memory = _encode(params, cfg, frontend, L.resolve_attn_impl(cfg))
    return {**cache, "memory": memory.to(cache["memory"].dtype)}


@torch.no_grad()
def decode_step(params: LM, cfg: ModelConfig, cache: dict, tokens, pos):
    """One-token decode: tokens (B, 1), ``pos`` an int (the current length,
    shared by every row).  Returns (logits (B, 1, V_pad), cache), the cache
    updated in place: the ``first_k_dense`` stack's, then the main
    stack's.  An encdec decoder reads ``cache["memory"]``; a vlm decodes
    text only.  The MTP head does not decode."""
    kind = _main_kind(cfg)
    impl = L.resolve_attn_impl(cfg)
    pos = int(pos)
    x = _embed(params, tokens)
    positions = pos + torch.arange(x.shape[1], device=x.device)
    memory = cache.get("memory")
    for layer_kind, name, stack in (("dense", "dense_layers",
                                     params.dense_layers),
                                    (kind, "layers", params.layers)):
        for i, layer in enumerate(stack):
            x = _layer_apply(layer, x, cfg, layer_kind, impl=impl,
                             positions=positions,
                             cache=_layer_cache(cache[name], i),
                             cache_pos=pos, memory=memory)[0].to(x.dtype)
    h = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, cfg, h), cache
