"""Model layers of the port: init helpers, norms, RoPE, attention maths, the
GQA and MLA attention layers, the SwiGLU MLP and the MoE FFN.

Weights keep the reference's layouts (``wq`` (d, h, hd), ``wo`` (h, hd, d),
``w_gate`` (d, d_ff), ...), so a reference param tree carries across
without transposes (``models/convert.py``).  Layers with weights are
``nn.Module``s whose parameters carry the reference's names; the maths are
plain functions on tensors that take such a module as ``p``.  Parameters
are made with ``requires_grad=False``, so serving builds no graph; a
trainer turns grads on with ``params.requires_grad_(True)``, and every
function here, the kernels included, then passes them through.

Attention maths (``attention_math``), by the config's ``attn_impl``:
  * ``auto`` / ``kernel`` — ``kernels/flash_attention``: the CUDA kernel on
    a CUDA tensor, its plain version on a CPU tensor;
  * ``ref``               — the plain version on any device (tests);
  * ``xla_flash``         — ``xla_flash_attention``, the reference's
    blocked online softmax (a ``lax.scan`` over KV blocks there, a Python
    loop here) in plain torch on whatever device the tensors are on.

MLA's naive path and its prefill go through ``attention_math`` (q and k
qk_nope + qk_rope wide, V at v_head_dim); its absorbed decode and the
MoE dispatch are plain torch, as they are plain ``jnp`` in the reference,
which has no Pallas kernel for either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.models.config import ModelConfig

IMPLS = ("auto", "kernel", "ref", "xla_flash")


class ParamModule(nn.Module):
    """A layer's weights: one ``nn.Parameter`` per name in ``NAMES``, each
    with the logical axes of ``SPECS`` (``models/sharding.py``)."""

    NAMES: tuple[str, ...] = ()
    SPECS: dict[str, tuple] = {}

    def __init__(self, **tensors: torch.Tensor):
        super().__init__()
        if set(tensors) != set(self.NAMES):
            raise ValueError(f"{type(self).__name__} takes {self.NAMES}, got "
                             f"{tuple(sorted(tensors))}")
        for name in self.NAMES:
            self.register_parameter(
                name, nn.Parameter(tensors[name], requires_grad=False))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis: Optional[int] = 0,
               dtype=torch.float32) -> torch.Tensor:
    """Normal / sqrt(fan_in) on the generator's device (fan_in = 1 when
    ``in_axis`` is None), as the reference's ``dense_init``."""
    fan_in = shape[in_axis] if in_axis is not None else 1
    w = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32)
    return w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dtype)


def zeros_init(shape, dtype=torch.float32, device=None,
               fill: float = 0.0) -> torch.Tensor:
    """A constant tensor: zeros, or ``fill`` (the norms' ones)."""
    return torch.full(shape, fill, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# norms + rope
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """The reference's ``layer_norm``: mean and (biased) variance in
    float32.  Exported as the reference's is; no model path calls it (the
    encoder normalises with ``rms_norm``)."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """x: (..., S, D) with D even; positions (S,) or (..., S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention maths
# ---------------------------------------------------------------------------


def xla_flash_attention(q, k, v, *, causal: bool = True, window=None,
                        q_offset: int = 0, kv_len=None,
                        block_k: int = 512) -> torch.Tensor:
    """The reference's ``xla_flash_attention``: a streaming softmax over KV
    blocks of ``block_k`` keys, (B, Hq, Sq, D) x (B, Hkv, Skv, D) x (B, Hkv,
    Skv, Dv) -> (B, Hq, Sq, Dv) in q's dtype, Dv <= D.

    GQA reshapes q to (B, Hkv, G, Sq, D), so K and V are never repeated;
    scores, the running max and sum and the accumulator are float32; masked
    scores are -1e30; Skv is padded with zero keys to a multiple of the
    block (and ``kv_len`` then defaults to Skv, so the pad stays masked).
    A masked key gets weight 0, so a row that sees no key comes out 0, as
    the kernel's and ``mha_plain``'s do; the reference's ``xla_flash``
    gives such a row the mean of V instead.  No model path has such a row
    (ROADMAP C12)."""
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if skv == 0:
        return q.new_zeros((b, hq, sq, dv))
    g = hq // hkv
    qr = q.reshape(b, hkv, g, sq, d).float() * (1.0 / math.sqrt(d))
    bk = min(block_k, skv)
    pad = (-skv) % bk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        if kv_len is None:
            kv_len = skv
    q_pos = torch.arange(sq, device=q.device) + q_offset
    m_run = torch.full((b, hkv, g, sq), -1e30, dtype=torch.float32,
                       device=q.device)
    l_run = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, skv + pad, bk):
        s = torch.einsum("bkgqd,bkcd->bkgqc", qr, k[:, :, lo:lo + bk].float())
        k_pos = lo + torch.arange(bk, device=q.device)
        mask = torch.ones((sq, bk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        if kv_len is not None:
            mask &= k_pos[None, :] < kv_len
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l_run = l_run * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqc,bkcd->bkgqd", p, v[:, :, lo:lo + bk].float())
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def attention_math(q, k, v, impl: str, *, causal: bool = True, window=None,
                   q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) x (B, Hkv, Skv, Dv) -> (B, Hq, Sq,
    Dv), Dv <= D.  Unlike the reference's kernel branch (ROADMAP C7),
    ``kv_len`` reaches every impl."""
    if impl in ("auto", "kernel"):
        return flash_ops.flash_attention(q, k, v, causal, window, q_offset,
                                         kv_len)
    if impl == "ref":
        return flash_ref.mha_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    if impl == "xla_flash":
        return xla_flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    raise impl_error(impl)


def impl_error(impl: str) -> ValueError:
    return ValueError(f"unknown attn_impl {impl!r}; expected one of {IMPLS}")


def resolve_attn_impl(cfg: ModelConfig) -> str:
    """``auto`` means the kernel (which runs its plain version on a CPU
    tensor), on every device; the reference's ``auto`` takes ``xla_flash``
    off a TPU (ROADMAP C11)."""
    if cfg.attn_impl not in IMPLS:
        raise impl_error(cfg.attn_impl)
    return "kernel" if cfg.attn_impl == "auto" else cfg.attn_impl


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


class GQA(ParamModule):
    NAMES = ("wq", "wk", "wv", "wo")
    SPECS = {"wq": ("fsdp", "heads", None), "wk": ("fsdp", "kv_heads", None),
             "wv": ("fsdp", "kv_heads", None), "wo": ("heads", None, "fsdp")}
    # the decode cache's k and v, (B, Hkv, S_max, hd)
    CACHE_SPECS = {"k": ("batch", "kv_heads", "kv_seq", None),
                   "v": ("batch", "kv_heads", "kv_seq", None)}


def gqa_init(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> GQA:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return GQA(
        wq=dense_init(generator, (d, h, hd), 0, dtype),
        wk=dense_init(generator, (d, hkv, hd), 0, dtype),
        wv=dense_init(generator, (d, hkv, hd), 0, dtype),
        wo=dense_init(generator, (h, hd, d), None, dtype) / math.sqrt(h * hd),
    )


def gqa_apply(p: GQA, x: torch.Tensor, cfg: ModelConfig, *, positions=None,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              causal: bool = True, impl: str = "ref"):
    """x (B, S, d) -> (y (B, S, d), cache).  With a cache (decode), this
    step's K/V are written into it in place at ``cache_pos`` (the start
    clamped so the slice fits, as ``dynamic_update_slice`` does) and the
    queries attend over the cache up to ``cache_pos + S``."""
    b, sq, d = x.shape
    if positions is None:
        positions = torch.arange(sq, device=x.device)
    q = torch.einsum("bsd,dhk->bhsk", x, p.wq)
    k = torch.einsum("bsd,dhk->bhsk", x, p.wk)
    v = torch.einsum("bsd,dhk->bhsk", x, p.wv)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        start = min(max(cache_pos, 0), ck.shape[2] - sq)
        ck[:, :, start:start + sq] = k.to(ck.dtype)
        cv[:, :, start:start + sq] = v.to(cv.dtype)
        out = attention_math(q, ck, cv, impl, causal=True, window=cfg.window,
                             q_offset=cache_pos, kv_len=cache_pos + sq)
    else:
        out = attention_math(q, k, v, impl, causal=causal, window=cfg.window)
    y = torch.einsum("bhsk,hkd->bsd", out, p.wo)
    return y, cache


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.float32, device=None) -> dict:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V3 / MiniCPM3)
# ---------------------------------------------------------------------------


class MLA(ParamModule):
    NAMES = ("w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_kr", "w_uk",
             "w_uv", "wo")
    SPECS = {"w_dq": ("fsdp", None), "q_norm": (None,),
             "w_uq": (None, "heads", None), "w_dkv": ("fsdp", None),
             "kv_norm": (None,), "w_kr": ("fsdp", None),
             "w_uk": (None, "heads", None), "w_uv": (None, "heads", None),
             "wo": ("heads", None, "fsdp")}
    # the compressed cache: ckv (B, S_max, r) and k_rope (B, S_max, rope)
    CACHE_SPECS = {"ckv": ("batch", "kv_seq", None),
                   "k_rope": ("batch", "kv_seq", None)}


def mla_init(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> MLA:
    """Head dims come from ``cfg.mla`` alone, never ``cfg.head_dim``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    dev = generator.device
    return MLA(
        w_dq=dense_init(generator, (d, m.q_lora_rank), 0, dtype),
        q_norm=zeros_init((m.q_lora_rank,), dtype, dev, 1.0),
        w_uq=dense_init(generator, (m.q_lora_rank, h, qk), 0, dtype),
        w_dkv=dense_init(generator, (d, m.kv_lora_rank), 0, dtype),
        kv_norm=zeros_init((m.kv_lora_rank,), dtype, dev, 1.0),
        w_kr=dense_init(generator, (d, m.qk_rope_head_dim), 0, dtype),
        w_uk=dense_init(generator, (m.kv_lora_rank, h, m.qk_nope_head_dim), 0,
                        dtype),
        w_uv=dense_init(generator, (m.kv_lora_rank, h, m.v_head_dim), 0, dtype),
        wo=dense_init(generator, (h, m.v_head_dim, d), None, dtype)
        / math.sqrt(h * m.v_head_dim),
    )


def mla_apply(p: MLA, x: torch.Tensor, cfg: ModelConfig, *, positions=None,
              cache: Optional[dict] = None, cache_pos: Optional[int] = None,
              causal: bool = True, impl: str = "ref"):
    """x (B, S, d) -> (y (B, S, d), cache).  With a cache (decode), this
    step's latent ``ckv`` and shared rope key are written into the
    compressed cache ``{"ckv": (B, S_max, r), "k_rope": (B, S_max, rope)}``
    in place at ``cache_pos`` (the start clamped as ``gqa_apply`` clamps
    it).  ``cfg.mla_absorb`` decodes in the latent space
    (``_mla_absorbed_decode``); otherwise the cached latents are expanded
    to per-head K and V, the rope key is broadcast over the heads and
    concatenated, and one ``attention_math`` call takes V at its own width
    (the reference pads V to the QK width and cuts the output back: the
    same first v_head_dim columns)."""
    m = cfg.mla
    b, sq, d = x.shape
    nope = m.qk_nope_head_dim
    if positions is None:
        positions = torch.arange(sq, device=x.device)
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p.w_dq), p.q_norm,
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bhsk", cq, p.w_uq)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    ckv = rms_norm(torch.einsum("bsd,dr->bsr", x, p.w_dkv), p.kv_norm,
                   cfg.norm_eps)
    k_rope = rope(torch.einsum("bsd,dk->bsk", x, p.w_kr)[:, None], positions,
                  cfg.rope_theta)  # (B, 1, S, rope)

    if cache is not None:
        # compressed cache: latent + shared rope key (the MLA memory win)
        cc, cr = cache["ckv"], cache["k_rope"]
        start = min(max(cache_pos, 0), cc.shape[1] - sq)
        cc[:, start:start + sq] = ckv.to(cc.dtype)
        cr[:, start:start + sq] = k_rope[:, 0].to(cr.dtype)
        if cfg.mla_absorb:
            return _mla_absorbed_decode(p, cfg, q_nope, q_rope, cc, cr,
                                        cache_pos + sq), cache
        ckv_all, k_rope_all = cc, cr[:, None]
        kv_len, q_offset = cache_pos + sq, cache_pos
    else:
        ckv_all, k_rope_all = ckv, k_rope
        kv_len, q_offset = None, 0

    k_nope = torch.einsum("bsr,rhk->bhsk", ckv_all, p.w_uk)
    v = torch.einsum("bsr,rhk->bhsk", ckv_all, p.w_uv)
    skv = k_nope.shape[2]
    k_full = torch.cat([k_nope, k_rope_all.expand(
        b, cfg.n_heads, skv, m.qk_rope_head_dim)], dim=-1)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    out = attention_math(q_full, k_full, v, impl, causal=causal,
                         window=cfg.window, q_offset=q_offset, kv_len=kv_len)
    return torch.einsum("bhsk,hkd->bsd", out, p.wo), cache


def _mla_absorbed_decode(p: MLA, cfg: ModelConfig, q_nope, q_rope,
                         ckv_cache, k_rope_cache, kv_len: int) -> torch.Tensor:
    """Absorbed MLA decode: attention runs in the latent space.

    scores_h(s) = (W_uk_h^T q_nope_h) . ckv_s + q_rope_h . k_rope_s, i.e.
    MQA with head-specific queries against one shared latent stream; the
    value is the latent itself, expanded through W_uv once after the
    weighted sum.  The two score terms are computed against the two cache
    tensors directly, an online softmax over blocks of ``min(1024, S_max)``
    keys (the reference's scan), so the cache is never concatenated; a
    short last block is padded with zero keys, as the reference pads, and
    only keys at or past ``kv_len`` are masked."""
    m = cfg.mla
    b, h, sq, _ = q_nope.shape
    r = m.kv_lora_rank
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_abs = torch.einsum("bhsk,rhk->bhsr", q_nope, p.w_uk).float()
    q_rope32 = q_rope.float()
    s_max = ckv_cache.shape[1]
    bk = min(1024, s_max)
    m_run = torch.full((b, h, sq), -1e30, dtype=torch.float32,
                       device=q_nope.device)
    l_run = torch.zeros((b, h, sq), dtype=torch.float32, device=q_nope.device)
    acc = torch.zeros((b, h, sq, r), dtype=torch.float32, device=q_nope.device)
    for lo in range(0, s_max, bk):
        ckv_blk = ckv_cache[:, lo:lo + bk].float()
        krp_blk = k_rope_cache[:, lo:lo + bk].float()
        if ckv_blk.shape[1] < bk:
            ckv_blk = F.pad(ckv_blk, (0, 0, 0, bk - ckv_blk.shape[1]))
            krp_blk = F.pad(krp_blk, (0, 0, 0, bk - krp_blk.shape[1]))
        s = (torch.einsum("bhsr,bcr->bhsc", q_abs, ckv_blk)
             + torch.einsum("bhsk,bck->bhsc", q_rope32, krp_blk)) * scale
        k_pos = lo + torch.arange(bk, device=s.device)
        s = torch.where(k_pos < kv_len, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m_run, s.amax(-1))
        alpha = torch.exp(m_run - m_new)
        pr = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + pr.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhsc,bcr->bhsr", pr,
                                                    ckv_blk)
        m_run = m_new
    out_lat = (acc / l_run.clamp_min(1e-30)[..., None]).to(q_nope.dtype)
    out = torch.einsum("bhsr,rhk->bhsk", out_lat, p.w_uv)  # expand once
    return torch.einsum("bhsk,hkd->bsd", out, p.wo)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.float32, device=None) -> dict:
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                               device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


class SwiGLU(ParamModule):
    NAMES = ("w_gate", "w_up", "w_down")
    SPECS = {"w_gate": ("fsdp", "ff"), "w_up": ("fsdp", "ff"),
             "w_down": ("ff", "fsdp")}


def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32) -> SwiGLU:
    return SwiGLU(
        w_gate=dense_init(generator, (d, d_ff), 0, dtype),
        w_up=dense_init(generator, (d, d_ff), 0, dtype),
        w_down=dense_init(generator, (d_ff, d), 0, dtype),
    )


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


class MoE(ParamModule):
    """Routed experts ``w_gate``/``w_up`` (E, d, de) and ``w_down`` (E, de,
    d) behind the router ``w_router`` (d, E); optionally ``router_bias``
    (E,) float32, added to the scores for selection only, and a ``shared``
    ``SwiGLU`` of width de * n_shared."""

    NAMES = ("w_router", "w_gate", "w_up", "w_down")
    SPECS = {"w_router": (None, None), "router_bias": (None,),
             "w_gate": ("experts", "fsdp", None),
             "w_up": ("experts", "fsdp", None),
             "w_down": ("experts", None, "fsdp")}

    def __init__(self, *, router_bias: Optional[torch.Tensor] = None,
                 shared: Optional[SwiGLU] = None, **tensors: torch.Tensor):
        super().__init__(**tensors)
        self.register_parameter(
            "router_bias", None if router_bias is None
            else nn.Parameter(router_bias, requires_grad=False))
        self.shared = shared


def moe_init(generator: torch.Generator, cfg: ModelConfig,
             dtype=torch.float32) -> MoE:
    mo = cfg.moe
    d, e, de = cfg.d_model, mo.n_experts, mo.d_expert
    return MoE(
        w_router=dense_init(generator, (d, e), 0, dtype),
        router_bias=(zeros_init((e,), torch.float32, generator.device)
                     if mo.router_aux_free_bias else None),
        w_gate=dense_init(generator, (e, d, de), 1, dtype),
        w_up=dense_init(generator, (e, d, de), 1, dtype),
        w_down=dense_init(generator, (e, de, d), 1, dtype),
        shared=(swiglu_init(generator, d, de * mo.n_shared, dtype)
                if mo.n_shared else None),
    )


def _top_k(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last axis, ties to the
    lower index (as ``jax.lax.top_k``; ``torch.topk`` promises no order
    among ties), by a stable descending sort."""
    return torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]


def _expert_ffn(p: MoE, ein: torch.Tensor) -> torch.Tensor:
    """(E, G, C, d) -> (E, G, C, d): each expert's SwiGLU on its slots."""
    h = F.silu(torch.einsum("egcd,edf->egcf", ein, p.w_gate)) * torch.einsum(
        "egcd,edf->egcf", ein, p.w_up)
    return torch.einsum("egcf,efd->egcd", h, p.w_down)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Grouped GShard capacity dispatch, the reference's ``moe_apply``:
    x (B, S, d) -> (y (B, S, d), aux).

    Tokens are cut into groups of ``group_size`` (halved until it divides
    the B * S tokens), with capacity ``max(1, ceil(Tg * cf * k / E))`` per
    (group, expert); a decode step (S 1) is one group with capacity T, so
    no token is dropped.  The router's softmax runs in float32; the top-k
    gates are renormalised; a token's slot in an expert is its rank among
    the group's tokens routed there (the cumsum of the scatter-built mask),
    and a token past the capacity is dropped for that expert.  ``dispatch``
    "einsum" builds the (G, Tg, E, C) one-hot dispatch and combine;
    "gather" plans slots by index (a token number per slot, the scratch
    slot E * C taking every dropped or duplicate write, sliced away before
    any read).  ``aux``: ``router_probs_mean`` (E,) and ``dropped_frac``,
    the share of (token, expert) choices dropped."""
    mo = cfg.moe
    b, sq, d = x.shape
    t, e, k = b * sq, mo.n_experts, mo.top_k
    if sq == 1:
        # decode: one group, dropless capacity (a dropped token would
        # silently corrupt a user's next-token logits)
        tg, cap = t, t
    else:
        tg = mo.group_size
        while t % tg:
            tg //= 2
        cap = max(1, -(-int(tg * mo.capacity_factor * k) // e))
    g = t // tg
    xt = x.reshape(g, tg, d)

    logits = torch.einsum("gtd,de->gte", xt, p.w_router).float()
    probs = torch.softmax(logits, dim=-1)
    select = probs + p.router_bias if mo.router_aux_free_bias else probs
    idx = _top_k(select, k)  # (G, Tg, K)
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # scatter-built routing mask/positions: no (Tg x K x E) one-hot
    zeros = torch.zeros((g, tg, e), dtype=torch.float32, device=x.device)
    mask = zeros.scatter_add(-1, idx, torch.ones_like(gates))
    pos = torch.cumsum(mask, dim=1) * mask - 1.0               # (G, Tg, E)
    keep = (pos >= 0) & (pos < cap)
    gate_e = zeros.scatter_add(-1, idx, gates)

    if mo.dispatch == "gather":
        sel_pos = pos.gather(-1, idx)                          # (G, Tg, K)
        valid = (sel_pos >= 0) & (sel_pos < cap)
        slot = idx * cap + sel_pos.clamp_min(0).long()
        slot = torch.where(valid, slot, torch.full_like(slot, e * cap))
        tok = torch.arange(1, tg + 1, device=x.device)[None, :, None].expand(
            g, tg, k)
        slot_tok = torch.zeros((g, e * cap + 1), dtype=torch.long,
                               device=x.device)
        slot_tok.scatter_(1, slot.reshape(g, -1), tok.reshape(g, -1))
        slot_tok = slot_tok[:, : e * cap]  # the scratch slot is never read
        gidx = (slot_tok - 1).clamp_min(0)                     # (G, E*C)
        ein = xt.gather(1, gidx[..., None].expand(g, e * cap, d))
        ein = ein * (slot_tok > 0)[..., None].to(x.dtype)
        ein = ein.reshape(g, e, cap, d).permute(1, 0, 2, 3)
        eout = _expert_ffn(p, ein)
        eout_g = eout.permute(1, 0, 2, 3).reshape(g, e * cap, d)
        sel = torch.where(valid, slot, torch.zeros_like(slot)).reshape(
            g, tg * k)
        vals = eout_g.gather(1, sel[..., None].expand(g, tg * k, d))
        w_tok = (gates * valid.float()).to(x.dtype)
        out = torch.einsum("gtkd,gtk->gtd", vals.reshape(g, tg, k, d), w_tok)
    elif mo.dispatch == "einsum":
        # a dropped choice takes class ``cap``, past every slot: a zero row
        # (compared against the slots, as ``F.one_hot`` checks its range on
        # the host)
        cls = torch.where(keep, pos, torch.full_like(pos, cap))
        slots = torch.arange(cap, device=x.device, dtype=cls.dtype)
        dispatch = (cls[..., None] == slots).to(x.dtype)      # (G, Tg, E, C)
        combine = dispatch * gate_e[..., None].to(x.dtype)
        ein = torch.einsum("gtec,gtd->egcd", dispatch, xt)
        eout = _expert_ffn(p, ein)
        out = torch.einsum("gtec,egcd->gtd", combine, eout)
    else:
        raise ValueError(f"unknown MoE dispatch {mo.dispatch!r}; expected "
                         f"'einsum' or 'gather'")

    if mo.n_shared:
        out = out + swiglu_apply(p.shared, xt.reshape(t, d)).reshape(g, tg, d)
    aux = {"router_probs_mean": probs.mean((0, 1)),
           "dropped_frac": 1.0 - keep.sum() / mask.sum().clamp_min(1.0)}
    return out.reshape(b, sq, d), aux
