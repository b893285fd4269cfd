"""Model layers of the port: init helpers, norms, RoPE, attention maths, the
GQA attention layer and the SwiGLU MLP.

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
  * ``xla_flash``         — the reference's XLA-only ``lax.scan``
    formulation; the port raises ``ValueError``.
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

IMPLS = ("auto", "kernel", "ref")


class ParamModule(nn.Module):
    """A layer's weights: one ``nn.Parameter`` per name in ``NAMES``."""

    NAMES: tuple[str, ...] = ()

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


def attention_math(q, k, v, impl: str, *, causal: bool = True, window=None,
                   q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D)^2 -> (B, Hq, Sq, D).  Unlike the
    reference's kernel branch (ROADMAP C7), ``kv_len`` reaches every impl."""
    if impl in ("auto", "kernel"):
        return flash_ops.flash_attention(q, k, v, causal, window, q_offset,
                                         kv_len)
    if impl == "ref":
        return flash_ref.mha_plain(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, kv_len=kv_len)
    raise impl_error(impl)


def impl_error(impl: str) -> ValueError:
    if impl == "xla_flash":
        return ValueError("attn_impl 'xla_flash' is the reference's XLA-only "
                          "formulation; the port takes 'auto', 'kernel' or 'ref'")
    return ValueError(f"unknown attn_impl {impl!r}; expected one of {IMPLS}")


def resolve_attn_impl(cfg: ModelConfig) -> str:
    """``auto`` means the kernel (which runs its plain version on a CPU
    tensor); ``xla_flash`` raises."""
    if cfg.attn_impl not in IMPLS:
        raise impl_error(cfg.attn_impl)
    return "kernel" if cfg.attn_impl == "auto" else cfg.attn_impl


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


class GQA(ParamModule):
    NAMES = ("wq", "wk", "wv", "wo")


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
# MLP
# ---------------------------------------------------------------------------


class SwiGLU(ParamModule):
    NAMES = ("w_gate", "w_up", "w_down")


def swiglu_init(generator: torch.Generator, d: int, d_ff: int,
                dtype=torch.float32) -> SwiGLU:
    return SwiGLU(
        w_gate=dense_init(generator, (d, d_ff), 0, dtype),
        w_up=dense_init(generator, (d, d_ff), 0, dtype),
        w_down=dense_init(generator, (d_ff, d), 0, dtype),
    )


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
