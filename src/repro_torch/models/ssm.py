"""The RWKV-6 "Finch" block of the port: token shift, data-dependent decay
time mix over the WKV recurrence (``kernels/rwkv6_wkv``), per-head group
norm and the squared-ReLU channel mix.  Decode carries O(1) state per
layer: the WKV state and the two token-shift carries.  The reference's
Mamba branch (the hybrid family) is not ported yet (ROADMAP A12 (b) 4).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.models.config import ModelConfig, RWKVConfig
from repro_torch.models.layers import ParamModule, dense_init, impl_error, zeros_init

GROUP_NORM_EPS = 64e-5


class RWKV6(ParamModule):
    NAMES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_x", "w_mix_a",
             "w_mix_b", "w_r", "w_k", "w_v", "w_g", "w_decay_a", "w_decay_b",
             "decay_base", "u_bonus", "ln_x_scale", "w_o", "cm_mu_k", "cm_wk",
             "cm_wv")


def rwkv6_init(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> RWKV6:
    """The reference's ``rwkv6_init`` in its draw order (``mu_x`` is kept
    though no maths read it, so the layouts match)."""
    rc: RWKVConfig = cfg.rwkv
    d = cfg.d_model
    n_heads = d // rc.head_dim
    dev = generator.device
    t = {nm: zeros_init((d,), dtype, dev, 0.5)
         for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_x")}
    t["w_mix_a"] = dense_init(generator, (d, rc.mix_lora * 5), 0, dtype)
    t["w_mix_b"] = dense_init(generator, (5, rc.mix_lora, d), 1, dtype)
    for nm in ("w_r", "w_k", "w_v", "w_g"):
        t[nm] = dense_init(generator, (d, d), 0, dtype)
    t["w_decay_a"] = dense_init(generator, (d, rc.decay_lora), 0, dtype)
    t["w_decay_b"] = dense_init(generator, (rc.decay_lora, d), 0, dtype)
    # w = exp(-exp(-4)) ~ 0.982 at init; decay and bonus stay float32
    t["decay_base"] = zeros_init((d,), torch.float32, dev, -4.0)
    t["u_bonus"] = zeros_init((n_heads, rc.head_dim), torch.float32, dev)
    t["ln_x_scale"] = zeros_init((d,), dtype, dev, 1.0)
    t["w_o"] = dense_init(generator, (d, d), 0, dtype)
    t["cm_mu_k"] = zeros_init((d,), dtype, dev, 0.5)
    t["cm_wk"] = dense_init(generator, (d, cfg.d_ff), 0, dtype)
    t["cm_wv"] = dense_init(generator, (cfg.d_ff, d), 0, dtype)
    return RWKV6(**t)


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """shift(x)[t] = x[t-1]; position 0 takes ``prev`` (the decode carry)."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def wkv6_apply(impl: str, r, k, v, w, u, state):
    """The WKV recurrence by ``impl``, as ``attention_math`` dispatches
    attention.  The decay ``w`` is float32, as in the reference, so the
    kernel takes float32 params only (it raises on mixed types)."""
    if impl in ("auto", "kernel"):
        return wkv_ops.wkv6(r, k, v, w, u, state)
    if impl == "ref":
        return wkv_ref.wkv6_plain(r, k, v, w, u, state)
    raise impl_error(impl)


def rwkv6_time_mix(p: RWKV6, x: torch.Tensor, cfg: ModelConfig, *,
                   wkv_state: torch.Tensor, x_prev: torch.Tensor, impl: str):
    """x (B, T, d) -> (out (B, T, d), new WKV state, last x (B, d))."""
    rc: RWKVConfig = cfg.rwkv
    d = cfg.d_model
    hd = rc.head_dim
    nh = d // hd
    b, t, _ = x.shape
    delta = _token_shift(x, x_prev) - x
    # data-dependent mixing (the Finch "dynamic token shift")
    mix_lora = torch.tanh(x @ p.w_mix_a).reshape(b, t, 5, rc.mix_lora)
    dyn = torch.einsum("btfl,fld->btfd", mix_lora, p.w_mix_b)  # (B,T,5,d)
    xr = x + delta * (p.mu_r + dyn[:, :, 0])
    xk = x + delta * (p.mu_k + dyn[:, :, 1])
    xv = x + delta * (p.mu_v + dyn[:, :, 2])
    xw = x + delta * (p.mu_w + dyn[:, :, 3])
    xg = x + delta * (p.mu_g + dyn[:, :, 4])

    def heads(y):
        return y.reshape(b, t, nh, hd).transpose(1, 2)

    r, k, v = heads(xr @ p.w_r), heads(xk @ p.w_k), heads(xv @ p.w_v)
    g = F.silu(xg @ p.w_g)
    decay_inner = p.decay_base + torch.tanh(xw @ p.w_decay_a) @ p.w_decay_b
    w = heads(torch.exp(-torch.exp(decay_inner.float())))  # (0, 1)

    o, new_state = wkv6_apply(impl, r, k, v, w, p.u_bonus, wkv_state)
    # per-head group norm
    og = o.transpose(1, 2).reshape(b, t, nh, hd)
    mu = og.mean(-1, keepdim=True)
    var = og.var(-1, keepdim=True, unbiased=False)
    og = (og - mu) * torch.rsqrt(var + GROUP_NORM_EPS)
    o = (og.reshape(b, t, d) * p.ln_x_scale).to(x.dtype)
    out = ((o * g.to(x.dtype)) @ p.w_o).to(x.dtype)
    return out, new_state, x[:, -1]


def rwkv6_channel_mix(p: RWKV6, x: torch.Tensor, *, x_prev: torch.Tensor):
    """x (B, T, d) -> (out (B, T, d), last x (B, d))."""
    xk = x + (_token_shift(x, x_prev) - x) * p.cm_mu_k
    h = torch.square(F.relu(xk @ p.cm_wk))
    return h @ p.cm_wv, x[:, -1]


def rwkv6_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    rc = cfg.rwkv
    d = cfg.d_model
    nh = d // rc.head_dim
    return {
        "wkv": torch.zeros((batch, nh, rc.head_dim, rc.head_dim),
                           dtype=torch.float32, device=device),
        "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
    }
