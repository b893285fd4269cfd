"""State-space layers of the port: the Mamba selective scan (hymba's
branch parallel to attention) and the RWKV-6 "Finch" block.

Mamba: a causal depthwise conv over time, then a diagonal selective SSM.
Its recurrence h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t is plain torch on
every device, as it is plain ``jnp`` in the reference, which has no Pallas
kernel for it: a decode step (T 1) is one update, and a longer sequence
runs ``associative_scan``, a log-depth scan over time built from tensor
ops that follows ``jax.lax.associative_scan``'s odd/even recursion, so the
products come in the reference's order (no Python loop over T).

RWKV-6: token shift, data-dependent decay time mix over the WKV recurrence
(``kernels/rwkv6_wkv``), per-head group norm and the squared-ReLU channel
mix.  Decode carries O(1) state per layer: Mamba's ``h`` and conv tail,
RWKV's WKV state and its two token-shift carries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref
from repro_torch.models.config import ModelConfig, RWKVConfig, SSMConfig
from repro_torch.models.layers import ParamModule, dense_init, impl_error, zeros_init

GROUP_NORM_EPS = 64e-5


# ---------------------------------------------------------------------------
# Mamba (selective SSM, diagonal A): hymba's branch parallel to attention
# ---------------------------------------------------------------------------


class Mamba(ParamModule):
    NAMES = ("w_in", "conv_w", "conv_b", "w_bcdt", "w_dt", "dt_bias",
             "a_log", "d_skip", "w_out")
    SPECS = {"w_in": ("fsdp", "ff"), "conv_w": (None, "ff"), "conv_b": ("ff",),
             "w_bcdt": ("ff", None), "w_dt": (None, "ff"), "dt_bias": ("ff",),
             "a_log": ("ff", None), "d_skip": ("ff",), "w_out": ("ff", "fsdp")}
    # the decode state's: h (B, ED, n) and conv (B, W - 1, ED)
    STATE_SPECS = {"h": ("batch", "ff", None), "conv": ("batch", None, "ff")}


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(ED, n, dt_rank) of ``cfg.ssm``."""
    sc: SSMConfig = cfg.ssm
    return (sc.expand * cfg.d_model, sc.state_dim,
            sc.dt_rank or max(1, cfg.d_model // 16))


def mamba_init(generator: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> Mamba:
    """The reference's ``mamba_init`` in its draw order and shapes:
    ``a_log = log(1..n)`` broadcast over ED (float32), ``d_skip`` ones."""
    d = cfg.d_model
    ed, n, dt_rank = _mamba_dims(cfg)
    dev = generator.device
    t = {"w_in": dense_init(generator, (d, 2 * ed), 0, dtype),
         "conv_w": dense_init(generator, (cfg.ssm.conv_width, ed), 0, dtype),
         "conv_b": zeros_init((ed,), dtype, dev),
         "w_bcdt": dense_init(generator, (ed, 2 * n + dt_rank), 0, dtype),
         "w_dt": dense_init(generator, (dt_rank, ed), 0, dtype),
         "dt_bias": zeros_init((ed,), dtype, dev)}
    t["a_log"] = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                        device=dev)).expand(ed, n).clone()
    t["d_skip"] = zeros_init((ed,), dtype, dev, 1.0)
    t["w_out"] = dense_init(generator, (ed, d), 0, dtype)
    return Mamba(**t)


def _mamba_core(p: Mamba, xc: torch.Tensor, dt_rank: int, n: int):
    """xc (B, T, ED) post-conv activations -> the scan's decay da and input
    dbx, each (B, T, ED, n), and C (B, T, n)."""
    bcdt = xc @ p.w_bcdt  # (B, T, 2n + dt_rank)
    b_mat = bcdt[..., :n]
    c_mat = bcdt[..., n:2 * n]
    dt = F.softplus(bcdt[..., 2 * n:] @ p.w_dt + p.dt_bias)  # (B, T, ED)
    a = -torch.exp(p.a_log.float())                          # (ED, n)
    da = torch.exp(dt[..., None] * a)                        # decay
    dbx = dt[..., None] * b_mat[..., None, :] * xc[..., None]
    return da, dbx, c_mat


def _ssm_combine(left, right):
    """(a, b) o (a', b') = (a a', a' b + b'): two steps of h -> a h + b."""
    al, bl = left
    ar, br = right
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Rows ``even[0], odd[0], even[1], ...`` along axis 0 (``even`` has as
    many rows as ``odd`` or one more)."""
    m = odd.shape[0]
    pairs = torch.stack([even[:m], odd], dim=1).reshape(2 * m, *odd.shape[1:])
    return torch.cat([pairs, even[m:]], dim=0) if even.shape[0] > m else pairs


def associative_scan(fn, elems):
    """Inclusive scan of the tuple of tensors ``elems`` along axis 0 under
    the associative ``fn``, by ``jax.lax.associative_scan``'s recursion:
    combine adjacent pairs, scan the half, then fill in the even rows; the
    depth is log2(T) and every level is a few whole-tensor ops."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    odd = associative_scan(fn, fn(tuple(e[0:-1:2] for e in elems),
                                  tuple(e[1::2] for e in elems)))
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tuple(e[2::2] for e in elems))
    else:
        even = fn(odd, tuple(e[2::2] for e in elems))
    even = tuple(torch.cat([e[:1], r], dim=0) for e, r in zip(elems, even))
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def mamba_apply(p: Mamba, x: torch.Tensor, cfg: ModelConfig, *,
                state: dict | None = None):
    """x (B, T, d) -> (y (B, T, d), new state ``{"h": (B, ED, n) float32,
    "conv": (B, W - 1, ED)}``).  The conv reads the ``state``'s last W - 1
    inputs (zeros without one); ``h0`` enters the scan folded into its
    first element, as in the reference."""
    ed, n, dt_rank = _mamba_dims(cfg)
    bsz, t, _ = x.shape
    xz = x @ p.w_in
    xs, z = xz[..., :ed], xz[..., ed:]

    # causal depthwise conv over time
    w = cfg.ssm.conv_width
    if state is not None:
        hist = torch.cat([state["conv"].to(xs.dtype), xs], dim=1)
    else:
        hist = F.pad(xs, (0, 0, w - 1, 0))  # (B, W - 1 + T, ED)
    xc = sum(hist[:, i:i + t] * p.conv_w[i] for i in range(w)) + p.conv_b
    xc = F.silu(xc)
    new_conv = hist[:, hist.shape[1] - (w - 1):]

    da, dbx, c_mat = _mamba_core(p, xc, dt_rank, n)
    h0 = (state["h"].float() if state is not None
          else torch.zeros((bsz, ed, n), dtype=torch.float32, device=x.device))
    if t == 1:
        h = da[:, 0] * h0 + dbx[:, 0]
        # float32 state times C: float32, as the reference's einsum promotes
        # (ROADMAP C13)
        y = torch.einsum("ben,bn->be", h, c_mat[:, 0].float())[:, None]
        h_fin = h
    else:
        da_t = da.transpose(0, 1).float()    # (T, B, ED, n)
        dbx_t = dbx.transpose(0, 1).float()
        # fold the initial state into the first element
        dbx_t = torch.cat([dbx_t[:1] + da_t[0] * h0, dbx_t[1:]], dim=0)
        _, h_all = associative_scan(_ssm_combine, (da_t, dbx_t))
        y = torch.einsum("tben,btn->bte", h_all, c_mat.float())
        h_fin = h_all[-1]
    y = y + xc.float() * p.d_skip.float()
    y = y * F.silu(z.float())
    out = (y.to(x.dtype) @ p.w_out).to(x.dtype)
    return out, {"h": h_fin, "conv": new_conv}


def mamba_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    ed, n, _ = _mamba_dims(cfg)
    return {"h": torch.zeros((batch, ed, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm.conv_width - 1, ed),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RWKV-6 block
# ---------------------------------------------------------------------------


class RWKV6(ParamModule):
    NAMES = ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_x", "w_mix_a",
             "w_mix_b", "w_r", "w_k", "w_v", "w_g", "w_decay_a", "w_decay_b",
             "decay_base", "u_bonus", "ln_x_scale", "w_o", "cm_mu_k", "cm_wk",
             "cm_wv")
    SPECS = {**{nm: (None,) for nm in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                                       "mu_x", "decay_base", "ln_x_scale",
                                       "cm_mu_k")},
             "w_mix_a": ("fsdp", None), "w_mix_b": (None, None, "fsdp"),
             **{nm: ("fsdp", "heads") for nm in ("w_r", "w_k", "w_v", "w_g")},
             "w_decay_a": ("fsdp", None), "w_decay_b": (None, "fsdp"),
             "u_bonus": (None, None), "w_o": ("heads", "fsdp"),
             "cm_wk": ("fsdp", "ff"), "cm_wv": ("ff", "fsdp")}
    STATE_SPECS = {"wkv": ("batch", "heads", None, None),
                   "tm_prev": ("batch", None), "cm_prev": ("batch", None)}


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
    kernel takes float32 params only (it raises on mixed types).  Under
    ``xla_flash`` the plain version runs, as the reference's rwkv6 takes
    its kernel only under ``kernel``."""
    if impl in ("auto", "kernel"):
        return wkv_ops.wkv6(r, k, v, w, u, state)
    if impl in ("ref", "xla_flash"):
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
