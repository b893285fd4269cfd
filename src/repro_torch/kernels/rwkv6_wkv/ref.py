"""Plain PyTorch version of the RWKV-6 WKV kernel.

Per head with state S (Dk x Dv, float32), as the reference's
``kernels/rwkv6_wkv/ref.py::wkv6_ref``:

    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

It steps through T in float32 and returns ``(o (B, H, T, Dv) in r.dtype,
S_T (B, H, Dk, Dv) float32)``.  The evaluation order is fixed, and the CUDA
kernel follows it, so the two agree bit for bit: each product and sum is
its own rounded elementwise op (``s + u * kv`` is ``u * kv``, then the sum;
``w * s + kv`` likewise), and ``o_t`` sums ``r_i (S_ij + u_i kv_ij)`` over
i in a pairwise tree (``p[0::2] + p[1::2]`` until one row is left, Dk
padded with zeros to a power of two).  It runs on any device: the CPU
tests use it, and the card compares the kernel with it.

``wkv6_backward_plain`` is the VJP of the recurrence in closed form, a
reverse walk over T with the cotangents of o and of the final state (the
gradient that the reference's ``custom_vjp`` takes of ``wkv6_ref``).  With
``g_t`` the cotangent of o_t and dS that of S_t (the final state's at
t = T):

    dr_t[i] = sum_j g_t[j] (S_{t-1}[i,j] + u[i] k_t[i] v_t[j])
    dk_t[i] = sum_j (r_t[i] u[i] g_t[j] + dS[i,j]) v_t[j]
    dv_t[j] = sum_i (r_t[i] u[i] g_t[j] + dS[i,j]) k_t[i]
    dw_t[i] = sum_j dS[i,j] S_{t-1}[i,j]
    du[i]  += sum_j r_t[i] g_t[j] k_t[i] v_t[j]   (and over batch rows)
    dS      = r_t g_t^T + diag(w_t) dS            (dS_{t-1})

and dstate0 is the last dS.  The backward kernel computes the same sums in
another order (float32 throughout).
"""

from __future__ import annotations

import torch


def tree_sum(p: torch.Tensor) -> torch.Tensor:
    """(..., n, Dv) -> (..., Dv): pairwise sums, zero-padded to a power of
    two, each level ``p[..., 0::2, :] + p[..., 1::2, :]``."""
    n = p.shape[-2]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        pad = p.new_zeros((*p.shape[:-2], size - n, p.shape[-1]))
        p = torch.cat([p, pad], dim=-2)
    while p.shape[-2] > 1:
        p = p[..., 0::2, :] + p[..., 1::2, :]
    return p[..., 0, :]


def wkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state0=None):
    """r/k/w (B, H, T, Dk), v (B, H, T, Dv), u (H, Dk), state0 (B, H, Dk,
    Dv) or None (zeros) -> (o, state)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    r32, k32, v32, w32 = r.float(), k.float(), v.float(), w.float()
    u32 = u.float()[None, :, :, None]
    outs = []
    for i in range(t):
        kv = k32[:, :, i, :, None] * v32[:, :, i, None, :]
        outs.append(tree_sum(r32[:, :, i, :, None] * (s + u32 * kv)))
        s = w32[:, :, i, :, None] * s + kv
    o = (torch.stack(outs, dim=2) if outs
         else torch.zeros((b, h, 0, dv), device=r.device))
    return o.to(r.dtype), s


def wkv6_backward_plain(r, k, v, w, u, state0, grad_o, grad_state):
    """The closed-form VJP of ``wkv6_plain`` -> (dr, dk, dv, dw, du,
    dstate0): dr, dk, dv, dw in their inputs' types, du in u's, dstate0
    float32 (None when state0 is None).  ``grad_o`` (B, H, T, Dv) and
    ``grad_state`` (B, H, Dk, Dv) may be None (zero cotangents)."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    r32, k32, v32, w32 = r.float(), k.float(), v.float(), w.float()
    u32 = u.float()[None, :, :, None]
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    states = []
    for i in range(t):  # S_{t-1} for every step, as the plain forward makes it
        states.append(s)
        s = w32[:, :, i, :, None] * s + k32[:, :, i, :, None] * v32[:, :, i, None, :]
    g = (torch.zeros((b, h, t, dv), dtype=torch.float32, device=r.device)
         if grad_o is None else grad_o.float())
    ds = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
          if grad_state is None else grad_state.float())
    dr, dkk, dvv, dw = (torch.zeros_like(x) for x in (r32, k32, v32, w32))
    du = torch.zeros((b, h, dk), dtype=torch.float32, device=r.device)
    for i in reversed(range(t)):
        s_prev = states[i]
        r_i, k_i, w_i = (x[:, :, i, :, None] for x in (r32, k32, w32))
        v_i, g_i = v32[:, :, i, None, :], g[:, :, i, None, :]
        kv = k_i * v_i
        rg = r_i * g_i
        dr[:, :, i] = (g_i * (s_prev + u32 * kv)).sum(-1)
        dkv = u32 * rg + ds
        dkk[:, :, i] = (dkv * v_i).sum(-1)
        dvv[:, :, i] = (dkv * k_i).sum(-2)
        dw[:, :, i] = (ds * s_prev).sum(-1)
        du += (rg * kv).sum(-1)
        ds = rg + w_i * ds
    return (dr.to(r.dtype), dkk.to(k.dtype), dvv.to(v.dtype), dw.to(w.dtype),
            du.sum(0).to(u.dtype), None if state0 is None else ds)
