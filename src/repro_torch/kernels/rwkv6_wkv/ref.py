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
