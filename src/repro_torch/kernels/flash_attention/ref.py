"""Plain PyTorch version of the flash-attention kernel.

``mha_plain`` is the materializing masked softmax of the reference's
``kernels/flash_attention/ref.py::mha_ref``, plus the ``kv_len`` pad mask of
the Pallas kernel: scores in float32 at scale 1/sqrt(D) (q's width), masked
to -1e30 where a key is past ``kv_len``, in the future of a causal query, or
outside the sliding ``window``, then softmax and the weighted sum of V,
cast to ``q.dtype``.  A row that sees no key (``kv_len`` 0, a query
before every key, a row windowed out) comes out 0, as the kernel's does;
the reference's ``mha_ref`` gives NaN there, and no model path has such a
row (ROADMAP C12).  V may be narrower than q and k (MLA's head): the
output takes V's width, the first columns of the reference's output on V
padded to q's width.
GQA maps query head ``h`` to KV head ``h // (Hq / Hkv)``.  It runs on any
device: the CPU tests use it, and the card compares the kernel with it.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def visible_mask(sq: int, skv: int, *, causal: bool = True, window=None,
                 q_offset: int = 0, kv_len=None, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: which key each query row may attend to."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    if kv_len is not None:
        mask &= kpos < kv_len
    return mask


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None, q_offset: int = 0,
              kv_len=None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) x (B, Hkv, Skv, Dv) -> (B, Hq, Sq,
    Dv) in q.dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if skv == 0:
        return q.new_zeros((b, hq, sq, v.shape[3]))
    group = hq // hkv
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    mask = visible_mask(sq, skv, causal=causal, window=window,
                        q_offset=q_offset, kv_len=kv_len, device=q.device)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.exp(logits - logits.amax(-1, keepdim=True))
    # a row that sees no key gets weight 0 everywhere: its output is 0
    probs = torch.where(mask.any(-1, keepdim=True), probs,
                        torch.zeros_like(probs))
    probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vv).to(q.dtype)


def mha_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    n_splits: int, *, causal: bool = True, window=None,
                    q_offset: int = 0, kv_len=None) -> torch.Tensor:
    """The decode kernel's algorithm in plain PyTorch (tests only): the keys
    below ``min(Skv, kv_len)`` are cut into ``n_splits`` contiguous chunks;
    each chunk keeps its own running max m, sum l and accumulator over the
    keys a row may see (a chunk that sees none has m = -1e30, l = 0), and
    the chunks merge in order with the log-sum-exp rescale, a chunk with
    l = 0 at weight 0.  A row that sees no key at all comes out 0.
    Returns (B, Hq, Sq, Dv) in q.dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    end = skv if kv_len is None else min(skv, kv_len)
    kk = k.float().repeat_interleave(group, dim=1)
    vv = v.float().repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) / math.sqrt(d)
    mask = visible_mask(sq, skv, causal=causal, window=window,
                        q_offset=q_offset, kv_len=end, device=q.device)
    size = -(-end // n_splits) if end else 0
    parts = []
    for c in range(n_splits):
        lo, hi = min(c * size, end), min((c + 1) * size, end)
        vis = mask[:, lo:hi]
        s = logits[..., lo:hi]
        s = torch.where(vis, s, torch.full_like(s, NEG_INF))
        m = s.amax(-1, keepdim=True) if hi > lo else \
            torch.full(logits.shape[:-1] + (1,), NEG_INF, device=q.device)
        p = torch.where(vis, torch.exp(s - m), torch.zeros_like(s))
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhqk,bhkd->bhqd", p, vv[:, :, lo:hi])))
    seen = [torch.where(l > 0, m, torch.full_like(m, NEG_INF)) for m, l, _ in parts]
    top = torch.stack(seen).amax(0)
    total_l = torch.zeros_like(top)
    total = torch.zeros(b, hq, sq, v.shape[3], device=q.device)
    for m, l, acc in parts:  # fixed order
        w = torch.where(l > 0, torch.exp(m - top), torch.zeros_like(m))
        total_l = total_l + l * w
        total = total + acc * w
    return (total / total_l.clamp_min(1e-30)).to(q.dtype)
