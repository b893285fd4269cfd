"""The port's flash attention with V narrower than q and k (MLA's heads), on
the CPU, against the JAX reference on the same numpy inputs.

The reference takes one width: its MLA layer pads V up to the QK width and
cuts the output back.  The port hands V over at its own width, so

* ``mha_plain`` (and the wrapper, which runs it on a CPU tensor) at QK / V
  96 / 64 (minicpm3-4b), 192 / 128 (deepseek-v3) and 24 / 16 (their
  ``reduced()`` MLA) equals ``mha_ref`` on V padded to D, its first Dv
  columns, within 1e-5: causal, windowed, bidirectional, decode offsets and
  ``kv_len``; the decode kernel's split-key order (``mha_split_plain``) too;
* the ``FlashAttention`` VJP equals ``jax.vjp`` of that padded call, with
  dv Dv wide;
* the wrapper's width plan: the built pairs, the first pair that holds a
  call's widths, which tensors the kernels read in place, and the widths
  and strides it refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref
from repro_torch.kernels.flash_attention import ops, ref

WIDTHS = [(96, 64), (192, 128), (24, 16)]
CASES = [  # (b, hq, hkv, sq, skv, causal, window, q_offset, kv_len)
    (2, 4, 4, 40, 40, True, None, 0, None),     # causal prefill
    (1, 4, 2, 33, 33, True, 8, 0, None),        # windowed, GQA
    (2, 2, 2, 20, 20, False, None, 0, None),    # bidirectional
    (2, 4, 4, 1, 50, True, None, 49, None),     # decode offset
    (2, 4, 4, 1, 50, True, None, 30, 31),       # decode, kv_len past it
    (1, 4, 4, 5, 60, True, 16, 40, 45),         # a chunk, window, kv_len
]


def qkv(case, d, dv):
    b, hq, hkv, sq, skv = case[:5]
    rng = np.random.default_rng(sum(case[:5]) + d)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, dv)).astype(np.float32))


def reference(q, k, v, causal, window, q_offset, kv_len):
    """``mha_ref`` on V padded to D (the reference MLA's call), its first Dv
    columns; ``kv_len`` as attending over the first kv_len keys."""
    n = k.shape[2] if kv_len is None else kv_len
    pad = q.shape[-1] - v.shape[-1]
    out = r_mha_ref(jnp.asarray(q), jnp.asarray(k[:, :, :n]),
                    jnp.pad(jnp.asarray(v[:, :, :n]),
                            ((0, 0), (0, 0), (0, 0), (0, pad))),
                    causal=causal, window=window, q_offset=q_offset)
    return np.asarray(out)[..., : v.shape[-1]]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("d,dv", WIDTHS)
def test_plain_at_mla_widths_equals_padded_reference(d, dv, case):
    causal, window, q_offset, kv_len = case[5:]
    q, k, v = qkv(case, d, dv)
    want = reference(q, k, v, causal, window, q_offset, kv_len)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = ref.mha_plain(tq, tk, tv, causal=causal, window=window,
                        q_offset=q_offset, kv_len=kv_len)
    assert got.shape == q.shape[:3] + (dv,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    before = ops.flash_attention.launches
    wrapped = ops.flash_attention(tq, tk, tv, causal, window, q_offset, kv_len)
    assert ops.flash_attention.launches == before  # CPU: no kernel launch
    assert torch.equal(wrapped, got)
    split = ref.mha_split_plain(tq, tk, tv, 3, causal=causal, window=window,
                                q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(split.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,dv", WIDTHS)
def test_function_vjp_equals_padded_reference(d, dv):
    case = (2, 4, 2, 24, 24)
    q, k, v = qkv(case, d, dv)
    cot = np.random.default_rng(d).normal(size=(2, 4, 24, dv)).astype(np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = ops.flash_attention(*leaves, True, None)
    got = torch.autograd.grad(out, leaves, torch.as_tensor(cot))
    assert got[2].shape == v.shape
    want_out, vjp = jax.vjp(
        lambda q, k, v: r_mha_ref(q, k, jnp.pad(
            v, ((0, 0), (0, 0), (0, 0), (0, d - dv))))[..., :dv],
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(got, vjp(jnp.asarray(cot))):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= 1e-5 * max(
            float(np.abs(w).max()), 1.0)


def test_kernel_width_plan():
    assert ops.KERNEL_WIDTHS == ((16, 16), (32, 32), (64, 64), (96, 64),
                                 (128, 128), (192, 128))
    for (d, dv), want in (((96, 64), (96, 64)), ((192, 128), (192, 128)),
                          ((24, 16), (32, 32)), ((96, 96), (128, 128)),
                          ((48, 48), (64, 64)), ((80, 80), (128, 128)),
                          ((160, 128), (192, 128)), ((64, 32), (64, 64))):
        assert ops.kernel_width(d, dv) == want, (d, dv)
    for d, dv in ((256, 256), (192, 192), (200, 128)):
        with pytest.raises(ValueError, match="past every width"):
            ops.kernel_width(d, dv)


def test_in_place_reads():
    """The kernels read a permuted view (MLA's V from its einsum) and a
    head axis broadcast with stride 0 where they lie; a tensor whose last
    axis is not contiguous, or whose rows sit off a 16-byte boundary, is
    copied."""
    v = torch.randn(2, 7, 4, 64).permute(0, 2, 1, 3)  # (B, H, S, Dv) view
    assert not v.is_contiguous() and ops.in_place(v)
    assert ops._aligned(v, 64) is v
    k = torch.randn(2, 1, 7, 96).expand(2, 4, 7, 96)
    assert ops.in_place(k) and ops._aligned(k, 96) is k
    cols = torch.randn(2, 4, 96, 7).transpose(2, 3)
    assert not ops.in_place(cols)
    copy = ops._aligned(cols, 96)
    assert copy.is_contiguous() and torch.equal(copy, cols)
    odd = torch.randn(2, 4, 7, 97)[..., 1:]  # rows 388 bytes apart
    assert not ops.in_place(odd) and ops._aligned(odd, 96).is_contiguous()
    padded = ops._aligned(torch.randn(2, 4, 7, 24), 32)
    assert padded.shape[-1] == 32 and bool((padded[..., 24:] == 0).all())
    # the kernels take 32-bit strides: a larger one is refused
    ops._check_strides(v, k, padded)
    huge = torch.empty_strided((2, 1, 1, 16), (2**31, 16, 16, 1), device="meta")
    with pytest.raises(ValueError, match="below 2\\^31"):
        ops._check_strides(huge)


def test_v_wider_than_k_is_refused():
    q = torch.zeros(1, 2, 3, 16)
    with pytest.raises(ValueError, match="narrower"):
        ops.flash_attention(q, q, torch.zeros(1, 2, 3, 32))
    with pytest.raises(ValueError, match="do not fit"):
        ops.flash_attention(q, q, torch.zeros(1, 2, 4, 16))
