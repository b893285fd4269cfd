"""The port's WKV backward (plain version on the CPU) and the forward
kernel's summation order, against the JAX reference and the plain forward.

* ``ref.wkv6_backward_plain`` against ``jax.vjp`` of the reference's
  ``wkv6`` (its ``custom_vjp``, with ``use_kernel`` False and True: the
  Pallas forward in interpret mode) and against ``torch.autograd`` of
  ``ref.wkv6_plain``: T not a multiple of the backward kernel's 8-step
  chunk, Dk != Dv, Dk not a power of two, with and without state0, and a
  zero cotangent on either output.  Each leaf within 1e-5 of its largest
  value: the closed form sums the same float32 terms in another order than
  autograd's (and than XLA's), so elementwise agreement holds only to a few
  ulps of the leaf's scale;
* ``WKV6.backward`` on a CPU tensor is the plain backward, bit for bit,
  and launches nothing;
* ``tree_sum_lanes`` (the forward kernel's lane-split tree, emulated here:
  contiguous blocks summed pairwise, then xor-stride merges) equals
  ``ref.tree_sum`` bit for bit for Dk 8, 24, 64 and 128 and G 1, 2, 4, 8
  and 16, padded as the plain version pads and as the kernel pads (to 64
  or 128 rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.ops import wkv6 as r_wkv6
from repro_torch.kernels.rwkv6_wkv import ops, ref

TOL = 1e-5  # of each leaf's largest value
NAMES = ("r", "k", "v", "w", "u", "state0")


def inputs(seed, b, h, t, dk, dv):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, dk)).astype(np.float32),
            rng.normal(size=(b, h, t, dk)).astype(np.float32),
            rng.normal(size=(b, h, t, dv)).astype(np.float32),
            rng.uniform(0.2, 0.99, size=(b, h, t, dk)).astype(np.float32),
            rng.normal(size=(h, dk)).astype(np.float32),
            rng.normal(size=(b, h, dk, dv)).astype(np.float32)]


def cotangents(seed, b, h, t, dk, dv, zero):
    rng = np.random.default_rng(seed + 1)
    g_o = rng.normal(size=(b, h, t, dv)).astype(np.float32)
    g_s = rng.normal(size=(b, h, dk, dv)).astype(np.float32)
    if zero == "o":
        g_o = np.zeros_like(g_o)
    if zero == "state":
        g_s = np.zeros_like(g_s)
    return g_o, g_s


def assert_leaf_close(name, got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{name}: {err} > {TOL} x {scale}"


SHAPES = [  # (b, h, t, dk, dv)
    (2, 2, 21, 16, 8),   # T not a multiple of 8, Dk != Dv
    (1, 3, 13, 24, 16),  # Dk not a power of two
    (1, 1, 8, 8, 8),     # one whole chunk
]


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_reference_vjp_and_autograd(shape, with_state):
    b, h, t, dk, dv = shape
    seed = sum(shape)
    arrays = inputs(seed, *shape)
    if not with_state:  # zeros on the reference's side, None on the port's
        arrays[5] = np.zeros_like(arrays[5])
    # the reference's custom_vjp, on its plain and its kernel forward
    vjps = {use_kernel: jax.vjp(lambda *xs, uk=use_kernel: r_wkv6(*xs, 8, uk),
                                *map(jnp.asarray, arrays))[1]
            for use_kernel in (False, True)}
    for zero in (None, "o", "state"):
        g_o, g_s = cotangents(seed, *shape, zero)
        got = ref.wkv6_backward_plain(
            *map(torch.as_tensor, arrays[:5]),
            torch.as_tensor(arrays[5]) if with_state else None,
            torch.as_tensor(g_o), torch.as_tensor(g_s))
        assert (got[5] is None) == (not with_state)
        for a, g in zip(arrays, got):
            if g is not None:
                assert g.dtype == torch.float32 and g.shape == a.shape
        # torch.autograd through the plain forward
        leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
        o, s = ref.wkv6_plain(*leaves[:5], leaves[5] if with_state else None)
        want = torch.autograd.grad((o, s), leaves, (torch.as_tensor(g_o),
                                                    torch.as_tensor(g_s)),
                                   allow_unused=True)
        for name, gg, ww in zip(NAMES, got, want):
            if gg is not None:
                assert_leaf_close(f"{name} autograd {zero}", gg.numpy(),
                                  ww.numpy())
        for use_kernel, vjp in vjps.items():
            want_j = vjp((jnp.asarray(g_o), jnp.asarray(g_s)))
            for name, gg, ww in zip(NAMES, got, want_j):
                if gg is not None:
                    assert_leaf_close(f"{name} jax {use_kernel} {zero}",
                                      gg.numpy(), ww)


def test_plain_backward_takes_none_cotangents_and_bf16():
    arrays = list(map(torch.as_tensor, inputs(3, 1, 2, 11, 16, 16)))
    none = ref.wkv6_backward_plain(*arrays, None, None)
    for g in none[:4] + (none[5],):
        assert not g.any()
    assert not none[4].any() and none[4].shape == (2, 16)
    g_o, g_s = map(torch.as_tensor, cotangents(3, 1, 2, 11, 16, 16, None))
    low = [x.bfloat16() for x in arrays[:4]]
    got = ref.wkv6_backward_plain(*low, arrays[4], arrays[5], g_o.bfloat16(),
                                  g_s)
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    want = ref.wkv6_backward_plain(*(x.float() for x in low), arrays[4],
                                   arrays[5], g_o.bfloat16().float(), g_s)
    for gg, ww in zip(got, want):  # the same sums, rounded once at the end
        torch.testing.assert_close(gg, ww.to(gg.dtype), rtol=0, atol=0)


@pytest.mark.parametrize("with_state", [True, False])
def test_function_backward_is_the_plain_backward(with_state):
    arrays = list(map(torch.as_tensor, inputs(9, 2, 2, 19, 16, 8)))
    g_o, g_s = map(torch.as_tensor, cotangents(9, 2, 2, 19, 16, 8, None))
    state0 = arrays[5] if with_state else None
    leaves = [x.clone().requires_grad_(True)
              for x in arrays[:5] + ([state0] if with_state else [])]
    before = ops.launch_counts()
    o, s = ops.wkv6(*leaves[:5], leaves[5] if with_state else None)
    got = torch.autograd.grad((o, s), leaves, (g_o, g_s))
    assert ops.launch_counts() == before  # CPU: no kernel launch
    want = ops.wkv6_backward(*arrays[:5], state0, g_o, g_s)
    assert (want[5] is None) == (not with_state)
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, rtol=0, atol=0)
    # only the final state's cotangent (o unused): the Function gets None
    (gs_only,) = torch.autograd.grad(
        ops.wkv6(*leaves[:5], leaves[5] if with_state else None)[1].sum(),
        [leaves[0]])
    want = ops.wkv6_backward(*arrays[:5], state0, None, torch.ones_like(g_s))
    torch.testing.assert_close(gs_only, want[0], rtol=0, atol=0)


def test_backward_checks_cotangent_shapes():
    arrays = list(map(torch.as_tensor, inputs(1, 1, 2, 5, 8, 8)))
    with pytest.raises(ValueError, match="grad_o"):
        ops.wkv6_backward(*arrays, torch.zeros(1, 2, 4, 8), None)
    with pytest.raises(ValueError, match="grad_state"):
        ops.wkv6_backward(*arrays, None, torch.zeros(1, 2, 8, 9))


def tree_sum_lanes(p, lanes, size=None):
    """``ref.tree_sum`` as the forward kernel builds it: (..., n, Dv) rows
    padded with zeros to ``size`` (a power of two, default the next one >= n
    and >= lanes), ``lanes`` contiguous blocks each summed pairwise, then
    the block sums merged by xor strides 1, 2, 4, ... (``__shfl_xor_sync``:
    every lane ends with the sum)."""
    n = p.shape[-2]
    if size is None:
        size = max(1 << max(n - 1, 0).bit_length(), lanes)
    if size != n:
        pad = p.new_zeros((*p.shape[:-2], size - n, p.shape[-1]))
        p = torch.cat([p, pad], dim=-2)
    sums = []
    for blk in p.split(size // lanes, dim=-2):  # one lane: its rows' tree
        while blk.shape[-2] > 1:
            blk = blk[..., 0::2, :] + blk[..., 1::2, :]
        sums.append(blk[..., 0, :])
    stride = 1
    while stride < lanes:
        sums = [sums[g] + sums[g ^ stride] for g in range(lanes)]
        stride *= 2
    return sums[0]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("dk", [8, 24, 64, 128])
def test_lane_split_tree_equals_tree_sum_bit_for_bit(dk, lanes):
    rng = np.random.default_rng(dk * 31 + lanes)
    # terms as the forward makes them, r (S + u k v), over a few columns
    p = torch.as_tensor(rng.normal(size=(3, dk, 64)).astype(np.float32)
                        * rng.uniform(0.1, 10.0, size=(3, dk, 1)).astype(np.float32))
    want = ref.tree_sum(p).view(torch.int32)
    kernel_rows = 64 if dk <= 64 else 128
    sizes = {kernel_rows}  # the kernel's padding
    if lanes <= 1 << max(dk - 1, 0).bit_length():
        sizes.add(None)    # the plain version's own padding
    for size in sizes:
        got = tree_sum_lanes(p, lanes, size).view(torch.int32)
        assert torch.equal(got, want), (dk, lanes, size)

