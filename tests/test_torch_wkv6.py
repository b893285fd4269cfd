"""The port's RWKV-6 WKV (plain version on the CPU) against the JAX
reference, on the same numpy inputs.

* the reference sweep's cases (a T that is not a multiple of the time
  tile, Dk != Dv, a 64 x 64 head) against ``wkv6_ref`` and the Pallas
  ``wkv6`` in interpret mode: outputs and final states within 2e-4 (the
  reference's tolerance);
* state chaining: two halves with the state carried equal one full run,
  and so do T single steps (the decode path);
* a CPU tensor runs the plain version and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_wkv.ops import wkv6 as r_wkv6
from repro.kernels.rwkv6_wkv.ref import wkv6_ref as r_wkv6_ref
from repro_torch.kernels.rwkv6_wkv import ops, ref


def inputs(seed, b, h, t, dk, dv, w_lo=0.2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, t, dk)).astype(np.float32),
            rng.normal(size=(b, h, t, dk)).astype(np.float32),
            rng.normal(size=(b, h, t, dv)).astype(np.float32),
            rng.uniform(w_lo, 0.99, size=(b, h, t, dk)).astype(np.float32),
            rng.normal(size=(h, dk)).astype(np.float32),
            rng.normal(size=(b, h, dk, dv)).astype(np.float32))


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("b,h,t,dk,dv,bt", [
    (2, 3, 70, 16, 16, 32),   # padded T
    (1, 2, 64, 32, 16, 32),   # dk != dv
    (1, 1, 128, 64, 64, 64),
])
def test_plain_matches_wkv6_ref_and_pallas(b, h, t, dk, dv, bt):
    arrays = inputs(b * 100 + t, b, h, t, dk, dv)
    before = ops.wkv6.launches
    o, s = ops.wkv6(*map(torch.as_tensor, arrays))
    assert ops.wkv6.launches == before  # CPU: no kernel launch
    assert o.shape == (b, h, t, dv) and s.dtype == torch.float32
    for want_o, want_s in (r_wkv6_ref(*map(jnp.asarray, arrays)),
                           r_wkv6(*map(jnp.asarray, arrays), bt, True)):
        close(o, want_o, 2e-4)
        close(s, want_s, 2e-4)


def test_state_chaining():
    """Two halves with the state carried == one full run (as the
    reference's test), and T one-step calls == one full run."""
    r, k, v, w, u, _ = map(torch.as_tensor, inputs(5, 1, 2, 64, 16, 16, 0.5))
    s0 = torch.zeros((1, 2, 16, 16))
    o_full, s_full = ops.wkv6(r, k, v, w, u, s0)
    o1, s1 = ops.wkv6(r[:, :, :32], k[:, :, :32], v[:, :, :32], w[:, :, :32],
                      u, s0)
    o2, s2 = ops.wkv6(r[:, :, 32:], k[:, :, 32:], v[:, :, 32:], w[:, :, 32:],
                      u, s1)
    close(o1, o_full[:, :, :32].numpy(), 1e-5)
    close(o2, o_full[:, :, 32:].numpy(), 1e-4)
    close(s2, s_full.numpy(), 1e-4)
    s, outs = s0, []
    for i in range(64):
        o, s = ops.wkv6(*(x[:, :, i:i + 1] for x in (r, k, v, w)), u, s)
        outs.append(o)
    close(torch.cat(outs, dim=2), o_full.numpy(), 1e-4)
    close(s, s_full.numpy(), 1e-4)
    # the reference's chain on the same inputs
    jo, js = r_wkv6_ref(*(jnp.asarray(x.numpy()) for x in (r, k, v, w, u, s0)))
    close(o_full, jo, 2e-4)
    close(s_full, js, 2e-4)


def test_zero_state_default_and_shape_checks():
    r, k, v, w, u, _ = map(torch.as_tensor, inputs(6, 2, 2, 5, 8, 8))
    o, s = ops.wkv6(r, k, v, w, u, None)
    o0, s0 = ref.wkv6_plain(r, k, v, w, u, torch.zeros((2, 2, 8, 8)))
    assert torch.equal(o, o0) and torch.equal(s, s0)
    with pytest.raises(ValueError, match="u"):
        ops.wkv6(r, k, v, w, u[:1], None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.wkv6(r.double(), k, v, w, u, None)


def kernel_order(r, k, v, w, u, s0):
    """The CUDA kernel's per-thread arithmetic, in numpy float32 scalars:
    one thread per column j, Dk padded to the kernel's register length
    (64 or 128), terms merged on a binary-counter stack."""
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    size = 64 if dk <= 64 else 128
    levels = size.bit_length() - 1
    f = np.float32
    o = np.zeros((b, h, t, dv), np.float32)
    s = s0.astype(np.float32).copy()
    for bb in range(b):
        for hh in range(h):
            for j in range(dv):
                col = s[bb, hh, :, j]
                for tt in range(t):
                    vj = f(v[bb, hh, tt, j])
                    stack = [f(0)] * (levels + 1)
                    for i in range(size):
                        term = f(0)
                        if i < dk:
                            kv = f(k[bb, hh, tt, i]) * vj
                            a = col[i] + f(u[hh, i]) * kv
                            term = f(r[bb, hh, tt, i]) * a
                            col[i] = f(w[bb, hh, tt, i]) * col[i] + kv
                        level = 0
                        for lv in range(levels):
                            if not (i >> lv) & 1:
                                break
                            term = stack[lv] + term
                            level = lv + 1
                        stack[level] = term
                    o[bb, hh, tt, j] = stack[levels]
    return o, s


@pytest.mark.parametrize("dk,dv", [(5, 3), (16, 4), (48, 2), (64, 3), (100, 2)])
def test_kernel_evaluation_order_equals_plain_bit_for_bit(dk, dv):
    """The kernel sums Dk terms on a stack over a register array padded to
    64 or 128; the plain version sums the same terms in a pairwise tree
    padded to the next power of two.  Padding adds exact zeros, so both
    give the same float32 bits (what lets a served run on the kernel
    reproduce the plain run's tokens)."""
    arrays = inputs(dk * 10 + dv, 1, 2, 3, dk, dv)
    want_o, want_s = kernel_order(*arrays)
    o, s = ref.wkv6_plain(*map(torch.as_tensor, arrays))
    np.testing.assert_array_equal(o.numpy(), want_o)
    np.testing.assert_array_equal(s.numpy(), want_s)
