"""The decode kernel's algorithm, split-key flash-decoding, in its plain
form (``ref.mha_split_plain``) against the port's ``mha_plain``, the JAX
reference's ``mha_ref`` and the interpret-mode Pallas kernel, on the same
numpy inputs: float32 within 1e-6.

The CUDA decode kernel cuts a row's visible keys into chunks, keeps a
running (m, l, acc) per chunk and merges the chunks with the log-sum-exp
rescale in a fixed order; a chunk that sees no key (m = -1e30, l = 0) must
weigh 0.  These tests hold that algorithm to the references at the cache
lengths granite's decode reaches (kv_len 1-94), the full 512-row cache,
tile edges (31, 32, 33, 129), GQA groups 1, 4 and 8, a sliding window, and
splits of which some chunks see no key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref
from repro_torch.kernels.flash_attention import ref

TOL = 1e-6
SKV = 512
D = 64


def decode_inputs(seed, group, sq=1, hkv=2, b=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hkv * group, sq, D)).astype(np.float32),
            rng.normal(size=(b, hkv, SKV, D)).astype(np.float32),
            rng.normal(size=(b, hkv, SKV, D)).astype(np.float32))


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=TOL)


def references(q, k, v, kv_len, window, q_offset):
    """mha_plain over the whole cache with kv_len; mha_ref and the Pallas
    kernel (interpret mode) over the first kv_len rows, which is what
    kv_len means."""
    plain = ref.mha_plain(*map(torch.as_tensor, (q, k, v)), window=window,
                          q_offset=q_offset, kv_len=kv_len)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k[:, :, :kv_len], v[:, :, :kv_len]))
    return (plain.numpy(),
            r_mha_ref(jq, jk, jv, causal=True, window=window, q_offset=q_offset),
            r_flash(jq, jk, jv, True, window, q_offset, 64, 64, True))


@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("kv_len", [1, 31, 32, 33, 94, 129, 512])
def test_split_decode_matches_references(kv_len, group):
    q, k, v = decode_inputs(kv_len * 10 + group, group)
    k[:, :, kv_len:] = 1e3  # rows past kv_len would dominate if they leaked
    wants = references(q, k, v, kv_len, None, kv_len - 1)
    for n_splits in (1, 2, 4, 7, 32):
        got = ref.mha_split_plain(*map(torch.as_tensor, (q, k, v)), n_splits,
                                  q_offset=kv_len - 1, kv_len=kv_len)
        assert got.dtype == torch.float32 and got.shape == q.shape
        for want in wants:
            close(got.numpy(), want)


@pytest.mark.parametrize("window", [1, 16, 40])
@pytest.mark.parametrize("kv_len", [33, 94, 512])
def test_split_decode_window(kv_len, window):
    """A sliding window at decode: the chunks before the window see no key
    and must weigh 0."""
    q, k, v = decode_inputs(kv_len + window, 4)
    wants = references(q, k, v, kv_len, window, kv_len - 1)
    for n_splits in (1, 3, 8, 16):
        got = ref.mha_split_plain(*map(torch.as_tensor, (q, k, v)), n_splits,
                                  window=window, q_offset=kv_len - 1,
                                  kv_len=kv_len)
        for want in wants:
            close(got.numpy(), want)


@pytest.mark.parametrize("n_splits", [10, 40, 100])
def test_split_with_empty_chunks(n_splits):
    """More chunks than keys (kv_len 31 in 40 or 100 chunks leaves chunks
    with no key at all), and a multi-row decode (Sq 5) whose causal limits
    differ by row, so some chunks are empty for some rows only."""
    q, k, v = decode_inputs(n_splits, 4, sq=5)
    for kv_len, q_offset in ((31, 26), (94, 89)):
        wants = references(q, k, v, kv_len, None, q_offset)
        got = ref.mha_split_plain(*map(torch.as_tensor, (q, k, v)), n_splits,
                                  q_offset=q_offset, kv_len=kv_len)
        for want in wants:
            close(got.numpy(), want)


def test_split_row_that_sees_nothing_is_zero():
    """kv_len 0: every chunk is empty, so every partial weighs 0 and the row
    is 0 (the kernel's rule; the materializing versions average V instead)."""
    q, k, v = decode_inputs(3, 2)
    got = ref.mha_split_plain(*map(torch.as_tensor, (q, k, v)), 4,
                              q_offset=0, kv_len=0)
    assert torch.equal(got, torch.zeros_like(got))
