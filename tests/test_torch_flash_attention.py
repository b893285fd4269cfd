"""The port's flash attention (plain version on the CPU) against the JAX
reference, on the same numpy inputs.

* the eight cases of the reference's kernel sweep (GQA, a padded sequence,
  MQA with a sliding window, bidirectional; float32 and bfloat16) against
  ``mha_ref`` and the Pallas ``flash_attention`` in interpret mode, called
  eagerly: float32 within 2e-5, bfloat16 within 2e-2 (the reference's own
  tolerances);
* the decode offset case, and ``kv_len``, which masks keys at or past it
  (the port's decode passes it; the reference's kernel branch drops it,
  ROADMAP C7);
* ROADMAP C6: the reference's jitted decode cannot reach its kernel (the
  traced position is a non-differentiable ``custom_vjp`` argument), while
  the port's decode with ``attn_impl="kernel"`` runs and equals the
  reference's ``"ref"`` decode.

On a CPU tensor the wrapper runs the plain version and launches nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.flash_attention.ref import mha_ref as r_mha_ref
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy

CASES = [  # (b, hq, hkv, s, d, causal, window), as tests/test_kernels.py
    (2, 4, 2, 128, 32, True, None),
    (1, 8, 8, 96, 16, True, None),    # padded seq
    (1, 4, 1, 64, 64, True, 32),      # MQA + sliding window
    (2, 2, 2, 80, 32, False, None),   # bidirectional (encoder)
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def qkv(rng, b, hq, hkv, sq, skv, d):
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_mha_ref_and_pallas(case, dtype):
    b, hq, hkv, s, d, causal, window = case
    jdt, tdt, tol = DTYPES[dtype]
    arrays = qkv(np.random.default_rng(sum(case[:5])), b, hq, hkv, s, s, d)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.as_tensor(a).to(tdt) for a in arrays)
    before = ops.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal, window)
    assert ops.flash_attention.launches == before  # CPU: no kernel launch
    assert got.dtype == tdt and got.shape == tq.shape
    close(got, r_mha_ref(jq, jk, jv, causal=causal, window=window), tol)
    close(got, r_flash(jq, jk, jv, causal, window, 0, 64, 64, True), tol)


def test_decode_offset():
    q, k, v = qkv(np.random.default_rng(7), 2, 4, 2, 1, 100, 32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    for kv_len in (None, 100):
        got = ops.flash_attention(tq, tk, tv, True, None, 99, kv_len)
        close(got, r_mha_ref(jq, jk, jv, causal=True, q_offset=99), 2e-5)
        close(got, r_flash(jq, jk, jv, True, None, 99, 64, 64, True), 2e-5)


@pytest.mark.parametrize("window", [None, 8])
def test_kv_len_masks_the_tail(window):
    """Keys at or past kv_len do not count: the same as attending over the
    first kv_len keys only (decode at position 60 of a 100-row cache)."""
    q, k, v = qkv(np.random.default_rng(8), 2, 4, 2, 1, 100, 32)
    k[:, :, 61:] = 1e3  # garbage past kv_len would dominate if it leaked
    got = ops.flash_attention(*map(torch.as_tensor, (q, k, v)), True, window,
                              60, 61)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k[:, :, :61], v[:, :, :61]))
    close(got, r_mha_ref(jq, jk, jv, causal=True, window=window, q_offset=60),
          2e-5)
    close(got, r_flash(jq, jk, jv, True, window, 60, 64, 64, True), 2e-5)
    # causal masking alone already hides the tail (why C7 is harmless)
    close(ref.mha_plain(*map(torch.as_tensor, (q, k, v)), window=window,
                        q_offset=60), np.asarray(got), 2e-5)


def test_jitted_kernel_decode_raises_in_reference_not_in_port():
    """ROADMAP C6."""
    r_cfg = r_get_config("granite-3-2b").reduced()
    params, _ = RM.init_params(jax.random.PRNGKey(0), r_cfg)
    toks = np.array([[3], [7]], np.int32)
    k_cfg = dataclasses.replace(r_cfg, attn_impl="kernel")
    dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, k_cfg, c, t, pos))
    cache, _ = RM.init_cache(k_cfg, 2, 16, jnp.float32)
    with pytest.raises(jax.errors.UnexpectedTracerError,
                       match="non-differentiable"):
        dec(params, cache, jnp.asarray(toks), jnp.asarray(0, jnp.int32))

    cache, _ = RM.init_cache(r_cfg, 2, 16, jnp.float32)
    want, _ = RM.decode_step(params, r_cfg, cache, jnp.asarray(toks),
                             jnp.asarray(0, jnp.int32))
    p_cfg = dataclasses.replace(get_config("granite-3-2b").reduced(),
                                attn_impl="kernel")
    port = params_from_numpy(p_cfg, jax.tree.map(np.asarray, params), "cpu")
    got, _ = M.decode_step(port, p_cfg, M.init_cache(p_cfg, 2, 16, device="cpu"),
                           torch.as_tensor(toks), 0)
    np.testing.assert_allclose(got.numpy()[..., : p_cfg.vocab],
                               np.asarray(want)[..., : p_cfg.vocab],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["kv_len_0", "before_every_key",
                                  "windowed_out", "no_keys"])
def test_row_that_sees_no_key_is_zero(case):
    """ROADMAP C12: a row that sees no key comes out 0 in the plain version,
    as in the kernel and ``mha_split_plain``; a row that sees a key is the
    softmax as before (``mha_ref`` on the visible keys)."""
    skv = 0 if case == "no_keys" else 40
    q, k, v = qkv(np.random.default_rng(11), 2, 4, 2, 6, skv, 16)
    kw = {"kv_len_0": dict(q_offset=10, kv_len=0),
          "before_every_key": dict(q_offset=-3),
          "windowed_out": dict(q_offset=30, window=4, kv_len=20),
          "no_keys": dict(q_offset=0)}[case]
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = ref.mha_plain(tq, tk, tv, causal=True, **kw)
    assert got.shape == tq.shape and torch.isfinite(got).all()
    mask = ref.visible_mask(6, skv, causal=True, **kw)
    seen = mask.any(-1)
    assert torch.equal(got[:, :, ~seen], torch.zeros_like(got[:, :, ~seen]))
    if case == "before_every_key":  # rows 3-5 see keys 0..row-3
        assert seen.tolist() == [False] * 3 + [True] * 3
        jq, jk, jv = (jnp.asarray(a) for a in (q[:, :, 3:], k, v))
        close(got[:, :, 3:], r_mha_ref(jq, jk, jv, causal=True), 2e-5)
    else:
        assert not seen.any()
    assert torch.equal(ops.flash_attention(tq, tk, tv, True, kw.get("window"),
                                           kw["q_offset"], kw.get("kv_len")),
                       got)
