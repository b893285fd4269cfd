"""The port's ``xla_flash`` attention route (ROADMAP A14) against the
reference's ``xla_flash_attention``.

* function level, float32, within 2e-5: causal, windowed, an offset query
  chunk with ``kv_len``, GQA groups 1, 4 and 5, Skv not a multiple of the
  512-key block, and a block size that cuts the keys in several blocks;
* V narrower than q and k (MLA's head): the first Dv columns of the
  reference's output on V padded to D;
* model level, the mirror of the reference's
  ``test_xla_flash_equals_ref_model_level``: reduced granite-3-2b on (2,
  24) tokens, the logits under ``xla_flash`` against the port's ``kernel``
  impl (its plain version on the CPU) and against the reference's
  ``xla_flash`` forward with the same params, within 2e-3;
* ``"auto"`` still resolves to the kernel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import model as RM
from repro.models.layers import xla_flash_attention as r_xla_flash
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy

CASES = {  # (b, hq, hkv, sq, skv, d, kwargs)
    "causal": (2, 4, 4, 64, 64, 32, dict(causal=True)),
    "gqa4": (2, 8, 2, 48, 48, 16, dict(causal=True)),
    "gqa5_window": (1, 10, 2, 40, 40, 16, dict(causal=True, window=8)),
    "noncausal_ragged": (2, 4, 1, 30, 700, 32, dict(causal=False)),
    "offset_kv_len": (2, 8, 2, 5, 600, 32,
                      dict(causal=True, q_offset=400, kv_len=405)),
    "decode": (3, 4, 4, 1, 100, 64, dict(causal=True, q_offset=60,
                                         kv_len=61)),
    "windowed_decode_blocks": (2, 10, 2, 1, 300, 16,
                               dict(causal=True, window=50, q_offset=250,
                                    kv_len=251, block_k=64)),
    "prefill_blocks": (1, 4, 2, 130, 130, 16, dict(causal=True, block_k=32)),
}


def arrays(seed, b, hq, hkv, sq, skv, d, dv=None):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, dv or d), dtype=np.float32))


@pytest.mark.parametrize("name", CASES)
def test_equals_reference(name):
    b, hq, hkv, sq, skv, d, kw = CASES[name]
    q, k, v = arrays(len(name), b, hq, hkv, sq, skv, d)
    want = r_xla_flash(*map(jnp.asarray, (q, k, v)), **kw)
    got = L.xla_flash_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    # and through attention_math, as a model reaches it
    if "block_k" not in kw:
        via = L.attention_math(*map(torch.as_tensor, (q, k, v)), "xla_flash",
                               **kw)
        assert torch.equal(via, got)


def test_narrow_v_is_the_padded_references_first_columns():
    q, k, v = arrays(3, 2, 4, 2, 20, 20, 24, dv=16)
    want = r_xla_flash(jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(np.pad(v, ((0, 0),) * 3 + ((0, 8),))))
    got = L.xla_flash_attention(*map(torch.as_tensor, (q, k, v)))
    assert got.shape == (2, 4, 20, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., :16],
                               rtol=2e-5, atol=2e-5)


def test_bf16_keeps_q_dtype():
    q, k, v = (torch.as_tensor(a).bfloat16()
               for a in arrays(4, 1, 4, 2, 16, 16, 16))
    got = L.xla_flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    want = L.attention_math(q, k, v, "ref")
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_row_that_sees_no_key_is_zero():
    """The port's zero row (ROADMAP C12); the reference's gives the mean of
    V there, which no model path reaches."""
    q, k, v = map(torch.as_tensor, arrays(5, 1, 4, 2, 4, 16, 16))
    got = L.xla_flash_attention(q, k, v, q_offset=-2)
    assert torch.equal(got[:, :, :2], torch.zeros_like(got[:, :, :2]))
    torch.testing.assert_close(got, L.attention_math(q, k, v, "ref",
                                                     q_offset=-2),
                               rtol=2e-5, atol=2e-5)
    assert torch.equal(L.xla_flash_attention(q, k, v, kv_len=0),
                       torch.zeros_like(q))


def test_auto_resolves_to_the_kernel():
    cfg = get_config("granite-3-2b")
    assert L.resolve_attn_impl(cfg) == "kernel"
    assert L.resolve_attn_impl(
        dataclasses.replace(cfg, attn_impl="xla_flash")) == "xla_flash"


def test_xla_flash_equals_kernel_and_reference_model_level():
    """The reference's ``test_xla_flash_equals_ref_model_level`` mirrored:
    granite-3-2b reduced, (2, 24) tokens."""
    r_cfg = dataclasses.replace(r_get_config("granite-3-2b").reduced(),
                                attn_impl="xla_flash")
    r_params, _ = RM.init_params(jax.random.PRNGKey(0), r_cfg)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0,
                                           r_cfg.vocab))
    cfg = get_config("granite-3-2b").reduced()
    cfg_fla = dataclasses.replace(cfg, attn_impl="xla_flash")
    cfg_ker = dataclasses.replace(cfg, attn_impl="kernel")
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, r_params), "cpu")
    got = M.forward(params, cfg_fla, tokens)[0][..., :cfg.vocab].numpy()
    ker = M.forward(params, cfg_ker, tokens)[0][..., :cfg.vocab].numpy()
    want = np.asarray(RM.forward(r_params, r_cfg, jnp.asarray(tokens))[0]
                      )[..., :cfg.vocab]
    np.testing.assert_allclose(got, ker, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
