"""The port's MLA attention (``models/layers.py::mla_apply`` and its
absorbed decode) against the JAX reference's ``repro.models.layers``, on
the same numpy inputs and the reference's params carried across
(minicpm3-4b ``reduced()``: q_lora 32, kv_lora 16, nope 16, rope 8, v 16,
``d_head=0``).

* prefill (no cache) under the port's "ref" and "kernel" impls (the
  kernel's plain version on a CPU tensor): 1e-4;
* naive and absorbed decode, 8 steps from an empty cache: the output and
  the compressed cache after every step, 1e-4; a step past the cache's end
  (the write clamped as ``dynamic_update_slice`` clamps it), and an
  absorbed step over a 1,100-row cache (a short last block of the 1,024-key
  scan, padded as the reference pads);
* attention gets head dim qk_nope + qk_rope and V padded to it, never
  ``cfg.head_dim``;
* the reference's ``test_mla_absorbed_decode_matches_naive`` in the port:
  2e-3.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy

ARCH = "minicpm3-4b"
B = 2


def configs(absorb=False, impl="ref"):
    r_cfg = dataclasses.replace(r_get_config(ARCH).reduced(), mla_absorb=absorb)
    p_cfg = dataclasses.replace(get_config(ARCH).reduced(), mla_absorb=absorb,
                                attn_impl=impl)
    return r_cfg, p_cfg


@functools.lru_cache(maxsize=None)
def ref_mla():
    p, _ = RL.mla_init(jax.random.PRNGKey(2), configs()[0])
    return jax.tree.map(np.asarray, p)


def port_mla() -> L.MLA:
    return L.MLA(**{name: torch.tensor(a) for name, a in ref_mla().items()})


def inputs(s, seed=0, d=64):
    return np.random.default_rng(seed).normal(size=(B, s, d)).astype(np.float32)


def close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_prefill_equals_reference(impl):
    r_cfg, p_cfg = configs(impl=impl)
    x = inputs(20)
    want, _ = RL.mla_apply(jax.tree.map(jnp.asarray, ref_mla()),
                           jnp.asarray(x), r_cfg)
    got, cache = L.mla_apply(port_mla(), torch.tensor(x), p_cfg,
                             impl=L.resolve_attn_impl(p_cfg))
    assert cache is None
    close(got, want)


def decode_steps(absorb, impl, steps, max_len, start=0, seed=1, fill=False):
    """``steps`` one-token decode steps from position ``start`` in both
    packages, holding the output and the cache after every step."""
    r_cfg, p_cfg = configs(absorb, impl)
    r_cache, _ = RL.mla_cache_init(r_cfg, B, max_len, jnp.float32)
    if fill:  # a cache that earlier steps wrote
        rng = np.random.default_rng(seed + 100)
        r_cache = {k: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                   for k, v in r_cache.items()}
    cache = {k: torch.tensor(np.asarray(v)) for k, v in r_cache.items()}
    x = inputs(steps, seed)
    p_ref = jax.tree.map(jnp.asarray, ref_mla())
    mod = port_mla()
    for t in range(steps):
        pos = start + t
        xt = x[:, t:t + 1]
        want, r_cache = RL.mla_apply(
            p_ref, jnp.asarray(xt), r_cfg, positions=jnp.asarray([pos]),
            cache=r_cache, cache_pos=jnp.asarray(pos, jnp.int32), impl="ref")
        got, cache = L.mla_apply(
            mod, torch.tensor(xt), p_cfg, positions=torch.tensor([pos]),
            cache=cache, cache_pos=pos, impl=L.resolve_attn_impl(p_cfg))
        close(got, want)
        for name in ("ckv", "k_rope"):
            close(cache[name], r_cache[name])


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("absorb", [False, True])
def test_decode_and_cache_equal_reference(absorb, impl):
    decode_steps(absorb, impl, steps=8, max_len=16)


@pytest.mark.parametrize("absorb", [False, True])
def test_decode_past_the_cache_end_clamps_the_write(absorb):
    """cache_pos 15 and 16 in a 16-row cache: the second write lands at row
    15, and kv_len (17) passes the cache's end, in both packages."""
    decode_steps(absorb, "kernel", steps=2, max_len=16, start=15, fill=True)


def test_absorbed_decode_pads_a_short_last_block():
    """1,100 rows: a 1,024-key block and a 76-key one, zero-padded."""
    decode_steps(True, "ref", steps=2, max_len=1100, start=1050, fill=True)


def test_attention_gets_the_mla_head_dims(monkeypatch):
    seen = []
    plain = L.attention_math

    def recording(q, k, v, impl, **kw):
        seen.append((q.shape, k.shape, v.shape))
        return plain(q, k, v, impl, **kw)

    monkeypatch.setattr(L, "attention_math", recording)
    _, p_cfg = configs()
    L.mla_apply(port_mla(), torch.tensor(inputs(5)), p_cfg)
    assert p_cfg.head_dim == 16  # d_model // n_heads, unused by MLA
    # q and k at nope + rope, V at v_head_dim (not padded to the QK width)
    assert seen == [(torch.Size([B, 4, 5, 24]),) * 2 + (torch.Size([B, 4, 5, 16]),)]


@functools.lru_cache(maxsize=None)
def model_params():
    params, _ = RM.init_params(jax.random.PRNGKey(0), configs()[0])
    return jax.tree.map(np.asarray, params)


def test_mla_absorbed_decode_matches_naive():
    """tests/test_optimizations.py::test_mla_absorbed_decode_matches_naive
    in the port (2e-3), with the kernel impl."""
    tokens = np.random.default_rng(1).integers(0, 256, size=(B, 6))

    def run(absorb):
        _, cfg = configs(absorb, "auto")
        lm = params_from_numpy(cfg, model_params(), "cpu")
        cache = M.init_cache(cfg, B, 8, device="cpu")
        assert set(cache["layers"]["attn"]) == {"ckv", "k_rope"}
        outs = []
        for t in range(6):
            lg, cache = M.decode_step(lm, cfg, cache, tokens[:, t:t + 1], t)
            outs.append(lg[:, 0, : cfg.vocab])
        return torch.stack(outs, 1)

    naive, absorbed = run(False), run(True)
    torch.testing.assert_close(absorbed, naive, rtol=2e-3, atol=2e-3)
