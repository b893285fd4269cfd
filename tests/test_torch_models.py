"""The port's LM substrate against the JAX reference, on reduced configs
of the two families it serves (granite-3-2b: dense GQA; rwkv6-7b: RWKV-6),
with the reference's params carried across by ``params_from_numpy``.

* the ten configurations equal the reference's field for field, full and
  reduced;
* ``decode_step`` logits and the cache after every step equal the
  reference's under its ``"ref"`` and ``"xla_flash"`` impls, with the port
  on its plain path (``"ref"``) and its kernel path (``"auto"``, which runs
  the plain versions on a CPU tensor): 1e-4;
* ``forward`` logits equal the reference's: 1e-4;
* decode == prefill within the port, as the reference's arch smoke test
  checks it: 2e-3;
* ``"xla_flash"`` runs and equals the reference's ``xla_flash`` (1e-4),
  and an unknown impl raises ``ValueError`` (the hybrid, encdec and vlm
  families are held in ``tests/test_torch_{hybrid,encdec,vlm}.py``);
* ``init_params`` draws the reference's layouts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as R_ARCHITECTURES
from repro.configs import get_config as r_get_config
from repro.models import model as RM
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.models import model as M
from repro_torch.models.convert import cache_from_numpy, params_from_numpy

ARCHS = ["granite-3-2b", "rwkv6-7b"]
BATCH = 2


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    params, _ = RM.init_params(jax.random.PRNGKey(0), r_get_config(arch).reduced())
    return params


def configs(arch, ref_impl, port_impl):
    return (dataclasses.replace(r_get_config(arch).reduced(), attn_impl=ref_impl),
            dataclasses.replace(get_config(arch).reduced(), attn_impl=port_impl))


def port_params(arch, cfg):
    return params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params(arch)), "cpu")


def tokens(seed, length, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(BATCH, length)
                                                ).astype(np.int32)


def assert_logits(got: torch.Tensor, want, vocab, tol):
    np.testing.assert_allclose(got.numpy()[..., :vocab],
                               np.asarray(want)[..., :vocab], rtol=tol, atol=tol)


def test_configs_equal_reference():
    assert ARCHITECTURES == R_ARCHITECTURES
    for arch in ARCHITECTURES:
        for port, ref in ((get_config(arch), r_get_config(arch)),
                          (get_config(arch).reduced(), r_get_config(arch).reduced())):
            assert dataclasses.asdict(port) == dataclasses.asdict(ref), arch
            assert port.head_dim == ref.head_dim
            assert port.total_params == ref.total_params


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
@pytest.mark.parametrize("ref_impl", ["ref", "xla_flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_equals_reference(arch, ref_impl, port_impl):
    r_cfg, p_cfg = configs(arch, ref_impl, port_impl)
    params = port_params(arch, p_cfg)
    r_cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32)
    cache = M.init_cache(p_cfg, BATCH, 16, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, r_cfg, c, t, pos))
    toks = tokens(1, 8, r_cfg.vocab)
    for t in range(8):
        want, r_cache = dec(ref_params(arch), r_cache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        got, cache = M.decode_step(params, p_cfg, cache, toks[:, t:t + 1], t)
        assert got.shape == (BATCH, 1, M.vocab_padded(p_cfg))
        assert_logits(got, want, r_cfg.vocab, 1e-4)
        assert bool((got[..., p_cfg.vocab:] <= -1e29).all())  # padded columns
    want_cache = jax.tree.map(np.asarray, r_cache)
    assert jax.tree.structure(want_cache) == jax.tree.structure(cache)
    for w, g in zip(jax.tree.leaves(want_cache), jax.tree.leaves(cache)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("ref_impl", ["ref", "xla_flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch, ref_impl):
    r_cfg, p_cfg = configs(arch, ref_impl, "auto")
    toks = tokens(2, 24, r_cfg.vocab)
    want, _ = jax.jit(lambda p, t: RM.forward(p, r_cfg, t))(ref_params(arch),
                                                            jnp.asarray(toks))
    got, _ = M.forward(port_params(arch, p_cfg), p_cfg, torch.as_tensor(toks))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_logits(got, want, r_cfg.vocab, 1e-4)
    # last_only unembeds one position (a smaller GEMM, summed in its own order)
    last, _ = M.forward(port_params(arch, p_cfg), p_cfg, toks, last_only=True)
    torch.testing.assert_close(last, got[:, -1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode step logits == forward logits (as
    tests/test_arch_smoke.py::test_decode_matches_prefill)."""
    _, cfg = configs(arch, "ref", "auto")
    params = port_params(arch, cfg)
    toks = tokens(3, 8, cfg.vocab)
    full, _ = M.forward(params, cfg, toks)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    steps = []
    for t in range(8):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1)[..., : cfg.vocab],
                               full[..., : cfg.vocab], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_xla_flash_raises(arch):
    """ROADMAP A14: ``"xla_flash"`` no longer raises; its decode and forward
    equal the reference's ``xla_flash``.  An impl neither package knows
    raises ``ValueError``, naming the choices."""
    r_cfg, cfg = configs(arch, "xla_flash", "xla_flash")
    params = port_params(arch, cfg)
    toks = tokens(4, 4, cfg.vocab)
    want, _ = jax.jit(lambda p, t: RM.forward(p, r_cfg, t))(ref_params(arch),
                                                            jnp.asarray(toks))
    assert_logits(M.forward(params, cfg, toks)[0], want, cfg.vocab, 1e-4)
    r_cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32)
    want, _ = RM.decode_step(ref_params(arch), r_cfg, r_cache,
                             jnp.asarray(toks[:, :1]), 0)
    got, _ = M.decode_step(params, cfg, M.init_cache(cfg, BATCH, 16,
                                                     device="cpu"),
                           toks[:, :1], 0)
    assert_logits(got, want, cfg.vocab, 1e-4)
    bad = dataclasses.replace(cfg, attn_impl="xla-flash")
    with pytest.raises(ValueError, match="xla_flash"):
        M.forward(params, bad, toks)


@pytest.mark.parametrize("arch", ARCHS + ["starcoder2-15b"])
def test_init_params_has_reference_layout(arch):
    cfg = get_config(arch).reduced()
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    carried = params_from_numpy(cfg, jax.tree.map(
        np.asarray, RM.init_params(jax.random.PRNGKey(0), r_get_config(arch).reduced())[0]),
        "cpu")
    shapes = {k: (v.shape, v.dtype) for k, v in got.state_dict().items()}
    assert shapes == {k: (v.shape, v.dtype) for k, v in carried.state_dict().items()}
    # the same draws from the same seed; the norms start at one
    again = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 again.state_dict().values()))
    assert bool((got.final_norm == 1).all())


def test_cache_from_numpy_round_trips():
    r_cfg, p_cfg = configs("rwkv6-7b", "ref", "auto")
    r_cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32)
    params = port_params("rwkv6-7b", p_cfg)
    _, r_cache = RM.decode_step(ref_params("rwkv6-7b"), r_cfg, r_cache,
                                jnp.asarray(tokens(5, 1, r_cfg.vocab)),
                                jnp.asarray(0, jnp.int32))
    cache = cache_from_numpy(jax.tree.map(np.asarray, r_cache), "cpu")
    toks = tokens(6, 1, r_cfg.vocab)
    want, _ = RM.decode_step(ref_params("rwkv6-7b"), r_cfg, r_cache,
                             jnp.asarray(toks), jnp.asarray(1, jnp.int32))
    got, _ = M.decode_step(params, p_cfg, cache, toks, 1)
    assert_logits(got, want, r_cfg.vocab, 1e-4)
