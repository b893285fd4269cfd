"""internvl2 (the vlm family: patch embeddings prepended to the text) in the
port against the JAX reference, on its ``reduced()`` config with the
reference's params carried across by ``params_from_numpy``, and the port's
registry against the reference's.

* ``forward`` logits at the text positions only (1e-4), with 8 patches;
  ``loss_fn`` with ``batch["frontend"]``: loss (1e-5 relative) and every
  grad leaf, ``frontend_adapter``'s included (1e-4 of the leaf's largest
  value), against ``jax.value_and_grad``;
* the text-only ``decode_step`` (the reference's "prefix cache
  semantics") and its cache over 8 steps (1e-4), decode == a text-only
  prefill within the port (2e-3), and ``ServeEngine`` tokens;
* the registry: ``SHAPES``, ``shape_applicable``, ``all_cells()`` (40)
  and ``frontend_len`` equal the reference's;
* the reference's ``test_active_param_accounting`` on the port's configs,
  and every config's parameter counts equal the reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs import registry as r_registry
from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServeEngine as RServeEngine
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.configs import registry
from repro_torch.models import model as M
from repro_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.serve import ServeConfig, ServeEngine

ARCH = "internvl2-26b"
BATCH = 2
SEQ = 24


def configs(ref_impl="ref", port_impl="auto", **fields):
    return [dataclasses.replace(cfg, attn_impl=impl, **fields)
            for cfg, impl in ((r_get_config(ARCH).reduced(), ref_impl),
                              (get_config(ARCH).reduced(), port_impl))]


@functools.lru_cache(maxsize=None)
def ref_params():
    params, _ = RM.init_params(jax.random.PRNGKey(0), r_get_config(ARCH).reduced())
    return params


@functools.lru_cache(maxsize=None)
def ref_tree():
    return jax.tree.map(np.asarray, ref_params())


def port_params(cfg):
    return params_from_numpy(cfg, ref_tree(), "cpu")


def tokens(seed, length, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(BATCH, length)
                                                ).astype(np.int32)


def patches(seed):
    cfg = get_config(ARCH).reduced()
    n = registry.frontend_len(cfg, SEQ)
    assert n == cfg.frontend_seq == 8
    return np.random.default_rng(seed).standard_normal(
        (BATCH, n, cfg.d_model)).astype(np.float32)


def assert_logits(got: torch.Tensor, want, vocab, tol):
    np.testing.assert_allclose(got.detach().numpy()[..., :vocab],
                               np.asarray(want)[..., :vocab], rtol=tol, atol=tol)


# -- forward, loss and grads --------------------------------------------------


@pytest.fixture(scope="module")
def ref_forward():
    r_cfg, _ = configs()
    logits, _ = jax.jit(lambda p, t, f: RM.forward(p, r_cfg, t, frontend=f))(
        ref_params(), jnp.asarray(tokens(2, SEQ)), jnp.asarray(patches(3)))
    return np.asarray(logits)


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
def test_forward_equals_reference(ref_forward, port_impl):
    _, cfg = configs(port_impl=port_impl)
    got, aux = M.forward(port_params(cfg), cfg, tokens(2, SEQ),
                         frontend=patches(3))
    # the text positions only: the 8-patch prefix is cut before the norm
    assert got.shape == ref_forward.shape == (BATCH, SEQ, M.vocab_padded(cfg))
    assert set(aux) == {"moe_dropped"}
    assert_logits(got, ref_forward, cfg.vocab, 1e-4)
    last, _ = M.forward(port_params(cfg), cfg, tokens(2, SEQ),
                        frontend=patches(3), last_only=True)
    assert_logits(last, ref_forward[:, -1:], cfg.vocab, 1e-4)


def test_patches_reach_the_text_and_are_required():
    _, cfg = configs()
    params = port_params(cfg)
    a, _ = M.forward(params, cfg, tokens(2, 8), frontend=patches(3))
    b, _ = M.forward(params, cfg, tokens(2, 8), frontend=patches(4))
    assert float((a - b).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="frontend"):
        M.forward(params, cfg, tokens(2, 8))


def batch(vocab=256, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(BATCH, SEQ)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(BATCH, SEQ)).astype(np.int32)
    labels[1, :2] = -1
    return {"tokens": toks, "labels": labels, "frontend": patches(seed)}


@pytest.fixture(scope="module")
def ref_loss_and_grads():
    r_cfg, _ = configs()
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, r_cfg, b), has_aux=True))(ref_params(), b)
    return float(loss), jax.tree.map(np.asarray, grads)


def port_loss_and_grads(impl="auto", **fields):
    _, cfg = configs(port_impl=impl, **fields)
    lm = port_params(cfg)
    lm.requires_grad_(True)
    named = dict(lm.named_parameters())
    loss, _ = M.loss_fn(lm, cfg, batch())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), state_to_numpy(cfg, dict(zip(named, grads)))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_loss_and_grads_equal_reference(ref_loss_and_grads, impl):
    want_loss, want = ref_loss_and_grads
    loss, got = port_loss_and_grads(impl)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        limit = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= limit, jax.tree_util.keystr(path)
    assert np.abs(got["frontend_adapter"]).max() > 0


def test_remat_is_exact():
    base_loss, base = port_loss_and_grads()
    for remat in ("full", "dots"):
        loss, grads = port_loss_and_grads(remat=remat)
        np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
        for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(base)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- text-only decode and serving ---------------------------------------------


@pytest.fixture(scope="module")
def ref_decode():
    r_cfg, _ = configs()
    cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32)
    dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, r_cfg, c, t, pos))
    toks, out = tokens(1, 8), []
    for t in range(8):
        logits, cache = dec(ref_params(), cache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return out


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
def test_decode_step_equals_reference(ref_decode, port_impl):
    _, cfg = configs(port_impl=port_impl)
    params = port_params(cfg)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    assert set(cache) == {"layers"} and set(cache["layers"]) == {"attn"}
    toks = tokens(1, 8)
    for t, (want, want_cache) in enumerate(ref_decode):
        got, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        assert_logits(got, want, cfg.vocab, 1e-4)
        assert jax.tree.structure(want_cache) == jax.tree.structure(cache)
        for w, g in zip(jax.tree.leaves(want_cache), jax.tree.leaves(cache)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_decode_matches_text_prefill():
    """The decode is text only: it equals ``forward`` on the text with an
    empty (B, 0, d) prefix."""
    _, cfg = configs()
    params = port_params(cfg)
    toks = tokens(3, 8)
    full, _ = M.forward(params, cfg, toks, frontend=np.zeros(
        (BATCH, 0, cfg.d_model), np.float32))
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    steps = []
    for t in range(8):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1)[..., : cfg.vocab],
                               full[..., : cfg.vocab], rtol=2e-3, atol=2e-3)


def test_serve_tokens_equal_reference():
    r_cfg, p_cfg = configs()
    scfg = dict(max_batch=4, max_len=96, eos_token=-1)
    ref = RServeEngine(ref_params(), r_cfg, RServeConfig(**scfg))
    port = ServeEngine(port_params(p_cfg), p_cfg, ServeConfig(**scfg))
    rng = np.random.default_rng(0)
    for _ in range(6):
        prompt = rng.integers(0, 256, size=int(rng.integers(2, 10)))
        max_new = int(rng.integers(4, 12))
        assert ref.submit(prompt, max_new) == port.submit(prompt, max_new)
    want = ref.run_to_completion()
    got = port.run_to_completion()
    assert [(rid, list(t)) for rid, t in got] == [(rid, list(t)) for rid, t in want]


# -- layouts and the registry -------------------------------------------------


def test_params_round_trip():
    _, cfg = configs()
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    carried = port_params(cfg)
    assert {k: v.shape for k, v in got.state_dict().items()} == {
        k: v.shape for k, v in carried.state_dict().items()}
    assert M._main_kind(cfg) == "dense" and len(got.encoder) == 0
    assert got.frontend_adapter.shape == (cfg.d_model, cfg.d_model)
    back = params_to_numpy(cfg, carried)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree())):
        np.testing.assert_array_equal(a, b)
    named = dict(carried.named_parameters())
    assert list(state_from_numpy(cfg, state_to_numpy(cfg, named), "cpu")) \
        == list(named)


def test_shapes_equal_reference():
    assert list(registry.SHAPES) == list(r_registry.SHAPES)
    for name, spec in registry.SHAPES.items():
        assert dataclasses.astuple(spec) == dataclasses.astuple(
            r_registry.SHAPES[name])


def test_all_cells_equal_reference():
    cells = registry.all_cells()
    assert len(cells) == 40
    assert cells == r_registry.all_cells()
    # only the sub-quadratic families run long_500k
    runnable = {a for a, s, skip in cells if s == "long_500k" and skip is None}
    assert runnable == {"hymba-1.5b", "rwkv6-7b"}


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_shape_rules_equal_reference(arch):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    for name, spec in registry.SHAPES.items():
        assert registry.shape_applicable(cfg, spec) == \
            r_registry.shape_applicable(r_cfg, r_registry.SHAPES[name])
    for seq in (1, 8, 255, 256, 512, 4_096, 32_768):
        for c, rc in ((cfg, r_cfg), (cfg.reduced(), r_cfg.reduced())):
            assert registry.frontend_len(c, seq) == r_registry.frontend_len(rc, seq)


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_param_counts_equal_reference(arch):
    cfg, r_cfg = get_config(arch), r_get_config(arch)
    assert cfg.total_params == r_cfg.total_params
    assert cfg.active_params_per_token == r_cfg.active_params_per_token


def test_active_param_accounting():
    """The reference's ``test_active_param_accounting`` on the port's
    configs."""
    cfg = get_config("deepseek-v3-671b")
    total = cfg.total_params
    active = cfg.active_params_per_token
    assert 500e9 < total < 900e9, f"deepseek total {total/1e9:.0f}B off"
    assert 25e9 < active < 60e9, f"deepseek active {active/1e9:.0f}B off"
    g8 = get_config("granite-3-8b")
    assert 6e9 < g8.total_params < 11e9
