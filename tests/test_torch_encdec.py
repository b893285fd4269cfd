"""seamless-m4t (the encdec family: an encoder stack over frontend frames and
a decoder whose every layer cross-attends to the encoder's memory) in the
port against the JAX reference, on its ``reduced()`` config with the
reference's params carried across by ``params_from_numpy`` and the same
numpy tokens and frames.

* ``forward`` logits (1e-4); ``loss_fn`` with ``batch["frontend"]``: loss
  (1e-5 relative) and every grad leaf, the encoder's, ``enc_norm``'s and
  ``frontend_adapter``'s included (1e-4 of the leaf's largest value),
  against ``jax.value_and_grad``; remat none / full / dots equal;
* ``init_cache(enc_memory_len=F)`` and ``prefill_encoder``'s memory (1e-5);
  ``decode_step`` logits and the cache over 8 steps (1e-4); decode ==
  prefill within the port (2e-3); cross-attention at Sq != Skv in both
  directions;
* ``layer_norm`` against the reference's;
* the layouts: the ``encoder`` stack in the tree, in ``stacked_groups``
  and in the state trees.

The reference's jitted results are computed once per module and shared
through fixtures.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.configs.registry import frontend_len as r_frontend_len
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.configs.registry import frontend_len
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import (
    cache_from_numpy,
    params_from_numpy,
    params_to_numpy,
    stacked_groups,
    state_from_numpy,
    state_to_numpy,
)

ARCH = "seamless-m4t-large-v2"
BATCH = 2
SEQ = 32


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


def frames(seed, seq=SEQ):
    """Stub frontend frames at d_model, ``frontend_len`` of them (64 at any
    S up to 256: audio frames = max(64, S // 4))."""
    cfg = get_config(ARCH).reduced()
    n = frontend_len(cfg, seq)
    assert n == r_frontend_len(r_get_config(ARCH).reduced(), seq)
    return np.random.default_rng(seed).standard_normal(
        (BATCH, n, cfg.d_model)).astype(np.float32)


def assert_logits(got: torch.Tensor, want, vocab, tol):
    np.testing.assert_allclose(got.detach().numpy()[..., :vocab],
                               np.asarray(want)[..., :vocab], rtol=tol, atol=tol)


def assert_tree_close(got, want, tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


# -- forward, loss and grads --------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_forward(seq):
    r_cfg, _ = configs()
    logits, _ = jax.jit(lambda p, t, f: RM.forward(p, r_cfg, t, frontend=f))(
        ref_params(), jnp.asarray(tokens(2, seq)), jnp.asarray(frames(3, seq)))
    return np.asarray(logits)


@pytest.mark.parametrize("seq", [SEQ, 8])
@pytest.mark.parametrize("port_impl", ["ref", "auto"])
def test_forward_equals_reference(port_impl, seq):
    """S 32 and S 8 decoder positions against 64 frames: the encoder's
    attention is square, the cross-attention's has fewer queries than keys
    (``test_cross_attention_equals_reference`` takes more as well)."""
    _, cfg = configs(port_impl=port_impl)
    got, aux = M.forward(port_params(cfg), cfg, tokens(2, seq),
                         frontend=frames(3, seq))
    assert got.shape == ref_forward(seq).shape == (BATCH, seq,
                                                   M.vocab_padded(cfg))
    assert set(aux) == {"moe_dropped"}
    assert_logits(got, ref_forward(seq), cfg.vocab, 1e-4)


def test_frames_reach_the_logits_and_are_required():
    _, cfg = configs()
    params = port_params(cfg)
    a, _ = M.forward(params, cfg, tokens(2, 8), frontend=frames(3, 8))
    b, _ = M.forward(params, cfg, tokens(2, 8), frontend=frames(4, 8))
    assert float((a - b).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="frontend"):
        M.forward(params, cfg, tokens(2, 8))


def batch(vocab=256, b=BATCH, s=SEQ, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, -3:] = -1
    return {"tokens": toks, "labels": labels, "frontend": frames(seed, s)}


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
    loss, metrics = M.loss_fn(lm, cfg, batch())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    assert set(metrics) == {"loss", "moe_dropped"}
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
    # the loss reaches the encoder through every decoder layer's xattn
    for name in ("frontend_adapter", "enc_norm"):
        assert np.abs(got[name]).max() > 0
    assert np.abs(got["encoder"]["attn"]["wq"]).max() > 0


def test_remat_is_exact():
    base_loss, base = port_loss_and_grads()
    for remat in ("full", "dots"):
        loss, grads = port_loss_and_grads(remat=remat)
        np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
        for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(base)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- the memory and decode ----------------------------------------------------


def ref_memory_cache():
    r_cfg, _ = configs()
    f = frames(3, 8)
    cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32,
                             enc_memory_len=f.shape[1])
    return r_cfg, RM.prefill_encoder(ref_params(), r_cfg, jnp.asarray(f), cache)


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
def test_prefill_encoder_memory_equals_reference(port_impl):
    _, cfg = configs(port_impl=port_impl)
    f = frames(3, 8)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu",
                         enc_memory_len=f.shape[1])
    assert set(cache) == {"layers", "memory"}
    assert cache["memory"].shape == (BATCH, f.shape[1], cfg.d_model)
    assert not cache["memory"].any()
    cache = M.prefill_encoder(port_params(cfg), cfg, f, cache)
    _, want = ref_memory_cache()
    np.testing.assert_allclose(cache["memory"].numpy(),
                               np.asarray(want["memory"]), rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def ref_decode():
    """The reference's logits and caches over 8 decode steps after
    ``prefill_encoder``."""
    r_cfg, cache = ref_memory_cache()
    dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, r_cfg, c, t, pos))
    toks, out = tokens(1, 8), []
    for t in range(8):
        logits, cache = dec(ref_params(), cache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return out


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
def test_decode_step_equals_reference(port_impl):
    _, cfg = configs(port_impl=port_impl)
    params = port_params(cfg)
    f = frames(3, 8)
    cache = M.prefill_encoder(params, cfg, f, M.init_cache(
        cfg, BATCH, 16, device="cpu", enc_memory_len=f.shape[1]))
    toks = tokens(1, 8)
    for t, (want, want_cache) in enumerate(ref_decode()):
        got, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        assert got.shape == (BATCH, 1, M.vocab_padded(cfg))
        assert_logits(got, want, cfg.vocab, 1e-4)
        assert_tree_close(cache, want_cache, 1e-4)


def test_decode_matches_prefill():
    _, cfg = configs()
    params = port_params(cfg)
    toks, f = tokens(3, 8), frames(5, 8)
    full, _ = M.forward(params, cfg, toks, frontend=f)
    cache = M.prefill_encoder(params, cfg, f, M.init_cache(
        cfg, BATCH, 16, device="cpu", enc_memory_len=f.shape[1]))
    steps = []
    for t in range(8):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1)[..., : cfg.vocab],
                               full[..., : cfg.vocab], rtol=2e-3, atol=2e-3)


def test_reference_cache_carries_across():
    """A cache the reference filled (memory and 3 steps of K/V) continues in
    the port."""
    r_cfg, cfg = configs()
    _, r_cache = ref_decode()[2]
    cache = cache_from_numpy(r_cache, "cpu")
    got, _ = M.decode_step(port_params(cfg), cfg, cache, tokens(1, 8)[:, 3:4], 3)
    assert_logits(got, ref_decode()[3][0], r_cfg.vocab, 1e-4)


@pytest.mark.parametrize("sq,skv", [(1, 64), (32, 64), (64, 8), (5, 5)])
def test_cross_attention_equals_reference(sq, skv):
    """``_cross_attention`` on layer 0's ``xattn`` at Sq != Skv both ways:
    non-causal, every key seen."""
    _, cfg = configs()
    tree = {k: v[0] for k, v in ref_tree()["layers"]["xattn"].items()}
    rng = np.random.default_rng(sq * 100 + skv)
    xq = rng.standard_normal((BATCH, sq, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((BATCH, skv, cfg.d_model)).astype(np.float32)
    want, _ = RM._cross_attention(tree, jnp.asarray(xq), jnp.asarray(mem),
                                  r_get_config(ARCH).reduced(), "ref")
    got = M._cross_attention(L.GQA(**{k: torch.tensor(v)
                                      for k, v in tree.items()}),
                             torch.tensor(xq), torch.tensor(mem), "kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 48), (1, 7)])
def test_layer_norm_equals_reference(shape, dtype):
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1:]).astype(np.float32)
    bias = rng.standard_normal(shape[-1:]).astype(np.float32)
    if dtype == "bfloat16":
        want = RL.layer_norm(jnp.asarray(x, jnp.bfloat16),
                             jnp.asarray(scale, jnp.bfloat16),
                             jnp.asarray(bias, jnp.bfloat16))
        got = L.layer_norm(torch.tensor(x).bfloat16(),
                           torch.tensor(scale).bfloat16(),
                           torch.tensor(bias).bfloat16())
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=2e-2,
                                   atol=2e-2)
        return
    want = RL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                         eps=1e-6)
    got = L.layer_norm(torch.tensor(x), torch.tensor(scale),
                       torch.tensor(bias), eps=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# -- layouts ------------------------------------------------------------------


def test_init_params_has_reference_layout():
    _, cfg = configs()
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    carried = port_params(cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in got.state_dict().items()}
    assert shapes == {k: (v.shape, v.dtype)
                      for k, v in carried.state_dict().items()}
    assert M._main_kind(cfg) == "decoder_cross"
    assert len(got.encoder) == cfg.n_encoder_layers == 2
    assert got.encoder[0].xattn is None and got.layers[0].xattn is not None
    assert got.frontend_adapter.shape == (cfg.d_model, cfg.d_model)
    assert bool((got.enc_norm == 1).all()) and bool((got.layers[0].norm_x == 1).all())
    back = params_to_numpy(cfg, carried)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree())):
        np.testing.assert_array_equal(a, b)


def test_state_trees_and_groups_span_the_encoder():
    _, cfg = configs()
    named = dict(port_params(cfg).named_parameters())
    state = state_from_numpy(cfg, state_to_numpy(cfg, named), "cpu")
    assert list(state) == list(named)
    assert all(torch.equal(state[k], named[k]) for k in named)
    groups = {tuple(g) for g in stacked_groups(list(named))}
    assert ("encoder.0.attn.wq", "encoder.1.attn.wq") in groups
    assert ("layers.0.xattn.wk", "layers.1.xattn.wk") in groups
    assert ("frontend_adapter",) in groups and ("enc_norm",) in groups


def test_serve_over_an_empty_memory_raises(monkeypatch):
    """ROADMAP C12: ``ServeEngine`` makes its cache without
    ``enc_memory_len``, so seamless decodes against a memory of 0 frames.
    The reference fails there (a reduction over no keys); the port raises
    ``ValueError`` before any attention runs (``--seed 0``, ``--reduced``,
    2 requests, 4 new tokens each, the launchers' own requests)."""
    import sys

    from repro.launch import serve as r_serve
    from repro_torch.launch import serve

    argv = ["--arch", ARCH, "--reduced", "--requests", "2", "--max-new", "4"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])  # its key is seed 0
    with pytest.raises(ValueError):
        r_serve.main()
    with pytest.raises(ValueError, match="empty encoder memory"):
        serve.main([*argv, "--seed", "0", "--device", "cpu"])
