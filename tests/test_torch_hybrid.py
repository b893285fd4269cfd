"""hymba (the hybrid family: attention and a Mamba branch in every layer) in
the port against the JAX reference, on its ``reduced()`` config with the
reference's params carried across by ``params_from_numpy`` and the same
numpy inputs.

* ``mamba_apply`` at T 1 and T > 1, with and without a state, and two calls
  chained (output and state: 1e-5); the port's ``associative_scan``
  against ``jax.lax.associative_scan`` of the same combine;
* ``forward`` logits (1e-4) and ``loss_fn``'s loss (1e-5 relative) and
  every grad leaf (1e-4 of the leaf's largest value) against
  ``jax.value_and_grad``, at the config's window (1,024, past S) and at
  window 8, which masks keys at S 32;
* remat none / full / dots give equal losses and grads;
* ``decode_step`` logits and the ``attn`` + ``mamba`` cache over 8 steps
  (1e-4); decode == prefill within the port (2e-3), also past window 8;
* ``ServeEngine`` tokens and final cache equal the reference's (ROADMAP C8:
  admission advances every slot's Mamba state on pad tokens);
* 3 ``Trainer`` steps equal the reference trainer's;
* the layouts, ``stacked_groups`` and both launchers on the CPU.

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
from repro.models import model as RM
from repro.models import ssm as RS
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServeEngine as RServeEngine
from repro.train import Trainer as RTrainer
from repro.train import TrainerConfig as RTrainerConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.models import ssm as S
from repro_torch.models.convert import (
    cache_from_numpy,
    params_from_numpy,
    params_to_numpy,
    stacked_groups,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import Trainer, TrainerConfig

ARCH = "hymba-1.5b"
BATCH = 2
TOL = 2e-4  # the reference's test_restart_resume_exact tolerance


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


def assert_logits(got: torch.Tensor, want, vocab, tol):
    np.testing.assert_allclose(got.detach().numpy()[..., :vocab],
                               np.asarray(want)[..., :vocab], rtol=tol, atol=tol)


def assert_tree_close(got, want, tol):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(g, np.asarray(w), rtol=tol, atol=tol)


# -- the Mamba branch ---------------------------------------------------------


def mamba_params():
    """Layer 0's Mamba weights: the reference's tree and the port's module."""
    tree = {k: v[0] for k, v in ref_tree()["layers"]["mamba"].items()}
    return tree, S.Mamba(**{k: torch.tensor(v) for k, v in tree.items()})


def mamba_state(seed, cfg):
    rng = np.random.default_rng(seed)
    ed = cfg.ssm.expand * cfg.d_model
    return {"h": rng.standard_normal((BATCH, ed, cfg.ssm.state_dim)
                                     ).astype(np.float32),
            "conv": rng.standard_normal((BATCH, cfg.ssm.conv_width - 1, ed)
                                        ).astype(np.float32)}


def mamba_input(seed, t, d):
    return np.random.default_rng(seed).standard_normal((BATCH, t, d)
                                                       ).astype(np.float32)


def both_mamba(x, state, r_cfg, cfg):
    tree, mod = mamba_params()
    want, want_state = RS.mamba_apply(
        tree, jnp.asarray(x), r_cfg,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    got, got_state = S.mamba_apply(
        mod, torch.tensor(x), cfg,
        state=None if state is None else {k: torch.tensor(v)
                                          for k, v in state.items()})
    return (got, got_state), (want, want_state)


@pytest.mark.parametrize("t", [1, 7, 16])
@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_equals_reference(t, with_state):
    r_cfg, cfg = configs()
    state = mamba_state(5, cfg) if with_state else None
    (got, got_state), (want, want_state) = both_mamba(
        mamba_input(t, t, cfg.d_model), state, r_cfg, cfg)
    assert got.shape == (BATCH, t, cfg.d_model)
    assert got_state["h"].dtype == torch.float32
    assert got_state["conv"].shape == (BATCH, cfg.ssm.conv_width - 1,
                                       cfg.ssm.expand * cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert_tree_close(got_state, want_state, 1e-5)


def test_mamba_calls_chain():
    """Two calls, the second from the first's state, against the reference's
    chain and against one call over the whole sequence."""
    r_cfg, cfg = configs()
    x = mamba_input(9, 12, cfg.d_model)
    (a, st), _ = both_mamba(x[:, :5], None, r_cfg, cfg)
    st = {k: v.numpy() for k, v in st.items()}
    (b, st2), (rb, rst2) = both_mamba(x[:, 5:], st, r_cfg, cfg)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=1e-5, atol=1e-5)
    assert_tree_close(st2, rst2, 1e-5)
    (whole, st_whole), _ = both_mamba(x, None, r_cfg, cfg)
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), whole.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert_tree_close(st2, {k: v.numpy() for k, v in st_whole.items()}, 1e-5)


@pytest.mark.parametrize("t", [1, 2, 3, 8, 13, 32])
def test_associative_scan_follows_jax(t):
    rng = np.random.default_rng(t)
    a = rng.uniform(0.5, 1.0, size=(t, 3, 5)).astype(np.float32)
    b = rng.standard_normal((t, 3, 5)).astype(np.float32)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]

    want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)))
    got = S.associative_scan(S._ssm_combine, (torch.tensor(a), torch.tensor(b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    # the sequential recurrence it computes
    h, seq = np.zeros((3, 5), np.float32), []
    for i in range(t):
        h = a[i] * h + b[i]
        seq.append(h)
    np.testing.assert_allclose(got[1].numpy(), np.stack(seq), rtol=1e-5,
                               atol=1e-5)


# -- forward, loss and grads --------------------------------------------------


WINDOWS = [None, 8]  # None: the config's 1,024, past every S here


def window_fields(window):
    return {} if window is None else {"window": window}


@functools.lru_cache(maxsize=None)
def ref_forward(window):
    r_cfg, _ = configs(**window_fields(window))
    logits, _ = jax.jit(lambda p, t: RM.forward(p, r_cfg, t))(
        ref_params(), jnp.asarray(tokens(2, 32)))
    return np.asarray(logits)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("port_impl", ["ref", "auto"])
def test_forward_equals_reference(port_impl, window):
    _, cfg = configs(port_impl=port_impl, **window_fields(window))
    got, aux = M.forward(port_params(cfg), cfg, tokens(2, 32))
    assert got.shape == ref_forward(window).shape
    assert set(aux) == {"moe_dropped"}
    assert_logits(got, ref_forward(window), cfg.vocab, 1e-4)


def test_window_masks_keys():
    """At window 8 the logits past position 8 differ from the unwindowed
    ones, and the first 8 positions do not."""
    a, b = ref_forward(None), ref_forward(8)
    np.testing.assert_allclose(a[:, :8], b[:, :8], rtol=1e-5, atol=1e-5)
    assert np.abs(a[:, 9:] - b[:, 9:]).max() > 1e-3


def batch(vocab=256, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, -3:] = -1
    return {"tokens": toks, "labels": labels}


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(window):
    r_cfg, _ = configs(**window_fields(window))
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
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


def assert_grads(got, want, rel=1e-4):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        limit = rel * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= limit, jax.tree_util.keystr(path)


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_loss_and_grads_equal_reference(impl, window):
    want_loss, want = ref_loss_and_grads(window)
    loss, got = port_loss_and_grads(impl, **window_fields(window))
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    assert_grads(got, want)
    # the Mamba branch takes gradient: every one of its leaves moves
    assert all(np.abs(g).max() > 0 for name, g in got["layers"]["mamba"].items())


def test_remat_is_exact():
    base_loss, base = port_loss_and_grads()
    for remat in ("full", "dots"):
        loss, grads = port_loss_and_grads(remat=remat)
        np.testing.assert_allclose(loss, base_loss, rtol=1e-6)
        for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(base)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- decode -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_decode():
    """The reference's logits and caches over 8 decode steps."""
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
def test_decode_step_equals_reference(port_impl):
    _, cfg = configs(port_impl=port_impl)
    params = port_params(cfg)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    assert set(cache["layers"]) == {"attn", "mamba"}
    ed = cfg.ssm.expand * cfg.d_model
    assert cache["layers"]["mamba"]["h"].shape == (2, BATCH, ed,
                                                   cfg.ssm.state_dim)
    assert cache["layers"]["mamba"]["conv"].shape == (
        2, BATCH, cfg.ssm.conv_width - 1, ed)
    toks = tokens(1, 8)
    for t, (want, want_cache) in enumerate(ref_decode()):
        got, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        assert got.shape == (BATCH, 1, M.vocab_padded(cfg))
        assert_logits(got, want, cfg.vocab, 1e-4)
        assert_tree_close(cache, want_cache, 1e-4)


@pytest.mark.parametrize("window", WINDOWS)
def test_decode_matches_prefill(window):
    """Teacher-forced decode logits == forward logits, at window 8 over 16
    positions too (the window masks cached keys past position 8)."""
    _, cfg = configs(**window_fields(window))
    params = port_params(cfg)
    toks = tokens(3, 16)
    full, _ = M.forward(params, cfg, toks)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    steps = []
    for t in range(16):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1)[..., : cfg.vocab],
                               full[..., : cfg.vocab], rtol=2e-3, atol=2e-3)


def test_reference_cache_carries_across():
    """A hybrid cache the reference decoded into continues in the port."""
    r_cfg, cfg = configs()
    _, r_cache = ref_decode()[3]
    cache = cache_from_numpy(r_cache, "cpu")
    got, _ = M.decode_step(port_params(cfg), cfg, cache, tokens(1, 8)[:, 4:5], 4)
    assert_logits(got, ref_decode()[4][0], r_cfg.vocab, 1e-4)


# -- serving and training -----------------------------------------------------


def example_requests(vocab=256):
    """examples/serve_batch.py: eight requests on four slots."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=int(rng.integers(2, 10))),
             int(rng.integers(4, 12))) for _ in range(8)]


def test_serve_tokens_and_states_equal_reference():
    """Every admission decodes the whole batch, so each slot's Mamba ``h``
    and conv tail also take the other slots' pad tokens (C8); the port
    keeps that, and so ends on the reference's states."""
    r_cfg, p_cfg = configs()
    scfg = dict(max_batch=4, max_len=96, eos_token=-1)
    ref = RServeEngine(ref_params(), r_cfg, RServeConfig(**scfg))
    port = ServeEngine(port_params(p_cfg), p_cfg, ServeConfig(**scfg))
    for prompt, max_new in example_requests():
        assert ref.submit(prompt, max_new) == port.submit(prompt, max_new)
    want = ref.run_to_completion()
    got = port.run_to_completion()
    assert [(rid, list(t)) for rid, t in got] == [(rid, list(t)) for rid, t in want]
    assert len(got) == 8
    assert_tree_close(port.cache["layers"]["mamba"],
                      jax.tree.map(np.asarray, ref.cache["layers"]["mamba"]),
                      1e-4)


TRAIN = dict(steps=3, lr=3e-3, warmup=1, log_every=1)
TRAIN_KW = dict(global_batch=4, seq_len=16, seed=2)


def test_trainer_steps_equal_reference():
    r_cfg, cfg = configs(remat="full")
    r_params, _, r_hist = RTrainer(r_cfg, RTrainerConfig(**TRAIN),
                                   **TRAIN_KW).run(
        params=jax.tree.map(jnp.asarray, ref_tree()))
    params, _, hist = Trainer(cfg, TrainerConfig(**TRAIN), device="cpu",
                              **TRAIN_KW).run(params=port_params(cfg))
    assert [s for s, _ in hist] == [s for s, _ in r_hist] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for _, m in hist],
                               [m["loss"] for _, m in r_hist], rtol=1e-5)
    got = params_to_numpy(cfg, params)
    assert_tree_close(got, jax.tree.map(np.asarray, r_params), TOL)


# -- layouts ------------------------------------------------------------------


def test_init_params_has_reference_layout():
    _, cfg = configs()
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    carried = port_params(cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in got.state_dict().items()}
    assert shapes == {k: (v.shape, v.dtype)
                      for k, v in carried.state_dict().items()}
    assert M._main_kind(cfg) == "hybrid"
    mamba = got.layers[0].mamba
    n = cfg.ssm.state_dim
    np.testing.assert_allclose(mamba.a_log.numpy(), np.broadcast_to(
        np.log(np.arange(1, n + 1, dtype=np.float32)), mamba.a_log.shape),
        rtol=1e-7)
    assert bool((mamba.d_skip == 1).all()) and bool((mamba.dt_bias == 0).all())
    assert mamba.w_dt.shape[0] == max(1, cfg.d_model // 16)  # dt_rank
    again = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 again.state_dict().values()))
    back = params_to_numpy(cfg, carried)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree())):
        np.testing.assert_array_equal(a, b)


def test_state_trees_and_groups():
    _, cfg = configs()
    named = dict(port_params(cfg).named_parameters())
    state = state_from_numpy(cfg, state_to_numpy(cfg, named), "cpu")
    assert list(state) == list(named)
    assert all(torch.equal(state[k], named[k]) for k in named)
    groups = {tuple(g) for g in stacked_groups(list(named))}
    assert ("layers.0.mamba.a_log", "layers.1.mamba.a_log") in groups


def test_launchers_run_on_cpu():
    done = launch_serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                              "--max-new", "4", "--device", "cpu"])
    assert sorted(rid for rid, _ in done) == [1, 2, 3]
    assert all(len(t) == 4 for _, t in done)
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert [s for s, _ in hist] == [2] and np.isfinite(hist[0][1]["loss"])
