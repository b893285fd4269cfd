"""deepseek-v3 in the port against the JAX reference, on its ``reduced()``
config (1 dense + 1 MoE layer, MLA 16 + 8 / 16, a shared expert, the router
bias, the MTP head) with the reference's params carried across by
``params_from_numpy`` and the same numpy inputs.

* ``forward`` logits, ``mtp_logits`` and ``moe_dropped``: 1e-4;
* ``loss_fn`` on both routes (full logits, and ``ce_chunk`` 128, which
  divides the padded vocab): loss and ``mtp_loss`` within 1e-5 relative,
  every grad leaf within 1e-4 of its largest value, against
  ``jax.value_and_grad``;
* ``decode_step`` logits and the two-stack cache over 6 steps, absorbed and
  naive: 1e-4; decode == prefill within the port: 2e-3;
* ``ServeEngine`` tokens equal the reference's;
* 3 ``Trainer`` steps equal the reference trainer's (losses 1e-5 relative,
  params 2e-4), and a checkpoint written by either package's trainer is
  finished by the other's;
* the layouts: ``init_params`` draws the reference's tree, the cache holds
  ``layers`` and ``dense_layers``, ``stacked_groups`` spans each stack;
* the reference's ``test_active_param_accounting`` on the port's config;
  both launchers on the CPU.

The reference's jitted results are computed once per module (its reduced
deepseek compiles slowly) and shared through fixtures.
"""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.models import model as RM
from repro.serve import ServeConfig as RServeConfig
from repro.serve import ServeEngine as RServeEngine
from repro.train import Trainer as RTrainer
from repro.train import TrainerConfig as RTrainerConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
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

ARCH = "deepseek-v3-671b"
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


# -- forward ------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_forward():
    r_cfg, _ = configs()
    logits, aux = jax.jit(lambda p, t: RM.forward(p, r_cfg, t))(
        ref_params(), jnp.asarray(tokens(2, 32)))
    return logits, aux


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
def test_forward_equals_reference(ref_forward, port_impl):
    want, want_aux = ref_forward
    _, cfg = configs(port_impl=port_impl)
    got, aux = M.forward(port_params(cfg), cfg, tokens(2, 32))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert set(aux) == {"moe_dropped", "mtp_logits"}
    assert_logits(got, want, cfg.vocab, 1e-4)
    assert_logits(aux["mtp_logits"], want_aux["mtp_logits"], cfg.vocab, 1e-4)
    np.testing.assert_allclose(float(aux["moe_dropped"]),
                               float(want_aux["moe_dropped"]), atol=1e-4)


def test_last_only_and_hidden_skip_the_mtp_head():
    _, cfg = configs()
    params = port_params(cfg)
    logits, aux = M.forward(params, cfg, tokens(2, 8), last_only=True)
    assert logits.shape[1] == 1 and "mtp_logits" not in aux
    h, aux = M.forward(params, cfg, tokens(2, 8), return_hidden=True)
    assert h.shape == (BATCH, 8, cfg.d_model) and "mtp_logits" not in aux


# -- loss and grads -----------------------------------------------------------


def batch(vocab=256, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, -3:] = -1
    return {"tokens": toks, "labels": labels}


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(ce_chunk):
    r_cfg, _ = configs(ce_chunk=ce_chunk)
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, r_cfg, b), has_aux=True))(ref_params(), b)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def port_loss_and_grads(impl="auto", **fields):
    _, cfg = configs(port_impl=impl, **fields)
    lm = port_params(cfg)
    lm.requires_grad_(True)
    named = dict(lm.named_parameters())
    loss, metrics = M.loss_fn(lm, cfg, batch())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    assert float(metrics["loss"].detach()) == float(loss.detach())
    return ({k: float(torch.as_tensor(v).detach()) for k, v in metrics.items()},
            state_to_numpy(cfg, dict(zip(named, grads))))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("ce_chunk", [0, 128])
def test_loss_and_grads_equal_reference(ce_chunk, impl):
    want_metrics, want = ref_loss_and_grads(ce_chunk)
    metrics, got = port_loss_and_grads(impl, ce_chunk=ce_chunk)
    assert set(metrics) == set(want_metrics) == {"loss", "moe_dropped",
                                                 "mtp_loss"}
    for name in ("loss", "mtp_loss"):
        np.testing.assert_allclose(metrics[name], want_metrics[name], rtol=1e-5)
    # the MTP loss enters the total exactly once, at weight 0.3
    assert metrics["loss"] > 0.3 * metrics["mtp_loss"]
    np.testing.assert_allclose(metrics["moe_dropped"],
                               want_metrics["moe_dropped"], atol=1e-6)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        limit = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= limit, jax.tree_util.keystr(path)


def test_both_loss_routes_agree_and_remat_is_exact():
    base, grads = port_loss_and_grads(ce_chunk=0)
    for fields in (dict(ce_chunk=128), dict(remat="full"), dict(remat="dots")):
        metrics, other = port_loss_and_grads(**fields)
        for name in ("loss", "mtp_loss"):
            np.testing.assert_allclose(metrics[name], base[name], rtol=1e-6)
        for g, w in zip(jax.tree.leaves(other), jax.tree.leaves(grads)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


# -- decode -------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def ref_decode(absorb):
    """The reference's logits and caches over 6 decode steps."""
    r_cfg, _ = configs(mla_absorb=absorb)
    cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32)
    dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, r_cfg, c, t, pos))
    toks, out = tokens(1, 6), []
    for t in range(6):
        logits, cache = dec(ref_params(), cache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(t, jnp.int32))
        out.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return out


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
@pytest.mark.parametrize("absorb", [True, False])
def test_decode_step_equals_reference(absorb, port_impl):
    _, cfg = configs(port_impl=port_impl, mla_absorb=absorb)
    params = port_params(cfg)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    assert set(cache) == {"layers", "dense_layers"}
    toks = tokens(1, 6)
    for t, (want, want_cache) in enumerate(ref_decode(absorb)):
        got, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        assert got.shape == (BATCH, 1, M.vocab_padded(cfg))
        assert_logits(got, want, cfg.vocab, 1e-4)
        assert jax.tree.structure(want_cache) == jax.tree.structure(cache)
        for w, g in zip(jax.tree.leaves(want_cache), jax.tree.leaves(cache)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("absorb", [True, False])
def test_decode_matches_prefill(absorb):
    _, cfg = configs(mla_absorb=absorb)
    params = port_params(cfg)
    toks = tokens(3, 8)
    full, _ = M.forward(params, cfg, toks)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    steps = []
    for t in range(8):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1)[..., : cfg.vocab],
                               full[..., : cfg.vocab], rtol=2e-3, atol=2e-3)


def test_reference_cache_carries_across():
    """A two-stack cache the reference decoded into continues in the port."""
    r_cfg, cfg = configs()
    logits, r_cache = ref_decode(True)[2]
    cache = cache_from_numpy(r_cache, "cpu")
    assert cache["dense_layers"]["attn"]["ckv"].shape == (1, BATCH, 16, 16)
    assert cache["layers"]["attn"]["k_rope"].shape == (1, BATCH, 16, 8)
    want = ref_decode(True)[3][0]
    got, _ = M.decode_step(port_params(cfg), cfg, cache, tokens(1, 6)[:, 3:4], 3)
    assert_logits(got, want, r_cfg.vocab, 1e-4)


# -- serving and training -----------------------------------------------------


def example_requests(vocab=256):
    """examples/serve_batch.py: eight requests on four slots."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=int(rng.integers(2, 10))),
             int(rng.integers(4, 12))) for _ in range(8)]


def test_serve_tokens_equal_reference():
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


class _Crash(RuntimeError):
    pass


def crash_after(n):
    def on_metrics(step, _):
        if step > n:
            raise _Crash
    return on_metrics


TRAIN = dict(steps=3, lr=3e-3, warmup=1, log_every=1)
TRAIN_KW = dict(global_batch=4, seq_len=16, seed=2)


def port_trainer(tcfg):
    _, cfg = configs(remat="full")
    return Trainer(cfg, TrainerConfig(**tcfg), device="cpu", **TRAIN_KW)


def ref_trainer(tcfg):
    r_cfg, _ = configs(remat="full")
    return RTrainer(r_cfg, RTrainerConfig(**tcfg), **TRAIN_KW)


@pytest.fixture(scope="module")
def ref_straight(tmp_path_factory):
    """The reference trainer's straight 3-step run, committing at steps 2
    and 3: (params, history, its checkpoint directory)."""
    directory = tmp_path_factory.mktemp("ref_ckpt")
    trainer = ref_trainer(dict(TRAIN, checkpoint_every=2,
                               checkpoint_dir=str(directory)))
    params, _, hist = trainer.run(params=jax.tree.map(jnp.asarray, ref_tree()))
    trainer.ckpt.wait()
    return jax.tree.map(np.asarray, params), hist, directory


def assert_params_close(got_tree, want_tree, tol=TOL):
    got, got_def = jax.tree.flatten(got_tree)
    want, want_def = jax.tree.flatten(want_tree)
    assert got_def == want_def
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def test_trainer_steps_equal_reference(ref_straight):
    want, r_hist, _ = ref_straight
    _, cfg = configs(remat="full")
    params, _, hist = port_trainer(TRAIN).run(params=port_params(cfg))
    assert [s for s, _ in hist] == [s for s, _ in r_hist] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for _, m in hist],
                               [m["loss"] for _, m in r_hist], rtol=1e-5)
    assert_params_close(params_to_numpy(cfg, params), want)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, ref_straight, writer):
    """A job that one package's trainer committed at step 2 is finished by
    the other's, ending where the reference's straight run does: the
    checkpoint holds ``dense_layers``, ``mtp_layer`` and ``mtp_proj`` in
    the reference's layout.  The reference's commit is its straight run's,
    with the step-3 commit dropped; the port's job crashes after step 2."""
    want, _, ref_dir = ref_straight
    _, cfg = configs(remat="full")
    tc = dict(TRAIN, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    if writer == "reference":
        shutil.copytree(ref_dir / "step_000000002", tmp_path / "step_000000002")
        second = port_trainer
    else:
        crashed = port_trainer(tc)
        with pytest.raises(_Crash):
            crashed.run(params=port_params(cfg), on_metrics=crash_after(2))
        crashed.ckpt.wait()
        second = ref_trainer
    params, state, hist = second(tc).run()
    assert [s for s, _ in hist] == [3] and int(state.step) == 3
    got = (params_to_numpy(cfg, params) if writer == "reference"
           else jax.tree.map(np.asarray, params))
    assert_params_close(got, want)


# -- layouts ------------------------------------------------------------------


def test_init_params_has_reference_layout():
    _, cfg = configs()
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    carried = port_params(cfg)
    shapes = {k: (v.shape, v.dtype) for k, v in got.state_dict().items()}
    assert shapes == {k: (v.shape, v.dtype)
                      for k, v in carried.state_dict().items()}
    assert M._main_kind(cfg) == "moe"  # the main stack's kind
    assert len(got.dense_layers) == 1 and len(got.layers) == 1
    assert got.mtp_proj.shape == (2 * cfg.d_model, cfg.d_model)
    assert got.dense_layers[0].ffn.w_gate.shape == (cfg.d_model, cfg.d_ff)
    assert got.mtp_layer.ffn.w_gate.shape == (cfg.d_model, cfg.d_ff)
    again = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 again.state_dict().values()))
    assert all(bool((t == 1).all()) for k, t in got.state_dict().items()
               if k.endswith("norm") or k.endswith("norm1")
               or k.endswith("norm2"))
    # the reference's tree and back, leaf for leaf
    back = params_to_numpy(cfg, carried)
    assert jax.tree.structure(back) == jax.tree.structure(ref_tree())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_tree())):
        np.testing.assert_array_equal(a, b)


def test_state_trees_and_groups_span_each_stack():
    _, cfg = configs()
    named = dict(port_params(cfg).named_parameters())
    state = state_from_numpy(cfg, state_to_numpy(cfg, named), "cpu")
    assert list(state) == list(named)
    assert all(torch.equal(state[k], named[k]) for k in named)
    groups = {tuple(g) for g in stacked_groups(list(named))}
    assert ("dense_layers.0.ffn.w_gate",) in groups  # one dense layer
    assert ("mtp_layer.ffn.w_gate",) in groups and ("mtp_proj",) in groups
    names = ["dense_layers.0.attn.wq", "dense_layers.1.attn.wq",
             "layers.0.attn.wq", "mtp_layer.attn.wq"]
    assert stacked_groups(names) == [names[:2], names[2:3], names[3:]]


def test_active_param_accounting():
    """The reference's ``test_active_param_accounting`` on the port's
    configs."""
    cfg = get_config(ARCH)
    total = cfg.total_params
    active = cfg.active_params_per_token
    assert 500e9 < total < 900e9, f"deepseek total {total/1e9:.0f}B off"
    assert 25e9 < active < 60e9, f"deepseek active {active/1e9:.0f}B off"
    g8 = get_config("granite-3-8b")
    assert 6e9 < g8.total_params < 11e9
    r_cfg = r_get_config(ARCH)
    assert (total, active) == (r_cfg.total_params, r_cfg.active_params_per_token)


def test_launchers_run_on_cpu():
    done = launch_serve.main(["--arch", ARCH, "--reduced", "--requests", "3",
                              "--max-new", "4", "--device", "cpu"])
    assert sorted(rid for rid, _ in done) == [1, 2, 3]
    assert all(len(t) == 4 for _, t in done)
    hist = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert [s for s, _ in hist] == [2] and np.isfinite(hist[0][1]["loss"])
