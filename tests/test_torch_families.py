"""The MoE (qwen3-moe-30b-a3b) and MLA (minicpm3-4b) families of the port
against the JAX reference, on ``reduced()`` configs with the reference's
params carried across by ``params_from_numpy`` and the same numpy inputs.

Variants: qwen3-moe as it is (dropless at this size), qwen3-moe with
capacity factor 1.0, group 16 and the gather plan (tokens dropped), and
minicpm3 with its absorbed decode and with the naive one.

* ``forward`` logits and ``moe_dropped``: 1e-4;
* ``decode_step`` logits and the cache over 6 steps, the port on "ref" and
  "auto" (the kernel's plain version on a CPU tensor): 1e-4;
* decode == prefill within the port: 2e-3;
* ``loss_fn`` and every grad leaf against ``jax.value_and_grad``: loss
  within 1e-5 relative, each leaf within 1e-4 of its largest value;
* remat "none", "full" and "dots" give equal losses, ``moe_dropped`` and
  grads;
* ``ServeEngine`` tokens equal the reference's; 3 ``Trainer`` steps equal
  the reference trainer's (losses 1e-5 relative, params 2e-4);
* ``init_params`` draws the reference's layout; an MLA cache carries
  across; the launchers run both families on the CPU.
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
    state_to_numpy,
)
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import Trainer, TrainerConfig

ARCHS = ["qwen3-moe-30b-a3b", "minicpm3-4b"]
TIGHT = dict(capacity_factor=1.0, group_size=16, dispatch="gather")
VARIANTS = {  # name: (arch, config fields, MoE fields)
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}, {}),
    "qwen3-moe-tight": ("qwen3-moe-30b-a3b", {}, TIGHT),
    "minicpm3": ("minicpm3-4b", {}, {}),
    "minicpm3-naive": ("minicpm3-4b", {"mla_absorb": False}, {}),
}
BATCH = 2


def configs(variant, ref_impl="ref", port_impl="auto", **fields):
    arch, kw, moe = VARIANTS[variant]
    out = []
    for cfg, impl in ((r_get_config(arch).reduced(), ref_impl),
                      (get_config(arch).reduced(), port_impl)):
        extra = {"moe": dataclasses.replace(cfg.moe, **moe)} if moe else {}
        out.append(dataclasses.replace(cfg, attn_impl=impl, **kw, **extra,
                                       **fields))
    return out


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    params, _ = RM.init_params(jax.random.PRNGKey(0), r_get_config(arch).reduced())
    return params


def port_params(variant, cfg):
    arch = VARIANTS[variant][0]
    return params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params(arch)), "cpu")


def tokens(seed, length, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, size=(BATCH, length)
                                                ).astype(np.int32)


def assert_logits(got: torch.Tensor, want, vocab, tol):
    np.testing.assert_allclose(got.numpy()[..., :vocab],
                               np.asarray(want)[..., :vocab], rtol=tol, atol=tol)


@pytest.mark.parametrize("ref_impl", ["ref", "xla_flash"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_equals_reference(variant, ref_impl):
    r_cfg, p_cfg = configs(variant, ref_impl)
    toks = tokens(2, 32)
    want, want_aux = jax.jit(lambda p, t: RM.forward(p, r_cfg, t))(
        ref_params(VARIANTS[variant][0]), jnp.asarray(toks))
    got, aux = M.forward(port_params(variant, p_cfg), p_cfg, toks)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_logits(got, want, r_cfg.vocab, 1e-4)
    np.testing.assert_allclose(float(aux["moe_dropped"]),
                               float(want_aux["moe_dropped"]), atol=1e-4)
    assert (float(aux["moe_dropped"]) > 0) == (variant == "qwen3-moe-tight")


@pytest.mark.parametrize("port_impl", ["ref", "auto"])
@pytest.mark.parametrize("variant", ["qwen3-moe", "minicpm3", "minicpm3-naive"])
def test_decode_step_equals_reference(variant, port_impl):
    r_cfg, p_cfg = configs(variant, "ref", port_impl)
    arch = VARIANTS[variant][0]
    params = port_params(variant, p_cfg)
    r_cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32)
    cache = M.init_cache(p_cfg, BATCH, 16, device="cpu")
    dec = jax.jit(lambda p, c, t, pos: RM.decode_step(p, r_cfg, c, t, pos))
    toks = tokens(1, 6)
    for t in range(6):
        want, r_cache = dec(ref_params(arch), r_cache,
                            jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t, jnp.int32))
        got, cache = M.decode_step(params, p_cfg, cache, toks[:, t:t + 1], t)
        assert got.shape == (BATCH, 1, M.vocab_padded(p_cfg))
        assert_logits(got, want, r_cfg.vocab, 1e-4)
        want_cache = jax.tree.map(np.asarray, r_cache)
        assert jax.tree.structure(want_cache) == jax.tree.structure(cache)
        for w, g in zip(jax.tree.leaves(want_cache), jax.tree.leaves(cache)):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["qwen3-moe", "minicpm3", "minicpm3-naive"])
def test_decode_matches_prefill(variant):
    _, cfg = configs(variant)
    params = port_params(variant, cfg)
    toks = tokens(3, 8)
    full, _ = M.forward(params, cfg, toks)
    cache = M.init_cache(cfg, BATCH, 16, device="cpu")
    steps = []
    for t in range(8):
        lg, cache = M.decode_step(params, cfg, cache, toks[:, t:t + 1], t)
        steps.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(steps, 1)[..., : cfg.vocab],
                               full[..., : cfg.vocab], rtol=2e-3, atol=2e-3)


def batch(vocab=256, b=2, s=16, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, -3:] = -1
    return {"tokens": toks, "labels": labels}


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(variant):
    r_cfg, _ = configs(variant)
    b = {k: jnp.asarray(v) for k, v in batch().items()}
    (loss, metrics), grads = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        ref_params(VARIANTS[variant][0]), r_cfg, b)
    return float(loss), float(metrics["moe_dropped"]), jax.tree.map(np.asarray, grads)


def port_loss_and_grads(variant, impl="auto", **fields):
    _, cfg = configs(variant, port_impl=impl, **fields)
    lm = port_params(variant, cfg)
    lm.requires_grad_(True)
    named = dict(lm.named_parameters())
    loss, metrics = M.loss_fn(lm, cfg, batch())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return (float(loss.detach()), float(metrics["moe_dropped"]),
            state_to_numpy(cfg, dict(zip(named, grads))))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("variant", ["qwen3-moe", "qwen3-moe-tight", "minicpm3"])
def test_loss_and_grads_equal_reference(variant, impl):
    want_loss, want_dropped, want = ref_loss_and_grads(variant)
    loss, dropped, got = port_loss_and_grads(variant, impl)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    np.testing.assert_allclose(dropped, want_dropped, atol=1e-6)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        limit = 1e-4 * max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= limit, jax.tree_util.keystr(path)


@pytest.mark.parametrize("variant", ["qwen3-moe-tight", "minicpm3"])
def test_remat_policies_give_equal_grads(variant):
    base_loss, base_dropped, base = port_loss_and_grads(variant, remat="none")
    for remat in ("full", "dots"):
        loss, dropped, grads = port_loss_and_grads(variant, remat=remat)
        assert (loss, dropped) == (base_loss, base_dropped), remat
        for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(base)):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def example_requests(vocab=256):
    """examples/serve_batch.py: eight requests on four slots."""
    rng = np.random.default_rng(0)
    return [(rng.integers(0, vocab, size=int(rng.integers(2, 10))),
             int(rng.integers(4, 12))) for _ in range(8)]


@pytest.mark.parametrize("variant", ["qwen3-moe", "minicpm3", "minicpm3-naive"])
def test_serve_tokens_equal_reference(variant):
    r_cfg, p_cfg = configs(variant)
    scfg = dict(max_batch=4, max_len=96, eos_token=-1)
    ref = RServeEngine(ref_params(VARIANTS[variant][0]), r_cfg,
                       RServeConfig(**scfg))
    port = ServeEngine(port_params(variant, p_cfg), p_cfg, ServeConfig(**scfg))
    for prompt, max_new in example_requests():
        assert ref.submit(prompt, max_new) == port.submit(prompt, max_new)
    want = ref.run_to_completion()
    got = port.run_to_completion()
    assert [(rid, list(t)) for rid, t in got] == [(rid, list(t)) for rid, t in want]
    assert len(got) == 8


@pytest.mark.parametrize("variant", ["qwen3-moe-tight", "minicpm3"])
def test_trainer_steps_equal_reference(variant):
    r_cfg, p_cfg = configs(variant, "ref", "auto", remat="full")
    tc = dict(steps=3, lr=3e-3, warmup=1, log_every=1)
    kw = dict(global_batch=4, seq_len=16, seed=2)
    tree = jax.tree.map(np.asarray, ref_params(VARIANTS[variant][0]))
    pp, _, hist = Trainer(p_cfg, TrainerConfig(**tc), device="cpu", **kw).run(
        params=params_from_numpy(p_cfg, tree, "cpu"))
    rp, _, r_hist = RTrainer(r_cfg, RTrainerConfig(**tc), **kw).run(
        params=jax.tree.map(jnp.asarray, tree))
    assert [s for s, _ in hist] == [s for s, _ in r_hist] == [1, 2, 3]
    np.testing.assert_allclose([m["loss"] for _, m in hist],
                               [m["loss"] for _, m in r_hist], rtol=1e-5)
    got, want = params_to_numpy(p_cfg, pp), jax.tree.map(np.asarray, rp)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_reference_layout(arch):
    cfg = get_config(arch).reduced()
    got = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    carried = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params(arch)),
                                "cpu")
    shapes = {k: (v.shape, v.dtype) for k, v in got.state_dict().items()}
    assert shapes == {k: (v.shape, v.dtype) for k, v in carried.state_dict().items()}
    again = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got.state_dict().values(),
                                                 again.state_dict().values()))
    # the norms (MLA's q_norm and kv_norm too) start at one
    assert all(bool((t == 1).all()) for k, t in got.state_dict().items()
               if k.endswith("norm"))


def test_mla_cache_from_numpy_round_trips():
    r_cfg, p_cfg = configs("minicpm3")
    params = port_params("minicpm3", p_cfg)
    r_cache, _ = RM.init_cache(r_cfg, BATCH, 16, jnp.float32)
    _, r_cache = RM.decode_step(ref_params("minicpm3-4b"), r_cfg, r_cache,
                                jnp.asarray(tokens(5, 1)), jnp.asarray(0, jnp.int32))
    cache = cache_from_numpy(jax.tree.map(np.asarray, r_cache), "cpu")
    assert cache["layers"]["attn"]["ckv"].shape == (2, BATCH, 16, 16)
    toks = tokens(6, 1)
    want, _ = RM.decode_step(ref_params("minicpm3-4b"), r_cfg, r_cache,
                             jnp.asarray(toks), jnp.asarray(1, jnp.int32))
    got, _ = M.decode_step(params, p_cfg, cache, toks, 1)
    assert_logits(got, want, r_cfg.vocab, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_cpu(arch):
    done = launch_serve.main(["--arch", arch, "--reduced", "--requests", "3",
                              "--max-new", "4", "--device", "cpu"])
    assert sorted(rid for rid, _ in done) == [1, 2, 3]
    assert all(len(t) == 4 for _, t in done)
    hist = launch_train.main(["--arch", arch, "--reduced", "--steps", "2",
                              "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert [s for s, _ in hist] == [2] and np.isfinite(hist[0][1]["loss"])
