"""The port's training path against the JAX reference, on the same numpy
inputs and, for the models, the reference's params carried across by
``params_from_numpy``.

* ``loss_fn``'s loss and every grad leaf equal
  ``jax.value_and_grad(repro.models.model.loss_fn)`` on granite-3-2b and
  rwkv6-7b ``reduced()``, with the port on its plain path (``"ref"``) and
  its kernel path (``"kernel"``: the kernels' autograd Functions, which run
  their plain versions on a CPU tensor): rtol 1e-4, atol 1e-5;
* the chunked CE (``ce_chunk=64``) equals the port's dense CE (the
  reference's own ``test_chunked_ce_matches_dense`` tolerances) and the
  reference's chunked CE (1e-4 / 1e-5);
* ``remat`` ``"none"``, ``"full"`` and ``"dots"`` give equal losses and
  grads;
* each kernel's Function gives the grads of ``jax.grad`` through the
  reference's ``flash_attention`` and ``wkv6`` with ``use_kernel=True``
  (the Pallas kernels in interpret mode, their ``custom_vjp``), and through
  their plain versions: 1e-4 / 1e-5;
* ``SyntheticLMDataset`` batches are bit-equal to the reference's;
* ``GraphPatternFilter.matches`` equals the reference's on its own test's
  two cases and on random graphs, on the host.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as r_get_config
from repro.data.pipeline import GraphPatternFilter as RGraphPatternFilter
from repro.data.pipeline import SyntheticLMDataset as RSyntheticLMDataset
from repro.graphs import random_labeled_graph, random_walk_query
from repro.graphs.csr import Graph as RGraph
from repro.kernels.flash_attention.ops import flash_attention as r_flash
from repro.kernels.rwkv6_wkv.ops import wkv6 as r_wkv6
from repro.models import model as RM
from repro_torch.configs import get_config
from repro_torch.data import GraphPatternFilter, SyntheticLMDataset
from repro_torch.graphs.convert import graph_from_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_numpy, state_to_numpy

ARCHS = ["granite-3-2b", "rwkv6-7b"]
RTOL, ATOL = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    params, _ = RM.init_params(jax.random.PRNGKey(0), r_get_config(arch).reduced())
    return params


def batch(vocab, b=2, s=16, seed=1):
    """Tokens and labels from numpy; a few labels are -1 (masked)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, -3:] = -1
    return {"tokens": tokens, "labels": labels}


@functools.lru_cache(maxsize=None)
def ref_loss_and_grads(arch, ce_chunk=0):
    cfg = dataclasses.replace(r_get_config(arch).reduced(), ce_chunk=ce_chunk)
    b = {k: jnp.asarray(v) for k, v in batch(cfg.vocab).items()}
    (loss, metrics), grads = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        ref_params(arch), cfg, b)
    return float(loss), metrics, jax.tree.map(np.asarray, grads)


def port_loss_and_grads(arch, **overrides):
    cfg = dataclasses.replace(get_config(arch).reduced(), **overrides)
    lm = params_from_numpy(cfg, jax.tree.map(np.asarray, ref_params(arch)), "cpu")
    lm.requires_grad_(True)
    named = dict(lm.named_parameters())
    loss, metrics = M.loss_fn(lm, cfg, batch(cfg.vocab))
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, state_to_numpy(cfg, dict(zip(named, grads)))


def assert_trees_close(got, want, rtol, atol):
    got_leaves, got_def = jax.tree.flatten(got)
    want_leaves, want_def = jax.tree.flatten(want)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_equal_reference(arch, impl):
    want_loss, want_metrics, want_grads = ref_loss_and_grads(arch)
    loss, metrics, grads = port_loss_and_grads(arch, attn_impl=impl)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL)
    assert set(metrics) == set(want_metrics) == {"loss", "moe_dropped"}
    assert metrics["moe_dropped"] == float(want_metrics["moe_dropped"]) == 0.0
    assert_trees_close(grads, want_grads, RTOL, ATOL)


def test_chunked_ce_matches_dense():
    """The reference's test_chunked_ce_matches_dense on the port, and the
    port's chunked CE against the reference's."""
    arch = "granite-3-2b"
    dense_loss, _, dense_grads = port_loss_and_grads(arch)
    loss, _, grads = port_loss_and_grads(arch, ce_chunk=64)
    np.testing.assert_allclose(float(loss.detach()), float(dense_loss.detach()), rtol=2e-5)
    assert_trees_close(grads, dense_grads, 2e-3, 2e-4)
    want_loss, _, want_grads = ref_loss_and_grads(arch, ce_chunk=64)
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=RTOL)
    assert_trees_close(grads, want_grads, RTOL, ATOL)


def test_chunked_ce_rejects_a_chunk_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        port_loss_and_grads("granite-3-2b", ce_chunk=100)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_grads(arch):
    base_loss, _, base = port_loss_and_grads(arch, remat="none",
                                             attn_impl="kernel")
    for remat in ("full", "dots"):
        loss, _, grads = port_loss_and_grads(arch, remat=remat,
                                             attn_impl="kernel")
        assert float(loss.detach()) == float(base_loss.detach()), remat
        assert_trees_close(grads, base, 1e-6, 1e-7)


def test_remat_rejects_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown remat"):
        port_loss_and_grads("granite-3-2b", remat="some")


def grads_of(fn, arrays, cotangents):
    """Port grads of sum(out * cotangent) over ``fn``'s outputs."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cotangents))
    return [g.numpy() for g in torch.autograd.grad(total, ts)]


def jax_grads_of(fn, arrays, cotangents):
    def total(*xs):
        outs = fn(*xs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cotangents))
    return jax.grad(total, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))


@pytest.mark.parametrize("hq,hkv,s,window,causal", [
    (4, 2, 64, None, True), (4, 1, 48, 16, True), (2, 2, 40, None, False)])
def test_flash_attention_function_grads(hq, hkv, s, window, causal):
    rng = np.random.default_rng(s)
    d = 16
    arrays = [rng.normal(size=(2, h, s, d)).astype(np.float32)
              for h in (hq, hkv, hkv)]
    cot = [rng.normal(size=(2, hq, s, d)).astype(np.float32)]
    before = fa_ops.flash_attention.launches
    got = grads_of(lambda q, k, v: fa_ops.flash_attention(q, k, v, causal,
                                                          window), arrays, cot)
    assert fa_ops.flash_attention.launches == before  # CPU: no launch
    for use_kernel in (True, False):
        want = jax_grads_of(lambda q, k, v: r_flash(
            q, k, v, causal, window, 0, 128, 128, use_kernel), arrays, cot)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


def test_flash_attention_function_passes_no_grad_to_a_frozen_input():
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(1, 2, 20, 16)).astype(np.float32))
               for _ in range(3))
    q.requires_grad_(True)
    out = fa_ops.flash_attention(q, k, v)
    assert out.grad_fn is not None
    (gq,) = torch.autograd.grad(out.sum(), [q])
    assert gq.shape == q.shape and k.grad is None
    with torch.no_grad():
        assert fa_ops.flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("b,h,t,dk,dv", [(2, 3, 20, 16, 16), (1, 2, 24, 16, 8)])
def test_wkv6_function_grads(b, h, t, dk, dv, with_state):
    """Grads for r, k, v, w, u and state0, with cotangents on both outputs
    (o and the final state)."""
    rng = np.random.default_rng(t + dv)
    arrays = [rng.normal(size=(b, h, t, dk)).astype(np.float32),
              rng.normal(size=(b, h, t, dk)).astype(np.float32),
              rng.normal(size=(b, h, t, dv)).astype(np.float32),
              rng.uniform(0.2, 0.99, size=(b, h, t, dk)).astype(np.float32),
              rng.normal(size=(h, dk)).astype(np.float32),
              rng.normal(size=(b, h, dk, dv)).astype(np.float32)]
    cot = [rng.normal(size=(b, h, t, dv)).astype(np.float32),
           rng.normal(size=(b, h, dk, dv)).astype(np.float32)]
    zeros = np.zeros_like(arrays[5])
    if not with_state:  # state0 None on the port's side, zeros on the reference's
        arrays = arrays[:5]
    before = wkv_ops.wkv6.launches
    got = grads_of(lambda *xs: wkv_ops.wkv6(*xs, *(() if with_state else (None,))),
                   arrays, cot)
    assert wkv_ops.wkv6.launches == before
    for use_kernel in (True, False):
        want = jax_grads_of(lambda *xs: r_wkv6(
            *xs, *(() if with_state else (zeros,)), 16, use_kernel), arrays, cot)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 5), (11, 1234)])
def test_synthetic_batches_bit_equal(seed, step):
    got = SyntheticLMDataset(1000, 16, 4, seed=seed).batch_at(step)
    want = RSyntheticLMDataset(1000, 16, 4, seed=seed).batch_at(step)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def port_graph(g):
    return graph_from_numpy(*(np.asarray(x) for x in g), device="cpu")


def test_graph_pattern_filter_equals_reference():
    g = random_labeled_graph(60, 150, 4, seed=1)
    q = random_walk_query(g, 3, seed=2)
    g2 = random_labeled_graph(40, 80, 3, seed=9)
    shifted = RGraph(vlabels=g2.vlabels + 1000, src=g2.src, dst=g2.dst,
                     elabels=g2.elabels)
    docs = [g, shifted] + [random_labeled_graph(30, 60, 4, seed=s)
                           for s in range(20, 26)]
    r_filt = RGraphPatternFilter(q)
    filt = GraphPatternFilter(port_graph(q), device="cpu")
    got = [filt.matches(port_graph(d)) for d in docs]
    assert got == [r_filt.matches(d) for d in docs]
    assert got[0] and not got[1]  # the reference test's two cases
    kept = [i for i, _ in filt.filter((i, port_graph(d))
                                      for i, d in enumerate(docs))]
    assert kept == [i for i, m in enumerate(got) if m]
