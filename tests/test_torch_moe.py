"""The port's MoE FFN (``models/layers.py::moe_apply``) against the JAX
reference's ``repro.models.layers.moe_apply``, on the same numpy inputs and
the reference's params carried across.

* output and ``router_probs_mean`` within 1e-5 and ``dropped_frac`` equal,
  for both dispatch plans ("einsum", "gather"), capacity factor 64
  (dropless) and 1.0 (drops), group sizes 16 and 64, decode (S 1), and
  qwen3-moe's reduced FFN as it is and with ``n_shared=1`` and
  ``router_aux_free_bias`` (a random bias, so selection and gates part);
* the grads of both plans against ``jax.grad`` of the reference's: 1e-4;
* ties in the top-k break to the lower index, as ``jax.lax.top_k``'s;
* the reference's ``test_moe_group_size_invariance`` and
  ``test_moe_gather_dispatch_matches_einsum``, run in the port;
* a moe tree with ``router_bias`` and the nested ``shared`` SwiGLU carries
  both ways, and AdamW's factored statistics of a per-layer (E, d, de)
  expert leaf are the slices of the reference's stacked (L, E, d, de) ones.
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
from repro.optim import adamw as RA
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
    stacked_groups,
    state_from_numpy,
    state_to_numpy,
)
from repro_torch.optim import adamw as PA

ARCH = "qwen3-moe-30b-a3b"
VARIANTS = {"qwen3": {}, "shared_bias": {"n_shared": 1,
                                          "router_aux_free_bias": True}}


def configs(variant="qwen3", **moe):
    """(reference config, port config): qwen3-moe ``reduced()`` with the
    variant's and ``moe``'s MoE fields."""
    out = []
    for cfg in (r_get_config(ARCH).reduced(), get_config(ARCH).reduced()):
        mo = dataclasses.replace(cfg.moe, **VARIANTS[variant], **moe)
        out.append(dataclasses.replace(cfg, moe=mo))
    return out


@functools.lru_cache(maxsize=None)
def ref_moe(variant):
    """The reference's ``moe_init`` params (numpy), a random router bias."""
    r_cfg, _ = configs(variant)
    p, _ = RL.moe_init(jax.random.PRNGKey(5), r_cfg)
    p = jax.tree.map(np.asarray, p)
    if "router_bias" in p:
        p["router_bias"] = np.random.default_rng(9).normal(
            scale=0.1, size=p["router_bias"].shape).astype(np.float32)
    return p


def port_moe(p) -> L.MoE:
    tensors = {name: torch.tensor(p[name]) for name in L.MoE.NAMES}
    shared = (L.SwiGLU(**{n: torch.tensor(p["shared"][n])
                          for n in L.SwiGLU.NAMES}) if "shared" in p else None)
    bias = torch.tensor(p["router_bias"]) if "router_bias" in p else None
    return L.MoE(router_bias=bias, shared=shared, **tensors)


def inputs(b, s, d=64, seed=0):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(np.float32)


def check_against_reference(variant, x, **moe):
    r_cfg, p_cfg = configs(variant, **moe)
    want, want_aux = RL.moe_apply(jax.tree.map(jnp.asarray, ref_moe(variant)),
                                  jnp.asarray(x), r_cfg)
    got, aux = L.moe_apply(port_moe(ref_moe(variant)), torch.tensor(x), p_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux["router_probs_mean"].numpy(),
                               np.asarray(want_aux["router_probs_mean"]),
                               rtol=1e-5, atol=1e-5)
    assert aux["dropped_frac"].dtype == torch.float32
    assert float(aux["dropped_frac"]) == float(want_aux["dropped_frac"])
    return float(aux["dropped_frac"])


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("cf", [64.0, 1.0])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_apply_equals_reference(dispatch, cf, group, variant):
    dropped = check_against_reference(variant, inputs(2, 32), dispatch=dispatch,
                                      capacity_factor=cf, group_size=group)
    assert (dropped > 0) == (cf == 1.0)  # tight capacity drops, 64 does not


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_decode_is_one_dropless_group(dispatch, variant):
    """S 1: one group of B tokens, capacity B, even at capacity factor 1."""
    dropped = check_against_reference(variant, inputs(6, 1, seed=1),
                                      dispatch=dispatch, capacity_factor=1.0)
    assert dropped == 0.0


@pytest.mark.parametrize("cf", [64.0, 1.0])
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_grads_equal_reference(dispatch, cf):
    r_cfg, p_cfg = configs("shared_bias", dispatch=dispatch,
                           capacity_factor=cf, group_size=16)
    x = inputs(2, 32, seed=2)
    cot = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    p_ref = jax.tree.map(jnp.asarray, ref_moe("shared_bias"))

    def total(p, xx):
        return jnp.sum(RL.moe_apply(p, xx, r_cfg)[0] * cot)

    want_p, want_x = jax.grad(total, argnums=(0, 1))(p_ref, jnp.asarray(x))
    mod = port_moe(ref_moe("shared_bias")).requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    (L.moe_apply(mod, xt, p_cfg)[0] * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-4,
                               atol=1e-5)
    for name, param in mod.named_parameters():
        want = want_p
        for key in name.split("."):
            want = want[key]
        grad = (param.grad if param.grad is not None
                else torch.zeros_like(param))  # the bias only selects
        np.testing.assert_allclose(grad.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_top_k_ties_break_to_the_lower_index():
    scores = np.random.default_rng(4).integers(0, 3, size=(5, 7, 16)).astype(
        np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(scores), 5)[1])
    np.testing.assert_array_equal(L._top_k(torch.tensor(scores), 5).numpy(),
                                  want)


@pytest.mark.parametrize("s", [1, 32])
def test_uniform_router_equals_reference(s):
    """A zero router: every score ties, so the selection is the first k
    experts in both packages, and so is the output."""
    p = dict(ref_moe("qwen3"))
    p["w_router"] = np.zeros_like(p["w_router"])
    r_cfg, p_cfg = configs("qwen3", capacity_factor=1.0, group_size=16)
    x = inputs(2, s, seed=5)
    want, _ = RL.moe_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), r_cfg)
    got, _ = L.moe_apply(port_moe(p), torch.tensor(x), p_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def model_params():
    params, _ = RM.init_params(jax.random.PRNGKey(0), r_get_config(ARCH).reduced())
    return jax.tree.map(np.asarray, params)


def model_tokens():
    return np.random.default_rng(1).integers(0, 256, size=(2, 32)).astype(np.int32)


def port_logits(**moe):
    _, cfg = configs(**moe)
    lm = params_from_numpy(cfg, model_params(), "cpu")
    return M.forward(lm, cfg, model_tokens())


def test_moe_group_size_invariance():
    """tests/test_optimizations.py::test_moe_group_size_invariance in the
    port: with dropless capacity the logits do not depend on the group."""
    a, aux_a = port_logits(group_size=64, capacity_factor=64.0)
    b, aux_b = port_logits(group_size=16, capacity_factor=64.0)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
    assert float(aux_a["moe_dropped"]) == float(aux_b["moe_dropped"]) == 0.0


def test_moe_gather_dispatch_matches_einsum():
    """tests/test_optimizations.py::test_moe_gather_dispatch_matches_einsum
    in the port, with the dropped share too; and the reference's logits."""
    r_cfg = r_get_config(ARCH).reduced()
    for cf in (64.0, 1.0):  # dropless and tight-capacity regimes
        a, aux_a = port_logits(capacity_factor=cf)
        b, aux_b = port_logits(capacity_factor=cf, dispatch="gather")
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=2e-4)
        assert float(aux_a["moe_dropped"]) == float(aux_b["moe_dropped"])
        assert (float(aux_a["moe_dropped"]) > 0) == (cf == 1.0)
        c = dataclasses.replace(r_cfg, moe=dataclasses.replace(
            r_cfg.moe, capacity_factor=cf))
        want, want_aux = RM.forward(model_params(), c, jnp.asarray(model_tokens()))
        np.testing.assert_allclose(a.numpy()[..., :c.vocab],
                                   np.asarray(want)[..., :c.vocab], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(aux_a["moe_dropped"]),
                                   float(want_aux["moe_dropped"]), rtol=1e-6)


def test_moe_tree_round_trips():
    """router_bias and the nested shared SwiGLU: params, a state dict keyed
    like the params, and the int8 groups (one a reference leaf)."""
    r_cfg, cfg = configs("shared_bias")
    tree = jax.tree.map(np.asarray,
                        RM.init_params(jax.random.PRNGKey(1), r_cfg)[0])
    lm = params_from_numpy(cfg, tree, "cpu")
    assert lm.layers[1].ffn.router_bias.dtype == torch.float32
    assert lm.layers[0].ffn.shared.w_gate.shape == (64, 32)
    back = params_to_numpy(cfg, lm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    named = dict(lm.named_parameters())
    again = state_from_numpy(cfg, state_to_numpy(cfg, named), "cpu")
    assert list(again) == list(named)
    assert all(torch.equal(again[k], named[k]) for k in named)
    assert len(stacked_groups(named)) == len(jax.tree.leaves(tree))
    bad = dict(tree, layers=dict(tree["layers"], ffn={
        k: v for k, v in tree["layers"]["ffn"].items() if k != "router_bias"}))
    with pytest.raises(ValueError, match="router_bias"):
        params_from_numpy(cfg, bad, "cpu")


def test_factored_adamw_on_expert_leaves():
    """qwen3-moe's expert and router leaves factor alike per layer and
    stacked; three factored steps on per-layer (E, d, de) leaves equal the
    reference's on the stacked (L, E, d, de) leaf, statistics included."""
    cfg = get_config(ARCH)
    e, d, de, n = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert, cfg.n_layers
    for shape in ((e, d, de), (e, de, d), (d, e)):
        assert PA._should_factor(shape) == RA._should_factor((n, *shape)) is True
    rng = np.random.default_rng(6)
    w = rng.normal(size=(2, 3, 128, 136)).astype(np.float32)  # (L, E, d, de)
    grads = [rng.normal(size=w.shape).astype(np.float32) for _ in range(3)]
    names = [f"layers.{i}.ffn.w_gate" for i in range(2)]
    port = {nm: torch.tensor(w[i]) for i, nm in enumerate(names)}
    p_state = PA.adamw_init(port, factored=True)
    ref, r_state = {"w": jnp.asarray(w)}, RA.adamw_init({"w": jnp.asarray(w)},
                                                          factored=True)
    for g in grads:
        port, p_state = PA.adamw_update(
            port, {nm: torch.tensor(g[i]) for i, nm in enumerate(names)},
            p_state, lr=1e-2)
        ref, r_state = RA.adamw_update(ref, {"w": jnp.asarray(g)}, r_state,
                                       lr=1e-2, factored=True)
    for i, nm in enumerate(names):
        np.testing.assert_allclose(port[nm].numpy(), np.asarray(ref["w"])[i],
                                   rtol=1e-6, atol=1e-6)
        for got, want in zip(p_state.v[nm], r_state.v["w"]):
            assert got.shape == want.shape[1:]
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[i],
                                       rtol=1e-6, atol=1e-9)
