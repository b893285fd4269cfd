"""The port's optimizer against the JAX reference on the same numpy
inputs.

* ``adamw_update``, full and factored second moment, over 3 steps: params,
  ``m`` and ``v`` (the factored (row, col) statistics too) within 1e-6
  relative of the reference's (of each value, or of the leaf's largest
  where an update cancels a param to near zero);
* the reference's ``TestOptimizer`` cases on the port;
* ``compress_int8`` / ``decompress_int8`` equal to the reference's, ties
  at .5 rounded to even;
* ``cosine_schedule`` and ``linear_warmup_cosine`` over steps 0-120 within
  1e-7;
* ``make_optimizer``'s clipped update equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as R
from repro_torch import optim as P

SHAPES = {"big": (256, 256), "tall": (300, 128), "stack": (3, 130, 140),
          "small": (100, 50), "vec": (64,)}


def arrays(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def to_port(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def to_ref(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def assert_state_close(got: dict, want: dict, rtol):
    """Each leaf within ``rtol`` of the reference's, relative to each value
    and, where ``p - lr * update`` cancels to near zero, to the leaf's
    largest value (the rounding of the terms, not of the small result)."""
    for k in want:
        w = want[k]
        g = got[k]
        pairs = zip(g, w) if isinstance(w, tuple) else ((g, w),)
        assert isinstance(g, tuple) == isinstance(w, tuple), k
        for a, b in pairs:
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                       atol=rtol * np.abs(b).max(), err_msg=k)


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_update_equals_reference(factored):
    params = arrays(0)
    p_port, p_ref = to_port(params), to_ref(params)
    s_port = P.adamw_init(p_port, factored=factored)
    s_ref = R.adamw_init(p_ref, factored=factored)
    assert {k for k, v in s_port.v.items() if isinstance(v, tuple)} == (
        {"big", "tall", "stack"} if factored else set())
    for step, lr in enumerate((1e-2, 3e-3, 5e-4)):
        grads = arrays(10 + step, 0.1)
        p_port, s_port = P.adamw_update(p_port, to_port(grads), s_port, lr=lr)
        p_ref, s_ref = R.adamw_update(p_ref, to_ref(grads), s_ref, lr=lr,
                                      factored=factored)
    assert s_port.step.dtype == torch.int32 and int(s_port.step) == 3
    assert int(s_ref.step) == 3
    assert_state_close(p_port, p_ref, 1e-6)
    assert_state_close(s_port.m, s_ref.m, 1e-6)
    assert_state_close(s_port.v, s_ref.v, 1e-6)


def test_adamw_updates_in_place():
    params = to_port(arrays(1))
    before = {k: v.clone() for k, v in params.items()}
    state = P.adamw_init(params)
    out, new_state = P.adamw_update(params, to_port(arrays(2)), state, lr=1e-2)
    assert out is params and new_state.m is state.m
    assert all(not torch.equal(params[k], before[k]) for k in params)


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 1.0])}
    state = P.adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state = P.adamw_update(params, grads, state, lr=5e-2,
                                       weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.3


def test_factored_matches_full_direction():
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.normal(size=(256, 256)).astype(np.float32))
    grads = {"w": torch.tensor(rng.normal(size=(256, 256)).astype(np.float32))}
    p1, _ = P.adamw_update({"w": w.clone()}, grads,
                           P.adamw_init({"w": w}, factored=False), lr=1e-2)
    p2, _ = P.adamw_update({"w": w.clone()}, grads,
                           P.adamw_init({"w": w}, factored=True), lr=1e-2)
    # same sign of update on most coordinates (factored is approximate)
    agree = (torch.sign(p1["w"] - w) == torch.sign(p2["w"] - w)).float().mean()
    assert float(agree) > 0.95, float(agree)


def test_clip_by_global_norm():
    tree = {"a": torch.full((10,), 10.0)}
    clipped, norm = P.clip_by_global_norm(tree, 1.0)
    assert float(norm) > 1.0
    assert abs(float(P.global_norm(clipped)) - 1.0) < 1e-5
    same, _ = P.clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(same["a"], torch.full((4,), 0.1))


def test_global_norm_equals_reference():
    tree = arrays(4)
    np.testing.assert_allclose(float(P.global_norm(to_port(tree))),
                               float(R.global_norm(to_ref(tree))), rtol=1e-6)


def test_int8_compression_equals_reference():
    tree = arrays(5, 0.01)
    # exact ties: max 127 gives scale 1, so x / scale lands on .5
    tree["ties"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49],
                            np.float32)
    tree["zero"] = np.zeros(4, np.float32)
    q, s = P.compress_int8(to_port(tree))
    rq, rs = R.compress_int8(to_ref(tree))
    for k in tree:
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(rq[k]))
        np.testing.assert_allclose(float(s[k]), float(rs[k]), rtol=1e-7)
    np.testing.assert_array_equal(q["ties"].numpy(), [127, 0, 2, 2, 0, -2, 3])
    back = P.decompress_int8(q, s, to_port(tree))
    rback = R.decompress_int8(rq, rs, to_ref(tree))
    for k in tree:
        np.testing.assert_allclose(back[k].numpy(), np.asarray(rback[k]),
                                   rtol=1e-7, atol=0)
    big = tree["big"]
    rel = np.linalg.norm(back["big"].numpy() - big) / np.linalg.norm(big)
    assert rel < 1e-2, rel  # the reference's round-trip bound


@pytest.mark.parametrize("base_lr", [3e-4, 1.0])
def test_schedules_equal_reference(base_lr):
    pairs = [(P.cosine_schedule(base_lr, 100), R.cosine_schedule(base_lr, 100)),
             (P.cosine_schedule(base_lr, 80, 0.2),
              R.cosine_schedule(base_lr, 80, 0.2)),
             (P.linear_warmup_cosine(base_lr, 10, 100),
              R.linear_warmup_cosine(base_lr, 10, 100)),
             (P.linear_warmup_cosine(base_lr, 0, 50),
              R.linear_warmup_cosine(base_lr, 0, 50))]
    for port, ref in pairs:
        got = [port(torch.tensor(i, dtype=torch.int32)) for i in range(121)]
        want = [ref(jnp.asarray(i, jnp.int32)) for i in range(121)]
        assert all(g.dtype == torch.float32 for g in got)
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], rtol=0, atol=1e-7)


@pytest.mark.parametrize("clip_norm", [1.0, None])
def test_make_optimizer_equals_reference(clip_norm):
    lr_fn = dict(base_lr=1e-2, warmup=2, total_steps=10)
    init, update = P.make_optimizer(
        lr_fn=P.linear_warmup_cosine(**lr_fn), clip_norm=clip_norm)
    r_init, r_update = R.make_optimizer(
        lr_fn=R.linear_warmup_cosine(**lr_fn), clip_norm=clip_norm)
    params = arrays(6)
    p, s = to_port(params), None
    rp, rs = to_ref(params), None
    s, rs = init(p), r_init(rp)
    for step in range(4):
        grads = arrays(20 + step, 3.0)
        p, s, m = update(p, to_port(grads), s)
        rp, rs, rm = r_update(rp, to_ref(grads), rs)
        np.testing.assert_allclose(float(m["grad_norm"]), float(rm["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]), rtol=1e-7)
    assert_state_close(p, rp, 1e-6)
    assert_state_close(s.m, rs.m, 1e-6)


def test_int8_groups_share_the_stacked_scale():
    """Per-layer slices grouped as one stacked reference leaf get the
    reference's per-tensor scale of the stack."""
    from repro_torch.models.convert import stacked_groups

    rng = np.random.default_rng(8)
    stack = (rng.normal(size=(3, 40, 24)) * [[[0.1]], [[1.0]], [[0.01]]]
             ).astype(np.float32)
    vec = rng.normal(size=(24,)).astype(np.float32)
    port = {"embed": torch.tensor(vec)}
    port.update({f"layers.{i}.ffn.w_up": torch.tensor(stack[i])
                 for i in range(3)})
    groups = stacked_groups(port)
    assert groups == [["embed"], [f"layers.{i}.ffn.w_up" for i in range(3)]]
    q, s = P.compress_int8(port, groups)
    rq, rs = R.compress_int8({"embed": jnp.asarray(vec),
                              "w_up": jnp.asarray(stack)})
    for i in range(3):
        np.testing.assert_array_equal(q[f"layers.{i}.ffn.w_up"].numpy(),
                                      np.asarray(rq["w_up"][i]))
        assert float(s[f"layers.{i}.ffn.w_up"]) == float(rs["w_up"])
    np.testing.assert_array_equal(q["embed"].numpy(), np.asarray(rq["embed"]))
