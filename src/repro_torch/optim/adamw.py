"""AdamW with an optional Adafactor-style factored second moment, over a
dict of tensors keyed like the params.

A factored leaf (at least 128 x 128 in its last two axes) keeps row and
column statistics of the squared gradient instead of a full float32
tensor, and its second moment is their rank-1 reconstruction.  The update
follows the reference's order of operations (``repro.optim.adamw``); it is
not ``torch.optim.AdamW``, which orders them otherwise and has no factored
moment.  It runs in place: params, ``m`` and ``v`` are overwritten leaf by
leaf (the reference's jitted step donates its buffers to the same end), so
the state costs params + m + v and one leaf of temporaries.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.optim.grad_utils import clip_scale, global_norm


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    m: dict             # keyed like the params, float32
    v: dict             # full float32, or (row, col) tuples for factored leaves


def _should_factor(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 128 and shape[-2] >= 128


def adamw_init(params: dict, *, factored: bool = False) -> AdamWState:
    m, v = {}, {}
    for name, p in params.items():
        m[name] = torch.zeros_like(p, dtype=torch.float32)
        if factored and _should_factor(p.shape):
            v[name] = (torch.zeros(p.shape[:-1], dtype=torch.float32,
                                   device=p.device),  # row stats
                       torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=torch.float32, device=p.device))
        else:
            v[name] = torch.zeros_like(p, dtype=torch.float32)
    device = next(iter(params.values())).device if params else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device), m, v)


def adamw_state_specs(param_specs: dict, params: dict, *,
                      factored: bool = False) -> AdamWState:
    """The logical axes of the optimizer state, mirroring ``param_specs``
    (a dict of specs keyed like ``params``, flat or nested): ``m`` takes
    each param's, a factored ``v`` the (row, col) statistics' (the spec
    without its last, or without its second-to-last, axis), ``step`` none.
    ``params`` gives the shapes (tensors, meta ones too)."""

    def v_spec(spec, p):
        if isinstance(spec, dict):
            return {k: v_spec(spec[k], p[k]) for k in spec}
        if factored and _should_factor(p.shape):
            return (tuple(spec[:-1]), tuple(spec[:-2]) + tuple(spec[-1:]))
        return spec

    return AdamWState((), param_specs, v_spec(param_specs, params))


@torch.no_grad()
def adamw_update(params: dict, grads: dict, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One step in place; returns (params, the state with its step + 1).
    A leaf is factored when its ``v`` is a (row, col) tuple."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for name, p in params.items():
        g32 = grads[name].float()
        m, v = state.m[name], state.v[name]
        # m = b1 m + (1 - b1) g, in place (each product rounded, then summed)
        m.mul_(b1).add_((1 - b1) * g32)
        if isinstance(v, tuple):
            vr, vc = v
            g2 = g32 * g32
            vr.copy_(b2 * vr + (1 - b2) * g2.mean(-1))
            vc.copy_(b2 * vc + (1 - b2) * g2.mean(-2))
            del g2
            # rank-1 reconstruction (Adafactor): v ~ vr.vc / mean(vr)
            denom = torch.clamp_min(vr.mean(-1, keepdim=True), 1e-30)
            v_hat = vr[..., :, None] * vc[..., None, :] / denom[..., None]
        else:
            v.mul_(b2).add_((1 - b2) * g32 * g32)
            v_hat = v
        # update = (m / bc1) / (sqrt(v_hat / bc2) + eps) + wd p, evaluated in
        # that order with at most two temporaries the size of the leaf alive
        # (the embedding of a large vocab is GBs)
        denom = torch.sqrt(v_hat / bc2).add_(eps)
        del v_hat
        update = (m / bc1).div_(denom)
        del denom
        update.add_(weight_decay * p.float()).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(update)
        else:
            p.copy_((p.float() - update).to(p.dtype))
    return params, AdamWState(step, state.m, state.v)


def make_optimizer(*, lr_fn, factored: bool = False, weight_decay: float = 0.1,
                   clip_norm: Optional[float] = 1.0):
    """Bundled (init, update) closures used by the trainer.  ``update``
    clips the grads it is given in place (the caller gives them up)."""

    def init(params: dict) -> AdamWState:
        return adamw_init(params, factored=factored)

    def update(params: dict, grads: dict, state: AdamWState):
        gnorm = global_norm(grads)
        if clip_norm is not None:
            scale = clip_scale(gnorm, clip_norm)
            for g in grads.values():
                g.mul_(scale)
        lr = lr_fn(state.step)
        new_p, new_s = adamw_update(params, grads, state, lr=lr,
                                    weight_decay=weight_decay)
        return new_p, new_s, {"grad_norm": gnorm, "lr": lr}

    return init, update
