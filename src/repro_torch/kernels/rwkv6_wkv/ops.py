"""WKV6 entry points: a CPU tensor runs the plain version, a CUDA tensor
launches the hand-written kernel (``csrc/wkv6.cu``) or raises.

``wkv6(r, k, v, w, u, state0)`` takes the reference's public layout: r, k,
w (B, H, T, Dk) and v (B, H, T, Dv), float32 or bfloat16 with Dk, Dv <=
128; u (H, Dk) and state0 (B, H, Dk, Dv), float32 (state0 None means
zeros).  It returns ``(o (B, H, T, Dv) in r's type, state (B, H, Dk, Dv)
float32)``, the state after the last step, so chained calls equal one
call.  Any T is taken as it is (the reference pads T to its time tile).

``wkv6_backward(r, k, v, w, u, state0, grad_o, grad_state)`` is the VJP of
``wkv6``: with the cotangents of o and of the final state (either may be
None) it returns ``(dr, dk, dv, dw, du, dstate0)``, dr, dk, dv and dw in
their inputs' type, du in u's, dstate0 float32 (None when state0 is None).
On a CPU tensor it runs ``ref.wkv6_backward_plain``; on a CUDA tensor it
launches the backward kernel (with its finishing pass, one call).

Each wrapper carries a ``launches`` counter that grows by one per kernel
launch and nowhere else.

Gradients: when grad mode is on and any of r, k, v, w, u or state0
requires grad, ``wkv6`` goes through ``WKV6`` (a
``torch.autograd.Function``).  Its forward is the same call (the kernel on
a CUDA tensor, the plain version on a CPU tensor); its backward is
``wkv6_backward`` on the saved inputs, which gives the gradient the
reference's ``custom_vjp`` takes of ``wkv6_ref``.  There is no fallback to
a plain VJP on the card.  A recompute of the forward
(``torch.utils.checkpoint``) launches the forward kernel again and counts
again.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "wkv6": [_P] * 8 + [_L, _I, _I, _I, _I, _I, _P],
    "wkv6_backward": [_P] * 17 + [_L, _I, _I, _I, _I, _I, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128


def library() -> _build.BuiltLibrary:
    """The compiled kernel (built at first call), with ctypes signatures."""
    built = _build.load(SOURCE)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    scratch = built.lib.wkv6_backward_scratch
    scratch.argtypes = [_L, _I, _I, _I, ctypes.POINTER(ctypes.c_int)]
    scratch.restype = _L
    return built


def _check(r, k, v, w, u, state0):
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4 \
                or t.dtype not in _DTYPES:
            raise TypeError(f"{name}: expected a float32 or bfloat16 tensor "
                            f"(B, H, T, D), got {getattr(t, 'dtype', type(t))} "
                            f"{tuple(getattr(t, 'shape', ()))}")
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (b, h, t):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and w {tuple(w.shape)} do not fit")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"u {tuple(u.shape)} is not (H, Dk) = {(h, dk)}")
    if state0 is not None and tuple(state0.shape) != (b, h, dk, dv):
        raise ValueError(f"state0 {tuple(state0.shape)} is not {(b, h, dk, dv)}")
    devices = {x.device for x in (r, k, v, w, u) + (() if state0 is None
                                                    else (state0,))}
    if len(devices) != 1 or len({r.dtype, k.dtype, v.dtype, w.dtype}) != 1:
        raise ValueError("r, k, v, w share one dtype; every input one device")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0=None):
    """RWKV-6 WKV -> (o (B, H, T, Dv), state (B, H, Dk, Dv) float32)."""
    _check(r, k, v, w, u, state0)
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (r, k, v, w, u, state0)):
        return WKV6.apply(r, k, v, w, u, state0)
    return _forward(r, k, v, w, u, state0)


class WKV6(torch.autograd.Function):
    """The kernel (or, on a CPU tensor, the plain version) in both
    directions: ``wkv6`` forward, ``wkv6_backward`` backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        ctx.has_state0 = state0 is not None
        ctx.save_for_backward(r, k, v, w, u, *(() if state0 is None
                                                else (state0,)))
        return _forward(r, k, v, w, u, state0)

    @staticmethod
    def backward(ctx, grad_o, grad_state):
        r, k, v, w, u, *state0 = ctx.saved_tensors
        grads = wkv6_backward(r, k, v, w, u, state0[0] if ctx.has_state0
                              else None, grad_o, grad_state)
        return tuple(g if need else None for g, need
                     in zip(grads, ctx.needs_input_grad))


def _forward(r, k, v, w, u, state0):
    if r.device.type == "cpu":
        return ref.wkv6_plain(r, k, v, w, u, state0)
    if r.device.type == "cuda":
        return _launch(r, k, v, w, u, state0)
    raise ValueError(f"no wkv6 kernel for device {r.device}")


def _launch(r, k, v, w, u, state0):
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"Dk {dk} and Dv {dv} must be <= {MAX_DIM}")
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    u = u.float().contiguous()
    s0 = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
          if state0 is None else state0.float().contiguous())
    o = torch.empty((b, h, t, dv), dtype=r.dtype, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    if b * h:
        rc = library().lib.wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), o.data_ptr(), state.data_ptr(),
            b * h, h, t, dk, dv, _DTYPES[r.dtype],
            torch.cuda.current_stream(r.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"wkv6 launch failed with cudaError {rc}")
        wkv6.launches += 1
    return o, state


def wkv6_backward(r, k, v, w, u, state0, grad_o, grad_state):
    """The VJP of ``wkv6`` -> (dr, dk, dv, dw, du, dstate0 or None)."""
    _check(r, k, v, w, u, state0)
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    for name, g, shape in (("grad_o", grad_o, (b, h, t, dv)),
                           ("grad_state", grad_state, (b, h, dk, dv))):
        if g is not None and (tuple(g.shape) != shape or g.device != r.device):
            raise ValueError(f"{name} {tuple(g.shape)} on {g.device} is not "
                             f"{shape} on {r.device}")
    if r.device.type == "cpu":
        return ref.wkv6_backward_plain(r, k, v, w, u, state0, grad_o,
                                       grad_state)
    if r.device.type == "cuda":
        return _launch_backward(r, k, v, w, u, state0, grad_o, grad_state)
    raise ValueError(f"no wkv6_backward kernel for device {r.device}")


def _ptr(x):
    """A tensor's device pointer, or NULL for None."""
    return None if x is None else x.data_ptr()


def _launch_backward(r, k, v, w, u, state0, grad_o, grad_state):
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if dk > MAX_DIM or dv > MAX_DIM:
        raise ValueError(f"Dk {dk} and Dv {dv} must be <= {MAX_DIM}")
    dev = r.device
    r, k, v, w = (x.contiguous() for x in (r, k, v, w))
    u32 = u.float().contiguous()
    s0 = None if state0 is None else state0.float().contiguous()
    go = None if grad_o is None else grad_o.to(r.dtype).contiguous()
    gs = None if grad_state is None else grad_state.float().contiguous()
    dr, dkk, dw = (torch.empty_like(x) for x in (r, k, w))
    dvv = torch.empty_like(v)
    du = torch.zeros((h, dk), dtype=torch.float32, device=dev)
    ds0 = (None if state0 is None else
           torch.empty((b, h, dk, dv), dtype=torch.float32, device=dev))
    if b * h:
        lib = library().lib
        n_rb = ctypes.c_int()
        n_ckpt = lib.wkv6_backward_scratch(b * h, t, dk, dv, ctypes.byref(n_rb))
        ckpt = torch.empty(n_ckpt, dtype=torch.float32, device=dev)
        dv_part = torch.empty((n_rb.value, b, h, t, dv), dtype=torch.float32,
                              device=dev)
        du_part = torch.empty((b, h, dk), dtype=torch.float32, device=dev)
        rc = lib.wkv6_backward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), _ptr(s0), _ptr(go), _ptr(gs), ckpt.data_ptr(),
            dr.data_ptr(), dkk.data_ptr(), dvv.data_ptr(), dw.data_ptr(),
            dv_part.data_ptr(), du_part.data_ptr(), du.data_ptr(), _ptr(ds0),
            b * h, h, t, dk, dv, _DTYPES[r.dtype],
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"wkv6_backward launch failed with cudaError "
                               f"{rc}")
        wkv6_backward.launches += 1
    return dr, dkk, dvv, dw, du.to(u.dtype), ds0


wkv6.launches = 0
wkv6_backward.launches = 0

KERNELS = {"wkv6": wkv6, "wkv6_backward": wkv6_backward}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
