"""WKV6 entry point: a CPU tensor runs the plain version, a CUDA tensor
launches the hand-written kernel (``csrc/wkv6.cu``) or raises.

``wkv6(r, k, v, w, u, state0)`` takes the reference's public layout: r, k,
w (B, H, T, Dk) and v (B, H, T, Dv), float32 or bfloat16 with Dk, Dv <=
128; u (H, Dk) and state0 (B, H, Dk, Dv), float32 (state0 None means
zeros).  It returns ``(o (B, H, T, Dv) in r's type, state (B, H, Dk, Dv)
float32)``, the state after the last step, so chained calls equal one
call.  Any T is taken as it is (the reference pads T to its time tile).
The wrapper carries a ``launches`` counter that grows by one per kernel
launch and nowhere else.

Gradients: when grad mode is on and any of r, k, v, w, u or state0
requires grad, the call goes through ``WKV6`` (a
``torch.autograd.Function``).  Its forward is the same call (the kernel on
a CUDA tensor, the plain version on a CPU tensor); its backward recomputes
``ref.wkv6_plain`` on the saved inputs and returns that VJP, with the
cotangents of both outputs (o and the final state), for r, k, v, w, u and
state0, as the reference's ``custom_vjp`` differentiates ``wkv6_ref``.
There is no backward kernel.  A recompute of the forward
(``torch.utils.checkpoint``) launches the kernel again and counts again.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_wkv import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "wkv6.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {"wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                      _P]}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 128


def library() -> _build.BuiltLibrary:
    """The compiled kernel (built at first call), with ctypes signatures."""
    built = _build.load(SOURCE)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
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
    """The kernel (or, on a CPU tensor, the plain version) forward; the
    plain version's VJP backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        ctx.has_state0 = state0 is not None
        ctx.save_for_backward(r, k, v, w, u, *(() if state0 is None
                                                else (state0,)))
        return _forward(r, k, v, w, u, state0)

    @staticmethod
    def backward(ctx, grad_o, grad_state):
        inputs = [x.detach().requires_grad_(need) for x, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            o, state = ref.wkv6_plain(*inputs[:5],
                                      inputs[5] if ctx.has_state0 else None)
            grads = iter(torch.autograd.grad((o, state), wanted,
                                             (grad_o, grad_state),
                                             allow_unused=True))
        out = [next(grads) if x.requires_grad else None for x in inputs]
        return tuple(out) + ((None,) if not ctx.has_state0 else ())


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


wkv6.launches = 0

KERNELS = {"wkv6": wkv6}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
