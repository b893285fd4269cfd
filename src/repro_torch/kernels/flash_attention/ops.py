"""Flash-attention entry point: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel (``csrc/flash_attention.cu``) or
raises.

``flash_attention(q, k, v, causal, window, q_offset, kv_len)`` takes q
(B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), float32 or bfloat16 with D <= 128
and Hq a multiple of Hkv, and returns (B, Hq, Sq, D) in q's type.
``q_offset`` (the position of query row 0) and ``kv_len`` (keys at or past
it are masked) are plain runtime integers, so one compiled kernel serves
every decode position; the reference's jitted decode cannot pass its traced
position to the Pallas kernel (ROADMAP C6).  Nothing is padded: the kernel
masks the ragged edges itself, and a head dim outside {16, 32, 64, 128} is
padded with zero columns to the next of them (the scale stays 1/sqrt(D)).
Each call is one kernel launch: the decode kernel below 16 query rows, the
prefill kernel from 16 up.  The wrapper carries a ``launches`` counter that
grows by one per kernel launch and nowhere else.

Gradients: when grad mode is on and q, k or v requires grad, the call goes
through ``FlashAttention`` (a ``torch.autograd.Function``).  Its forward is
the same call (the kernel on a CUDA tensor, the plain version on a CPU
tensor); its backward recomputes ``ref.mha_plain`` on the saved q, k and v
and returns that VJP for q, k and v, as the reference's ``custom_vjp``
differentiates ``mha_ref``.  There is no backward kernel.  A recompute of
the forward (``torch.utils.checkpoint``) launches the kernel again and
counts again.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _F, _P],
    "flash_attention_smem": [_I, _I, _I, _I, _I],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
KERNEL_HEAD_DIMS = (16, 32, 64, 128)  # the widths the kernels are built for


def library() -> _build.BuiltLibrary:
    """The compiled kernel (built at first call), with ctypes signatures."""
    built = _build.load(SOURCE)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor) or t.dim() != 4 \
                or t.dtype not in _DTYPES:
            raise TypeError(f"{name}: expected a float32 or bfloat16 tensor "
                            f"(B, H, S, D), got {getattr(t, 'dtype', type(t))} "
                            f"{tuple(getattr(t, 'shape', ()))}")
    if not (q.dtype == k.dtype == v.dtype and q.device == k.device == v.device):
        raise ValueError("q, k and v must share one dtype and one device")
    b, hq, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} query heads are not a multiple of "
                         f"{k.shape[1]} KV heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None, q_offset: int = 0,
                    kv_len=None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D)^2 -> (B, Hq, Sq, D) in q.dtype."""
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, q_offset, kv_len)
    return _forward(q, k, v, causal, window, q_offset, kv_len)


class FlashAttention(torch.autograd.Function):
    """The kernel (or, on a CPU tensor, the plain version) forward; the
    plain version's VJP backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset,
                        kv_len=kv_len)
        return _forward(q, k, v, causal, window, q_offset, kv_len)

    @staticmethod
    def backward(ctx, grad_out):
        inputs = [x.detach().requires_grad_(need) for x, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = ref.mha_plain(*inputs, **ctx.args)
            grads = iter(torch.autograd.grad(out, wanted, grad_out))
        return tuple(next(grads) if x.requires_grad else None
                     for x in inputs) + (None,) * 4


def _forward(q, k, v, causal, window, q_offset, kv_len):
    if q.device.type == "cpu":
        return ref.mha_plain(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_len=kv_len)
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, window, int(q_offset), kv_len)
    raise ValueError(f"no flash_attention kernel for device {q.device}")


def _launch(q, k, v, causal, window, q_offset, kv_len):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is above the kernel's {MAX_HEAD_DIM}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    width = next(w for w in KERNEL_HEAD_DIMS if w >= d)
    q, k, v = (_aligned(x, width) for x in (q, k, v))
    out = torch.empty_like(q)
    if out.numel():
        rc = library().lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, width, int(causal),
            0 if window is None else int(window), q_offset,
            skv if kv_len is None else int(kv_len), _DTYPES[q.dtype],
            1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"flash_attention launch failed with cudaError {rc}")
        flash_attention.launches += 1
    return out if width == d else out[..., :d]


def _aligned(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` contiguous, ``width`` wide (zero columns appended) and on a
    16-byte boundary, as the kernels' 16-byte copies need."""
    if x.shape[-1] != width:
        x = torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


flash_attention.launches = 0

KERNELS = {"flash_attention": flash_attention}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
