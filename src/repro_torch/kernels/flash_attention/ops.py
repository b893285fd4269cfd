"""Flash-attention entry point: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel (``csrc/flash_attention.cu``) or
raises.

``flash_attention(q, k, v, causal, window, q_offset, kv_len)`` takes q
(B, Hq, Sq, D), k (B, Hkv, Skv, D) and v (B, Hkv, Skv, Dv), float32 or
bfloat16, with Dv <= D and Hq a multiple of Hkv, and returns (B, Hq, Sq,
Dv) in q's type; the scale is 1/sqrt(D), q's width, as the reference's.
V may be narrower than the QK head: MLA's is (minicpm3-4b's 96 / 64,
deepseek-v3's 192 / 128).  ``q_offset`` (the position of query row 0) and
``kv_len`` (keys at or past it are masked) are plain runtime integers, so
one compiled kernel serves every decode position; the reference's jitted
decode cannot pass its traced position to the Pallas kernel (ROADMAP C6).
The kernels are built for the (D, Dv) pairs in ``KERNEL_WIDTHS`` and read
q, k and v there in place, through their batch, head and row strides (MLA's
V straight from its einsum, a permuted view, is not copied; a tensor is
copied only where its last axis is not contiguous or a row is off a 16-byte
boundary); the ragged edges are masked in the kernel.  Any other width is
padded with zero columns to the first built pair that holds it (the
reduced MLA's 24 / 16 runs at 32 / 32) and the output cut back to Dv; on
the card a width past every pair raises.
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
                        _I, _I, _I, _F, _P, _P],
    "flash_attention_smem": [_I, _I, _I, _I, _I, _I],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the (QK, V) head widths the kernels are built for, narrowest first
KERNEL_WIDTHS = ((16, 16), (32, 32), (64, 64), (96, 64), (128, 128),
                 (192, 128))


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
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d
            or v.shape[3] > d):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)} (v may be narrower than k, "
                         f"not wider)")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"{hq} query heads are not a multiple of "
                         f"{k.shape[1]} KV heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None, q_offset: int = 0,
                    kv_len=None) -> torch.Tensor:
    """(B, Hq, Sq, D) x (B, Hkv, Skv, D) x (B, Hkv, Skv, Dv) -> (B, Hq, Sq,
    Dv) in q.dtype."""
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


def kernel_width(d: int, dv: int) -> tuple[int, int]:
    """The built (D, Dv) pair a (d, dv) call runs at: the first that holds
    both widths."""
    for width in KERNEL_WIDTHS:
        if width[0] >= d and width[1] >= dv:
            return width
    raise ValueError(f"head dims {d} / {dv} (QK / V) are past every width "
                     f"the kernels are built for, {KERNEL_WIDTHS}")


def _launch(q, k, v, causal, window, q_offset, kv_len):
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    width, width_v = kernel_width(d, dv)
    q, k = (_aligned(x, width) for x in (q, k))
    v = _aligned(v, width_v)
    _check_strides(q, k, v)
    out = q.new_empty((b, hq, sq, width_v))
    if out.numel():
        strides = (ctypes.c_int * 9)(*(
            x.stride(i) for x in (q, k, v) for i in range(3)))
        rc = library().lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, width, width_v, int(causal),
            0 if window is None else int(window), q_offset,
            skv if kv_len is None else int(kv_len), _DTYPES[q.dtype],
            1.0 / math.sqrt(d), strides,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"flash_attention launch failed with cudaError {rc}")
        flash_attention.launches += 1
    return out if width_v == dv else out[..., :dv]


def _aligned(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` itself where the kernels can read it in place: ``width`` wide,
    its last axis contiguous and every row on a 16-byte boundary, as their
    16-byte copies need; otherwise a copy that is (zero columns appended
    up to ``width``)."""
    if x.shape[-1] != width:
        return torch.nn.functional.pad(x, (0, width - x.shape[-1]))
    if in_place(x):
        return x
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def in_place(x: torch.Tensor) -> bool:
    """Whether the kernels read ``x`` where it lies: a unit stride on the
    last axis, and the base and every stride of a longer axis a multiple
    of 16 bytes."""
    size = x.element_size()
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0
        for n, st in zip(x.shape[:-1], x.stride()[:-1]))


def _check_strides(*xs: torch.Tensor) -> None:
    """The kernels take each (batch, head, row) stride as a 32-bit int."""
    for x in xs:
        if max(x.stride()[:3]) >= 2**31:
            raise ValueError(f"a {tuple(x.shape)} tensor with strides "
                             f"{x.stride()}: the kernels take strides below "
                             f"2^31 elements")


flash_attention.launches = 0

KERNELS = {"flash_attention": flash_attention}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
