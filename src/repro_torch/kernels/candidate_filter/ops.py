"""Candidate-filter entry point: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel (``csrc/candidate_filter.cu``) or
raises.

``candidate_filter(ord_d, deg_d, cni_d, ord_q, deg_q, cni_q, mode=, eps=)``
takes the reference's argument order: data digests (V,) or (B, V) against
query digests (U,) or (B, U) with the same leading shape, and returns the
(V, U) or (B, V, U) bool cniMatch grid.  ``ord``/``deg`` are int32; ``cni``
is int64 in ``mode="exact"`` and float32 in ``mode="log"``.  The wrapper
carries a ``launches`` counter that grows by one per kernel launch and
nowhere else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.candidate_filter import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "candidate_filter.cu"

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "candidate_filter": [_P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _F, _F, _P, _P],
    "candidate_filter_smem": [_L, _I],
}
_CNI_DTYPE = {"exact": torch.int64, "log": torch.float32}


def library() -> _build.BuiltLibrary:
    """The compiled kernel (built at first call), with ctypes signatures."""
    built = _build.load(SOURCE)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


def _check(mode, ord_d, deg_d, cni_d, ord_q, deg_q, cni_q):
    """Validate the digests (both routes take the same types and shapes)."""
    if mode not in _CNI_DTYPE:
        raise ValueError(f"mode must be 'exact' or 'log', got {mode!r}")
    want = (("ord_d", ord_d, torch.int32), ("deg_d", deg_d, torch.int32),
            ("cni_d", cni_d, _CNI_DTYPE[mode]), ("ord_q", ord_q, torch.int32),
            ("deg_q", deg_q, torch.int32), ("cni_q", cni_q, _CNI_DTYPE[mode]))
    for name, x, dtype in want:
        if not isinstance(x, torch.Tensor) or x.dtype != dtype \
                or x.dim() not in (1, 2):
            raise TypeError(f"{name}: expected a 1-d or 2-d {dtype} tensor, "
                            f"got {getattr(x, 'dtype', type(x))} "
                            f"{tuple(getattr(x, 'shape', ()))}")
        if x.device != ord_d.device:
            raise ValueError(f"{name} is on {x.device}, ord_d on {ord_d.device}")
    if not (ord_d.shape == deg_d.shape == cni_d.shape):
        raise ValueError("ord_d, deg_d and cni_d must have one shape")
    if not (ord_q.shape == deg_q.shape == cni_q.shape):
        raise ValueError("ord_q, deg_q and cni_q must have one shape")
    if ord_d.shape[:-1] != ord_q.shape[:-1]:
        raise ValueError(f"data digests {tuple(ord_d.shape)} and query "
                         f"digests {tuple(ord_q.shape)} need one leading shape")


def candidate_filter(ord_d, deg_d, cni_d, ord_q, deg_q, cni_q, *,
                     mode: str = "exact", eps: float = 1e-4) -> torch.Tensor:
    """(..., V, U) bool cniMatch grid (see the module docstring)."""
    args = (ord_d, deg_d, cni_d, ord_q, deg_q, cni_q)
    _check(mode, *args)
    if ord_d.device.type == "cpu":
        return ref.candidate_filter_ref(*args, mode=mode, eps=eps)
    if ord_d.device.type != "cuda":
        raise ValueError(f"no candidate_filter kernel for device {ord_d.device}")
    v, u = ord_d.shape[-1], ord_q.shape[-1]
    b = ord_d.shape[0] if ord_d.dim() == 2 else 1
    out = torch.empty(ord_d.shape[:-1] + (v, u), dtype=torch.bool,
                      device=ord_d.device)
    if out.numel():
        ptrs = [x.contiguous() for x in args]  # kept alive across the launch
        rc = library().lib.candidate_filter(
            *(x.data_ptr() for x in ptrs), b, v, u, int(mode == "log"),
            eps, ref.LOG_SAT_THRESH, out.data_ptr(),
            torch.cuda.current_stream(ord_d.device).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"candidate_filter launch failed with "
                               f"cudaError {rc}")
        candidate_filter.launches += 1
    return out


candidate_filter.launches = 0

KERNELS = {"candidate_filter": candidate_filter}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
