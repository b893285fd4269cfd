"""CNI-encode entry point: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel (``csrc/cni_encode.cu``) or raises.

``cni_encode(counts, d_max, max_p)`` digests every count row of ``counts``
(..., L) int32 and returns ``(deg, cni, cni_log)`` shaped like the leading
dimensions: int32 label degree, int64 exact digest saturating at SAT64,
float32 log digest.  The Pascal and log-ħ tables come from ``core/cni.py``
(built on the host, uploaded once per (d_max, max_p, device)).  The
wrapper carries a ``launches`` counter that grows by one per kernel launch
and nowhere else.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import cni as cni_mod
from repro_torch.kernels import _build
from repro_torch.kernels.cni_encode import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "cni_encode.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "cni_encode": [_P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P],
}


def library() -> _build.BuiltLibrary:
    """The compiled kernel (built at first call), with ctypes signatures."""
    built = _build.load(SOURCE)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


def cni_encode(counts: torch.Tensor, d_max: int, max_p: int):
    """(..., L) int32 count rows -> (deg int32, cni int64, cni_log f32),
    each shaped ``counts.shape[:-1]``."""
    if not isinstance(counts, torch.Tensor) or counts.dtype != torch.int32 \
            or counts.dim() < 1:
        raise TypeError(f"counts: expected an int32 tensor (..., L), got "
                        f"{getattr(counts, 'dtype', type(counts))} "
                        f"{tuple(getattr(counts, 'shape', ()))}")
    if d_max < 0 or max_p < 0:
        raise ValueError(f"d_max and max_p must be >= 0, got {d_max}, {max_p}")
    batch_shape = counts.shape[:-1]
    n_labels = counts.shape[-1]
    rows = counts.reshape(-1, n_labels).contiguous()
    if counts.device.type == "cpu":
        deg, cni, cni_log = ref.cni_encode_ref(rows, d_max, max_p)
    elif counts.device.type == "cuda":
        deg, cni, cni_log = _launch(rows, d_max, max_p)
    else:
        raise ValueError(f"no cni_encode kernel for device {counts.device}")
    return (deg.reshape(batch_shape), cni.reshape(batch_shape),
            cni_log.reshape(batch_shape))


def _launch(rows: torch.Tensor, d_max: int, max_p: int):
    n, n_labels = rows.shape
    dev = rows.device
    deg = torch.empty(n, dtype=torch.int32, device=dev)
    cni = torch.empty(n, dtype=torch.int64, device=dev)
    cni_log = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        pascal = cni_mod._pascal_table(d_max, max_p, dev)
        log_t = cni_mod._log_hbar(d_max, max_p, dev)
        rc = library().lib.cni_encode(
            rows.data_ptr(), n, n_labels, d_max, max_p, pascal.data_ptr(),
            log_t.data_ptr(), deg.data_ptr(), cni.data_ptr(),
            cni_log.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"cni_encode launch failed with cudaError {rc}")
        cni_encode.launches += 1
    return deg, cni, cni_log


cni_encode.launches = 0

KERNELS = {"cni_encode": cni_encode}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
