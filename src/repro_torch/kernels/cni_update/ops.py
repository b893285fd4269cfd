"""CNI-update entry point: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel (``csrc/cni_update.cu``) or raises.

``cni_update(rows, delta, d_max, max_p)`` takes the incremental index's
frontier count rows and the batch's per-row count deltas, both (F, L)
int32, and returns ``(new_rows, deg, cni, cni_log)``: ``rows + delta``,
then the label degree (int32), the exact digest (int64, saturating at
SAT64) and the float32 log digest of each new row, equal bit for bit to
``cni_encode`` of the new rows.  The kernel walks rows of any count, so
nothing is padded (the reference pads F to its 256-row block).  The
wrapper carries a ``launches`` counter that grows by one per kernel launch
and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.core import cni as cni_mod
from repro_torch.kernels import _build
from repro_torch.kernels.cni_update import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "cni_update.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "cni_update": [_P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P, _P],
    "cni_update_plan": [_L, _I, _P],
}


def library() -> _build.BuiltLibrary:
    """The compiled kernel (built at first call), with ctypes signatures."""
    built = _build.load(SOURCE)
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(built.lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return built


@functools.lru_cache(maxsize=8)
def term_table(d_max: int, max_p: int, device: torch.device) -> torch.Tensor:
    """The kernel's table: for each flat term index of ``core/cni.py``'s
    (d_max + 1, max_p + 1) tables, 16 bytes (int32 x 4): the Pascal term's
    low and high halves, the bits of the float32 log term, and 0, so one
    16-byte load a position fetches both terms."""
    pascal = cni_mod._pascal_table(d_max, max_p, device).reshape(-1)
    log_t = cni_mod._log_hbar(d_max, max_p, device).reshape(-1)
    halves = pascal.view(torch.int32).view(-1, 2)  # little-endian: low first
    return torch.stack([halves[:, 0], halves[:, 1], log_t.view(torch.int32),
                        torch.zeros_like(halves[:, 0])], 1).contiguous()


def cni_update(rows: torch.Tensor, delta: torch.Tensor, d_max: int, max_p: int):
    """(F, L) int32 rows and deltas -> (new_rows (F, L) int32, deg (F,)
    int32, cni (F,) int64, cni_log (F,) float32)."""
    for name, t in (("rows", rows), ("delta", delta)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != 2:
            raise TypeError(f"{name}: expected an int32 tensor (F, L), got "
                            f"{getattr(t, 'dtype', type(t))} "
                            f"{tuple(getattr(t, 'shape', ()))}")
    if rows.shape != delta.shape or rows.device != delta.device:
        raise ValueError(f"rows {tuple(rows.shape)} on {rows.device} and delta "
                         f"{tuple(delta.shape)} on {delta.device} must match")
    if d_max < 0 or max_p < 0:
        raise ValueError(f"d_max and max_p must be >= 0, got {d_max}, {max_p}")
    rows, delta = rows.contiguous(), delta.contiguous()
    if rows.device.type == "cpu":
        return ref.cni_update_ref(rows, delta, d_max, max_p)
    if rows.device.type == "cuda":
        return _launch(rows, delta, d_max, max_p)
    raise ValueError(f"no cni_update kernel for device {rows.device}")


def _launch(rows: torch.Tensor, delta: torch.Tensor, d_max: int, max_p: int):
    n, n_labels = rows.shape
    dev = rows.device
    new_rows = torch.empty_like(rows)
    deg = torch.empty(n, dtype=torch.int32, device=dev)
    cni = torch.empty(n, dtype=torch.int64, device=dev)
    cni_log = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        terms = term_table(d_max, max_p, dev)
        rc = library().lib.cni_update(
            rows.data_ptr(), delta.data_ptr(), n, n_labels, d_max, max_p,
            terms.data_ptr(), new_rows.data_ptr(),
            deg.data_ptr(), cni.data_ptr(), cni_log.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"cni_update launch failed with cudaError {rc}")
        cni_update.launches += 1
    return new_rows, deg, cni, cni_log


cni_update.launches = 0

KERNELS = {"cni_update": cni_update}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
