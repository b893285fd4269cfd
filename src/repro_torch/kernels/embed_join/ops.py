"""Embed-join entry points: a CPU tensor runs the plain version, a CUDA
tensor launches the hand-written kernel (``csrc/embed_join.cu``) or raises.

Three public entry points, in the reference's argument order with the
(N, N) edge-label matrix ``elab`` in the place of the reference's (N, C)
``elab_cols``, each checking its operands:

* ``embed_join``       — the (R, C) bool validity grid;
* ``embed_join_count`` — (R,) int32 per-row survivor counts;
* ``embed_join_emit``  — scatters survivors' flat cell ids into their
  exclusive-scan slots of ``idx_map``, in place.

Operand types: ``table`` (R, T) int32, ``row_valid`` (R,) bool, ``cand``
(C,) int32, ``cand_valid`` (C,) bool, ``elab`` (N, N) int32, ``q_pos`` /
``q_lab`` (J,) int32, ``q_valid`` (J,) bool, ``row_off`` (R,) int64,
``idx_map`` int64; all contiguous and on one device.

Two more back the device join's level loop
(``core/search.py::_partitioned_join``), which checks its operands once a
query (``check_level_operands``) and then launches without per-call checks,
every row, candidate and constraint live (null masks in the kernels):

* ``count_live``      — the count pass into a caller's (R,) int32 buffer;
* ``emit_table_live`` — the emit pass writing each survivor's next-table
  row (its parent row, then ``cand[c]``) at its slot of ``out``.

Each entry carries a ``launches`` counter that grows by one per kernel
launch and nowhere else; ``count_live`` counts on ``embed_join_count``'s
(the same kernel).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embed_join import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "embed_join.cu"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_JOIN_ARGTYPES = [_P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _I]
_ARGTYPES = {
    "embed_join_count": _JOIN_ARGTYPES + [_P, _P],
    "embed_join_grid": _JOIN_ARGTYPES + [_P, _P],
    "embed_join_emit": _JOIN_ARGTYPES + [_P, _L, _P, _L, _P],
    "embed_join_emit_table": _JOIN_ARGTYPES + [_P, _P, _L, _P],
    "embed_join_plan": [_I, _I, _I, _I, _I, _P],
}


def library() -> _build.BuiltLibrary:
    """The compiled kernels (built at first call), with ctypes signatures
    (set once per loaded library)."""
    built = _build.load(SOURCE)
    if not getattr(built, "typed", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(built.lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        built.typed = True
    return built


def _check(table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid):
    """Validate the join operands (both routes take the same types)."""
    want = (
        ("table", table, torch.int32, 2), ("row_valid", row_valid, torch.bool, 1),
        ("cand", cand, torch.int32, 1), ("cand_valid", cand_valid, torch.bool, 1),
        ("elab", elab, torch.int32, 2), ("q_pos", q_pos, torch.int32, 1),
        ("q_lab", q_lab, torch.int32, 1), ("q_valid", q_valid, torch.bool, 1),
    )
    for name, x, dtype, ndim in want:
        if not isinstance(x, torch.Tensor) or x.dtype != dtype or x.dim() != ndim:
            raise TypeError(f"{name}: expected a {ndim}-d {dtype} tensor, got "
                            f"{getattr(x, 'dtype', type(x))} "
                            f"{tuple(getattr(x, 'shape', ()))}")
        if x.device != table.device:
            raise ValueError(f"{name} is on {x.device}, table on {table.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    r, t = table.shape
    if row_valid.shape[0] != r or cand_valid.shape[0] != cand.shape[0]:
        raise ValueError("row_valid / cand_valid do not match table / cand")
    if elab.shape[0] != elab.shape[1]:
        raise ValueError(f"elab must be square, got {tuple(elab.shape)}")
    if not (q_pos.shape == q_lab.shape == q_valid.shape):
        raise ValueError("q_pos, q_lab and q_valid must have one length")
    if t < 1:
        raise ValueError("table needs at least one column")


def _join_ptrs(table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid):
    r, t = table.shape
    return (table.data_ptr(), r, t, row_valid.data_ptr(), cand.data_ptr(),
            cand.shape[0], cand_valid.data_ptr(), elab.data_ptr(),
            elab.shape[0], q_pos.data_ptr(), q_lab.data_ptr(),
            q_valid.data_ptr(), q_pos.shape[0])


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no embed-join kernel for device {x.device}")


def embed_join(table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid):
    """(R, C) bool validity grid of one join level."""
    args = (table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid)
    _check(*args)
    if table.device.type == "cpu":
        return ref.embed_join_grid_ref(*args)
    _require_cuda(table)
    out = torch.empty((table.shape[0], cand.shape[0]), dtype=torch.bool,
                      device=table.device)
    if out.numel():
        rc = library().lib.embed_join_grid(*_join_ptrs(*args), out.data_ptr(),
                                           _stream(table.device))
        _raise_if(rc, "embed_join_grid")
        embed_join.launches += 1
    return out


def embed_join_count(table, row_valid, cand, cand_valid, elab, q_pos, q_lab,
                     q_valid):
    """(R,) int32 per-row survivor counts (the count pass)."""
    args = (table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid)
    _check(*args)
    if table.device.type == "cpu":
        return ref.embed_join_count_ref(*args)
    _require_cuda(table)
    counts = torch.empty(table.shape[0], dtype=torch.int32, device=table.device)
    if counts.numel():
        rc = library().lib.embed_join_count(*_join_ptrs(*args),
                                            counts.data_ptr(),
                                            _stream(table.device))
        _raise_if(rc, "embed_join_count")
        embed_join_count.launches += 1
    return counts


def embed_join_emit(idx_map, table, row_valid, cand, cand_valid, elab, q_pos,
                    q_lab, q_valid, row_off, row_base: int):
    """Write ``(row_base + r) * C + c`` at ``idx_map[row_off[r] + rank]`` for
    every valid cell, ``rank`` its exclusive rank within row r (the emit
    pass).  Updates ``idx_map`` in place and returns it."""
    args = (table, row_valid, cand, cand_valid, elab, q_pos, q_lab, q_valid)
    _check(*args)
    for name, x in (("idx_map", idx_map), ("row_off", row_off)):
        if (not isinstance(x, torch.Tensor) or x.dtype != torch.int64
                or x.dim() != 1 or x.device != table.device
                or not x.is_contiguous()):
            raise TypeError(f"{name}: expected a contiguous 1-d int64 tensor "
                            f"on {table.device}")
    if row_off.shape[0] != table.shape[0]:
        raise ValueError("row_off must have one entry per table row")
    if table.device.type == "cpu":
        return ref.embed_join_emit_ref(idx_map, *args, row_off, row_base)
    _require_cuda(table)
    if table.shape[0]:
        rc = library().lib.embed_join_emit(
            *_join_ptrs(*args), row_off.data_ptr(), int(row_base),
            idx_map.data_ptr(), idx_map.shape[0], _stream(table.device),
        )
        _raise_if(rc, "embed_join_emit")
        embed_join_emit.launches += 1
    return idx_map


def check_level_operands(buf, elab):
    """The level loop's one check a query: every table, candidate list and
    constraint it launches on is a view of ``buf`` (a contiguous 1-d int32
    tensor) or a contiguous int32 table it allocated beside it, and
    ``elab`` is the contiguous square int32 matrix on ``buf``'s device."""
    if (not isinstance(buf, torch.Tensor) or buf.dtype != torch.int32
            or buf.dim() != 1 or not buf.is_contiguous()):
        raise TypeError("buf: expected a contiguous 1-d int32 tensor")
    if (not isinstance(elab, torch.Tensor) or elab.dtype != torch.int32
            or elab.dim() != 2 or elab.shape[0] != elab.shape[1]
            or not elab.is_contiguous()):
        raise TypeError("elab: expected a contiguous square int32 matrix")
    if elab.device != buf.device:
        raise ValueError(f"elab is on {elab.device}, buf on {buf.device}")
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no embed-join kernel for device {buf.device}")


def _live_masks(table, cand, q_pos):
    """The all-live masks the plain versions take where a kernel takes
    null."""
    dev = table.device
    return (torch.ones(table.shape[0], dtype=torch.bool, device=dev),
            torch.ones(cand.shape[0], dtype=torch.bool, device=dev),
            torch.ones(q_pos.shape[0], dtype=torch.bool, device=dev))


def _live_ptrs(table, cand, elab, q_pos, q_lab):
    r, t = table.shape
    return (table.data_ptr(), r, t, None, cand.data_ptr(), cand.shape[0],
            None, elab.data_ptr(), elab.shape[0], q_pos.data_ptr(),
            q_lab.data_ptr(), None, q_pos.shape[0])


def count_live(counts, table, cand, elab, q_pos, q_lab):
    """The count pass with every row, candidate and constraint live, into
    ``counts`` ((R,) int32, in place; returned).  No per-call checks: the
    operands are as ``check_level_operands`` describes."""
    if table.device.type == "cpu":
        rv, cv, qv = _live_masks(table, cand, q_pos)
        return counts.copy_(ref.embed_join_count_ref(
            table, rv, cand, cv, elab, q_pos, q_lab, qv))
    if table.shape[0]:
        rc = library().lib.embed_join_count(
            *_live_ptrs(table, cand, elab, q_pos, q_lab), counts.data_ptr(),
            _stream(table.device))
        _raise_if(rc, "embed_join_count")
        embed_join_count.launches += 1
    return counts


def emit_table_live(out, table, cand, elab, q_pos, q_lab, row_off):
    """The emit pass with every row, candidate and constraint live, writing
    survivor (r, c)'s next-table row ``[*table[r], cand[c]]`` at row
    ``row_off[r] + rank`` of ``out`` ((cap, T + 1) int32, in place;
    returned); slots past ``cap`` are dropped, other rows keep their
    contents.  No per-call checks (``check_level_operands``)."""
    if table.device.type == "cpu":
        rv, cv, qv = _live_masks(table, cand, q_pos)
        return ref.embed_join_emit_table_ref(out, table, rv, cand, cv, elab,
                                             q_pos, q_lab, qv, row_off)
    if table.shape[0]:
        rc = library().lib.embed_join_emit_table(
            *_live_ptrs(table, cand, elab, q_pos, q_lab), row_off.data_ptr(),
            out.data_ptr(), out.shape[0], _stream(table.device))
        _raise_if(rc, "embed_join_emit_table")
        emit_table_live.launches += 1
    return out


embed_join.launches = 0
embed_join_count.launches = 0
embed_join_emit.launches = 0
emit_table_live.launches = 0

KERNELS = {
    "embed_join_grid": embed_join,
    "embed_join_count": embed_join_count,
    "embed_join_emit": embed_join_emit,
    "embed_join_emit_table": emit_table_live,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}
