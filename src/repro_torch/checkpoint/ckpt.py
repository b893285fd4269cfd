"""Atomic, manifest-based checkpoints of nested tensor/array trees (port of
``repro.checkpoint.ckpt``, same on-disk layout).

Layout:
    <dir>/step_000000042.tmp/    staged writes (a crash here is ignored)
        leaf_00000.npy ...       one file per leaf, in flatten order
        manifest.json            tree description + shapes + dtypes + extra
    <dir>/step_000000042/        ``os.replace`` of the staging directory
                                 on completion: the commit point

A tree is a nest of dicts (flattened in sorted-key order), lists and
tuples whose leaves are tensors, arrays or scalars; ``None`` holds no leaf.
That is the order ``jax.tree.flatten`` gives the reference's trees, so a
directory either package writes has the same leaf files.

Failure model: every read validates the bytes on disk against the manifest
and raises the typed ``CheckpointError`` (a truncated leaf, a missing file,
a shape or dtype that drifted, an unparseable manifest).  Async writes
capture their exception and re-raise it on ``wait()`` or the next
``save()``: a failed write is reported, never taken for a durable one.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint directory whose bytes disagree with its manifest (or a
    failed write surfacing on ``CheckpointManager.wait``)."""


def _flatten(tree) -> tuple[list, object]:
    """``(leaves, structure)``: dicts in sorted-key order, then lists and
    tuples in order; ``structure`` rebuilds the tree in ``_unflatten``."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            sub_leaves, sub = _flatten(tree[k])
            leaves.extend(sub_leaves)
            subs.append(sub)
        return leaves, ("dict", keys, subs)
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for item in tree:
            sub_leaves, sub = _flatten(item)
            leaves.extend(sub_leaves)
            subs.append(sub)
        return leaves, (type(tree).__name__, None, subs)
    return [tree], "*"


def _unflatten(structure, leaves: list):
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node == "*":
            return next(it)
        kind, keys, subs = node
        items = [build(sub) for sub in subs]
        if kind == "dict":
            return dict(zip(keys, items))
        return tuple(items) if kind == "tuple" else items

    return build(structure)


def _describe(structure) -> str:
    """A readable rendering of the tree's structure for the manifest."""
    if structure is None:
        return "None"
    if structure == "*":
        return "*"
    kind, keys, subs = structure
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_describe(s)}"
                               for k, s in zip(keys, subs)) + "}"
    inner = ", ".join(_describe(s) for s in subs)
    return f"({inner})" if kind == "tuple" else f"[{inner}]"


def _to_host(x, *, copy: bool) -> np.ndarray:
    """A leaf as a host numpy array; ``copy`` makes it own its memory (a CPU
    tensor's ``numpy()`` shares the tensor's storage)."""
    if isinstance(x, torch.Tensor):
        on_host = x.device.type == "cpu"
        x = x.detach().cpu()  # a device tensor's copy is already its own
        return x.clone().numpy() if copy and on_host else x.numpy()
    return np.array(x, copy=True) if copy else np.asarray(x)


def _leaf_paths(d: str, n: int):
    return [os.path.join(d, f"leaf_{i:05d}.npy") for i in range(n)]


def save_checkpoint(directory: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None) -> str:
    """Atomic checkpoint write; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves, structure = _flatten(tree)
    host_leaves = [_to_host(x, copy=False) for x in leaves]
    for path, arr in zip(_leaf_paths(tmp, len(host_leaves)), host_leaves):
        np.save(path, arr)
    manifest = {
        "step": step,
        "n_leaves": len(host_leaves),
        "shapes": [list(a.shape) for a in host_leaves],
        "dtypes": [str(a.dtype) for a in host_leaves],
        "treedef": _describe(structure),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # idempotent re-save of the same step
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic commit
    return final


def load_manifest(directory: str, step: int) -> dict:
    """Parse and check one committed step's manifest (fail closed)."""
    d = os.path.join(directory, f"step_{step:09d}")
    mpath = os.path.join(d, "manifest.json")
    if not os.path.exists(mpath):
        raise CheckpointError(f"checkpoint {d} has no manifest.json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as err:
        raise CheckpointError(
            f"checkpoint manifest {mpath} is not valid JSON: {err}"
        ) from err
    for key in ("step", "n_leaves", "shapes", "dtypes", "extra"):
        if key not in manifest:
            raise CheckpointError(
                f"checkpoint manifest {mpath} is missing key {key!r}"
            )
    n = manifest["n_leaves"]
    if len(manifest["shapes"]) != n or len(manifest["dtypes"]) != n:
        raise CheckpointError(
            f"checkpoint manifest {mpath}: shapes/dtypes length disagrees "
            f"with n_leaves={n}"
        )
    return manifest


def load_leaves(directory: str, step: int) -> tuple[list[np.ndarray], dict]:
    """One committed step's leaf arrays and manifest.

    Every leaf is checked against the manifest (exists, loads, shape,
    dtype); a mismatch raises ``CheckpointError``.
    """
    manifest = load_manifest(directory, step)
    d = os.path.join(directory, f"step_{step:09d}")
    out: list[np.ndarray] = []
    for i, path in enumerate(_leaf_paths(d, manifest["n_leaves"])):
        if not os.path.exists(path):
            raise CheckpointError(
                f"checkpoint {d} is missing leaf file {os.path.basename(path)}"
            )
        try:
            arr = np.load(path)
        except Exception as err:  # noqa: BLE001 — np.load raises many types
            raise CheckpointError(
                f"checkpoint leaf {path} could not be loaded "
                f"(truncated/corrupt): {err}"
            ) from err
        if list(arr.shape) != list(manifest["shapes"][i]):
            raise CheckpointError(
                f"checkpoint leaf {path}: shape {list(arr.shape)} disagrees "
                f"with manifest {manifest['shapes'][i]}"
            )
        if str(arr.dtype) != manifest["dtypes"][i]:
            raise CheckpointError(
                f"checkpoint leaf {path}: dtype {arr.dtype} disagrees with "
                f"manifest {manifest['dtypes'][i]}"
            )
        out.append(arr)
    return out, manifest


def restore_checkpoint(directory: str, step: int, like: Any):
    """Restore into the structure of ``like``: each leaf takes its ``like``
    leaf's dtype, and a tensor leaf its device.  Returns (tree, extra)."""
    leaves_raw, manifest = load_leaves(directory, step)
    leaves, structure = _flatten(like)
    if manifest["n_leaves"] != len(leaves):
        raise CheckpointError(
            f"tree structure changed: checkpoint has "
            f"{manifest['n_leaves']} leaves, `like` has {len(leaves)}"
        )
    out = []
    for i, (arr, ref) in enumerate(zip(leaves_raw, leaves)):
        if list(arr.shape) != list(np.shape(ref)):
            raise CheckpointError(
                f"leaf {i}: shape {arr.shape} != {tuple(np.shape(ref))}"
            )
        if isinstance(ref, torch.Tensor):
            out.append(torch.as_tensor(arr).to(device=ref.device,
                                               dtype=ref.dtype))
        else:
            out.append(np.asarray(arr, dtype=np.asarray(ref).dtype))
    return _unflatten(structure, out), manifest["extra"]


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step; removes stale ``.tmp`` staging directories."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if name.endswith(".tmp"):
            shutil.rmtree(full, ignore_errors=True)  # crashed write
            continue
        if name.startswith("step_") and os.path.exists(
            os.path.join(full, "manifest.json")
        ):
            steps.append(int(name[5:]))
    return max(steps) if steps else None


class CheckpointManager:
    """Keep-last-k manager with optional async writes.

    The writer thread's exception is captured and re-raised, wrapped in
    ``CheckpointError``, by the next ``wait()`` or ``save()``.
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._error_step: Optional[int] = None

    def _raise_pending(self):
        if self._error is not None:
            err, step = self._error, self._error_step
            self._error = None
            self._error_step = None
            raise CheckpointError(
                f"async checkpoint write for step {step} failed: {err}"
            ) from err

    def wait(self):
        """Join the in-flight async write; re-raises its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        self.wait()
        # every leaf is copied to the host here, synchronously and into
        # memory of its own: a CPU tensor's numpy() view shares its storage,
        # and the caller updates tensors such as the index's counts in
        # place on its next batch, which the writer thread would then save
        leaves, structure = _flatten(tree)
        host_tree = _unflatten(structure,
                               [_to_host(x, copy=True) for x in leaves])

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra=extra)
                self._gc()
            except BaseException as err:  # noqa: BLE001 — surfaced on wait()
                self._error = err
                self._error_step = step

        if self.async_write:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self._raise_pending()

    def restore_latest(self, like: Any):
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, extra = restore_checkpoint(self.directory, step, like)
        return step, tree, extra

    def load_latest_leaves(self):
        """The newest committed step's ``(step, leaves, manifest)``: the
        read of the graph-store snapshots, whose leaf shapes vary across
        epochs (no static ``like``)."""
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        leaves, manifest = load_leaves(self.directory, step)
        return step, leaves, manifest

    def _gc(self):
        steps = sorted(
            int(n[5:])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:09d}"),
                ignore_errors=True,
            )
