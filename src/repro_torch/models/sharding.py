"""Logical-axis sharding of the LM substrate (port of
``repro.models.sharding``): the rules that map a tensor's logical axes onto
the axes of a device mesh.

Tensors are described by *logical* axis names; ``resolve_spec`` maps them
to mesh axes with the reference's divisibility fallback (an axis that does
not divide evenly is replicated: hymba's 25 query heads or granite's
49,155-row vocab replicate on a 16-way model axis rather than fail).

    batch   -> ("pod", "data")     data parallel
    fsdp    -> "data"              weight sharding (ZeRO-3), >= 8e9 params
    heads   -> "model"             tensor-parallel attention
    kv_heads-> "model"             (replicated when kv_heads < tp)
    ff      -> "model"             tensor-parallel MLP hidden
    vocab   -> "model"             vocab-parallel embedding and logits
    experts -> "model"             expert parallel (MoE all-to-all)
    kv_seq  -> "model"             sequence-split KV cache at decode

A mesh is a plain ``{axis: size}`` dict (or anything with such a ``shape``
mapping) or a ``ShardMesh`` (one axis, ``n_shards`` wide).  A resolved spec
is a tuple with one entry per dim, an axis name, a tuple of names or None,
trailing Nones dropped: the reference's ``PartitionSpec`` as a tuple.  The
port has no SPMD partitioner, so ``shard`` returns its tensor unchanged, as
the reference's does without a mesh; the plans of ``launch/dryrun.py`` read
the resolved specs instead (``shard_shape``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "embed": None,
    # the KV/latent cache's sequence splits over the model axis: the batch
    # takes the data axis, and at decode the model axis is otherwise idle
    # for most configs (kv_heads < 16)
    "kv_seq": "model",
    "seq": None,
    "qk": None,
    "state": None,
}


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a dict, a ``ShardMesh`` or an object with a
    ``shape`` mapping (the reference's ``Mesh`` and its test stub)."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    if hasattr(mesh, "n_shards"):
        return {mesh.axis: mesh.n_shards}
    return dict(mesh.shape)


def is_spec(s) -> bool:
    """A logical spec: a tuple of axis names and Nones."""
    return isinstance(s, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in s)


@dataclasses.dataclass
class ShardingPolicy:
    """Resolves logical axes against a mesh shape."""

    mesh: Any = None
    rules: dict[str, Any] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    enable_fsdp: bool = False

    def mesh_axes(self, logical: str):
        ax = self.rules.get(logical)
        if logical == "fsdp" and not self.enable_fsdp:
            return None
        return ax

    def resolve_spec(self, shape: tuple[int, ...], logical_axes) -> tuple:
        """Logical names -> a spec tuple, with divisibility fallback."""
        if self.mesh is None:
            return ()
        sizes = mesh_shape(self.mesh)
        entries = []
        used: set[str] = set()
        for dim, name in zip(shape, logical_axes):
            ax = self.mesh_axes(name) if name else None
            if ax is None:
                entries.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            axes = tuple(a for a in axes if a in sizes and a not in used)
            size = math.prod(sizes[a] for a in axes)
            if size > 1 and dim % size == 0:
                entries.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
            else:
                entries.append(None)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one entry of a resolved spec."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shard_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The per-device shape of a ``shape`` tensor sharded by a resolved
    ``spec`` on ``mesh``."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        out[i] //= math.prod(sizes[a] for a in spec_axes(entry))
    return tuple(out)


_ACTIVE: list[ShardingPolicy] = []


class use_policy:
    """Context manager installing the active sharding policy."""

    def __init__(self, policy: ShardingPolicy):
        self.policy = policy

    def __enter__(self):
        _ACTIVE.append(self.policy)
        return self.policy

    def __exit__(self, *exc):
        _ACTIVE.pop()


def current_policy() -> ShardingPolicy:
    return _ACTIVE[-1] if _ACTIVE else ShardingPolicy(mesh=None)


def shard(x, *logical_axes):
    """``x`` unchanged: the port has no SPMD partitioner to constrain (the
    reference's ``shard`` is also the identity without a mesh)."""
    return x


def resolve_tree(specs, policy: ShardingPolicy, shapes):
    """Map a logical-spec tree and a shape tree (the same nesting of dicts,
    tuples and lists; a shape leaf is a tensor or a tuple of ints) to a tree
    of resolved spec tuples."""
    if is_spec(specs):
        shape = shapes if isinstance(shapes, tuple) and all(
            isinstance(n, int) for n in shapes) else tuple(shapes.shape)
        return policy.resolve_spec(shape, specs)
    if isinstance(specs, dict):
        return {k: resolve_tree(specs[k], policy, shapes[k]) for k in specs}
    return type(specs)(resolve_tree(s, policy, x)
                       for s, x in zip(specs, shapes))
