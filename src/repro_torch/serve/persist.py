"""Durable service snapshots: store + CNI index + planner stats per epoch
(port of ``repro.serve.persist``, same layout and checks).

``ServiceCheckpointer`` joins the serving tier (``serve/graph_service.py``)
to the checkpoint substrate (``checkpoint/ckpt.py``): one checkpoint step
per saved store epoch, holding

* the store's logical state (``checkpoint_state()``: the alive canonical
  edges and the vertex labels of an in-memory store; the resident overlay
  and a ``(storage_root, generation)`` reference for the out-of-core
  store, whose chunk files are already durable), and
* the incremental index's maintained state (counts, degrees, exact and log
  digests) with the planner's ``GraphStats`` beside it, so a restore is
  warm: no rebuild and no ``cni_encode``, and the first admitted query
  prefilters against the digests the original service maintained.

Leaves are keyed ``store/...`` and ``index/...``; the sorted key list is
recorded in the manifest, and the checkpoint flattens a dict in sorted-key
order, so the mapping back is exact.  ``restore_latest`` also reads a
directory the reference wrote (same layout; its exact digest leaf is the
uint64 ``index/cni_u64``): the way state carries from the JAX package into
the port.

Every restore checks the leaves against the manifest and the parts'
metas against each other (``leaf_keys``, the store kind, the index type,
the index epoch against the store epoch, the out-of-core generation's
existence, the shard plan of a sharded index against its store's) and
raises ``CheckpointError`` on a disagreement.
"""

from __future__ import annotations

from repro_torch.checkpoint import CheckpointError, CheckpointManager
from repro_torch.core.incremental import (
    IncrementalIndex,
    ShardedIncrementalIndex,
)
from repro_torch.graphs.ooc import OutOfCoreGraphStore
from repro_torch.graphs.store import GraphStore, ShardedGraphStore

SCHEMA_VERSION = 1

# the store kinds and index types a snapshot may name
_STORES = {"graph": GraphStore, "sharded": ShardedGraphStore,
           "ooc": OutOfCoreGraphStore}
_INDEXES = {"IncrementalIndex": IncrementalIndex,
            "ShardedIncrementalIndex": ShardedIncrementalIndex}


class ServiceCheckpointer:
    """Keep-last-k durable snapshots of one store (and its index).

    ``save`` is asynchronous by default (the writer thread persists while
    the service keeps ticking); a failed write re-raises as
    ``CheckpointError`` on ``wait()`` or the next ``save()``.
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.manager = CheckpointManager(directory, keep=keep,
                                         async_write=async_write)

    # -- write side ----------------------------------------------------------

    def save(self, store) -> int:
        """Snapshot the store (and index) at its current epoch; returns the
        step, which is the epoch.  Re-saving an epoch is idempotent."""
        leaves: dict = {}
        meta: dict = {"schema": SCHEMA_VERSION}
        s_leaves, s_meta = store.checkpoint_state()
        leaves.update({f"store/{k}": v for k, v in s_leaves.items()})
        meta["store"] = s_meta
        if store.index is not None:
            i_leaves, i_meta = store.index.checkpoint_state()
            leaves.update({f"index/{k}": v for k, v in i_leaves.items()})
            meta["index"] = i_meta
        else:
            meta["index"] = None
        meta["leaf_keys"] = sorted(leaves)
        step = int(store.epoch)
        self.manager.save(step, leaves, extra=meta)
        return step

    def wait(self) -> None:
        """Block until the in-flight async write commits (re-raises its
        failure, if any)."""
        self.manager.wait()

    # -- read side -----------------------------------------------------------

    def restore_latest(self, *, storage_dir: str | None = None, device=None):
        """``(step, store)`` rebuilt from the newest committed snapshot, the
        store and its index on ``device`` (``None`` means ``"cuda"``);
        ``(None, None)`` when the directory holds no committed step.
        ``storage_dir`` overrides an out-of-core snapshot's recorded
        chunk-directory root."""
        step, leaf_list, manifest = self.manager.load_latest_leaves()
        if step is None:
            return None, None
        meta = manifest["extra"]
        keys = meta.get("leaf_keys")
        if not isinstance(keys, list) or len(keys) != len(leaf_list):
            raise CheckpointError(
                f"service snapshot step {step}: leaf_keys "
                f"({'missing' if keys is None else len(keys)}) disagrees "
                f"with {len(leaf_list)} stored leaves")
        leaves = dict(zip(keys, leaf_list))
        store_meta = meta.get("store")
        if not isinstance(store_meta, dict) or "kind" not in store_meta:
            raise CheckpointError(
                f"service snapshot step {step} has no store meta")
        kind = store_meta["kind"]
        cls = _STORES.get(kind)
        if cls is None:
            raise CheckpointError(
                f"service snapshot has unknown store kind {kind!r}")
        extra = {"storage_dir": storage_dir} if kind == "ooc" else {}
        store = cls.from_checkpoint_state(_part(leaves, "store/"),
                                          store_meta, device=device, **extra)
        idx_meta = meta.get("index")
        if idx_meta is not None:
            icls = _INDEXES.get(idx_meta.get("type"))
            if icls is None:
                raise CheckpointError(
                    f"service snapshot has unknown index type "
                    f"{idx_meta.get('type')!r}")
            idx = icls.from_checkpoint_state(
                _part(leaves, "index/"), idx_meta, store=store)
            try:
                store.attach_index(idx, rebuild=False)
            except ValueError as err:  # epoch disagreement: torn snapshot
                raise CheckpointError(str(err)) from err
        elif kind == "ooc":
            # the out-of-core query path needs resident digests: a store
            # saved without an index gets a fresh one (a cold rebuild)
            store.attach_index(IncrementalIndex())
        return int(step), store


def _part(leaves: dict, prefix: str) -> dict:
    """The leaves under ``prefix``, keyed without it."""
    return {k[len(prefix):]: v for k, v in leaves.items()
            if k.startswith(prefix)}
