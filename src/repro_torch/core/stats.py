"""Graph statistics for cost-based query planning, port of
``repro.core.stats``.

Three aggregates of the data graph, indexed by a label's position in the
sorted label universe:

* **label histogram** — data vertices per label (round-0 candidate-set
  size of a query vertex with that label);
* **per-label degree mass** — sum of degrees over the label's vertices;
* **label-pair edge counts** — directed edges from an l1-vertex to an
  l2-vertex (symmetric; same-label edges count twice), which over
  ``hist[l1] * hist[l2]`` is the join selectivity of a query edge.

An incremental index keeps them current by folding each applied batch
(``apply_records``: one count per record per direction).  ``version`` is
the store epoch of the last fold; ``bucket`` bumps only once the records
folded since the last bump pass ``rebucket_frac`` of the edge count, so
the plan cache keys on it rather than on the epoch.

The aggregates are integers and are built with ``np.bincount`` (never a
float weight), so they equal the reference's exactly.  They are small
((Lu,) and (Lu, Lu)) and stay on the host, where the planner reads them.
"""

from __future__ import annotations

import numpy as np

from repro_torch.checkpoint import CheckpointError
from repro_torch.graphs.csr import as_numpy


def alive_edge_blocks(store):
    """A store's alive edges as ``(lo, hi, lab)`` blocks: the store's
    ``iter_alive_edge_chunks`` when it has one (the out-of-core store, whose
    table stays on disk), else ``alive_edges()`` as one block."""
    chunks = getattr(store, "iter_alive_edge_chunks", None)
    return chunks() if chunks is not None else [store.alive_edges()]


def _pair_counts(col_a: np.ndarray, col_b: np.ndarray, lu: int) -> np.ndarray:
    """(Lu, Lu) int64 count of (col_a[i], col_b[i]) pairs."""
    flat = np.bincount(col_a * lu + col_b, minlength=lu * lu)
    return flat.astype(np.int64).reshape(lu, lu)


class GraphStats:
    """Aggregate label statistics of one data graph, cheap to maintain."""

    def __init__(self, universe, label_hist, deg_sum, pair_counts, *,
                 n_vertices: int, n_edges: int, version: int = 0,
                 rebucket_frac: float = 0.25):
        self.universe = np.asarray(universe)
        self.label_hist = np.asarray(label_hist, dtype=np.int64)
        self.deg_sum = np.asarray(deg_sum, dtype=np.int64)
        self.pair_counts = np.asarray(pair_counts, dtype=np.int64)
        self.n_vertices = int(n_vertices)
        self.n_edges = int(n_edges)
        self.version = int(version)
        self.rebucket_frac = float(rebucket_frac)
        self.bucket = 0
        self._drift = 0  # records folded since the last bucket bump

    # -- construction --------------------------------------------------------

    @classmethod
    def from_graph(cls, g, *, version: int = 0,
                   rebucket_frac: float = 0.25) -> "GraphStats":
        """O(V + E) scratch build from a ``Graph`` (tensors or arrays)."""
        vlab = as_numpy(g.vlabels)
        src = as_numpy(g.src).astype(np.int64)
        dst = as_numpy(g.dst).astype(np.int64)
        universe = np.unique(vlab)
        col = np.searchsorted(universe, vlab)
        lu = int(universe.size)
        hist = np.bincount(col, minlength=lu).astype(np.int64)
        # symmetrized edge list: the directed edges leaving a label's
        # vertices are that label's degree mass
        deg_sum = np.bincount(col[src], minlength=lu).astype(np.int64)
        pair = _pair_counts(col[src], col[dst], lu)
        return cls(universe, hist, deg_sum, pair, n_vertices=int(vlab.size),
                   n_edges=int(src.size) // 2, version=version,
                   rebucket_frac=rebucket_frac)

    @classmethod
    def from_store(cls, store, *, rebucket_frac: float = 0.25) -> "GraphStats":
        """Scratch build from a store's alive edge set, at its epoch,
        streamed block by block (``alive_edge_blocks``): an out-of-core
        store's edge table is never materialised, and the integer sums
        equal a one-shot build's."""
        vlab = np.asarray(store.vlabels)
        universe = np.unique(vlab)
        col = np.searchsorted(universe, vlab)
        lu = int(universe.size)
        hist = np.bincount(col, minlength=lu).astype(np.int64)
        pair = np.zeros((lu, lu), dtype=np.int64)
        deg_sum = np.zeros(lu, dtype=np.int64)
        n_edges = 0
        for lo, hi, _ in alive_edge_blocks(store):
            c_lo, c_hi = col[lo], col[hi]
            pair += _pair_counts(c_lo, c_hi, lu) + _pair_counts(c_hi, c_lo, lu)
            deg_sum += np.bincount(c_lo, minlength=lu)
            deg_sum += np.bincount(c_hi, minlength=lu)
            n_edges += int(lo.size)
        return cls(universe, hist, deg_sum, pair, n_vertices=int(vlab.size),
                   n_edges=n_edges, version=int(store.epoch),
                   rebucket_frac=rebucket_frac)

    def copy(self) -> "GraphStats":
        """Frozen-in-time copy (travels inside ``IndexSnapshot.stats``)."""
        out = GraphStats(
            self.universe, self.label_hist.copy(), self.deg_sum.copy(),
            self.pair_counts.copy(), n_vertices=self.n_vertices,
            n_edges=self.n_edges, version=self.version,
            rebucket_frac=self.rebucket_frac)
        out.bucket = self.bucket
        out._drift = self._drift
        return out

    # -- durable snapshots ---------------------------------------------------

    def checkpoint_state(self):
        """``(leaves, meta)`` of the exact state, the bucket generation and
        its drift counter included, so a restored planner sees the same
        plan-cache keys as the original."""
        leaves = {
            "universe": self.universe,
            "label_hist": self.label_hist,
            "deg_sum": self.deg_sum,
            "pair_counts": self.pair_counts,
        }
        meta = {
            "n_vertices": self.n_vertices,
            "n_edges": self.n_edges,
            "version": self.version,
            "rebucket_frac": self.rebucket_frac,
            "bucket": self.bucket,
            "drift": self._drift,
        }
        return leaves, meta

    @classmethod
    def from_checkpoint_state(cls, leaves, meta) -> "GraphStats":
        for k in ("universe", "label_hist", "deg_sum", "pair_counts"):
            if k not in leaves:
                raise CheckpointError(f"stats snapshot is missing leaf {k!r}")
        universe = np.asarray(leaves["universe"])
        lu = int(universe.size)
        pair = np.asarray(leaves["pair_counts"], dtype=np.int64)
        if pair.shape != (lu, lu):
            raise CheckpointError(
                f"stats snapshot pair_counts shape {pair.shape} disagrees "
                f"with universe size {lu}")
        out = cls(universe, leaves["label_hist"], leaves["deg_sum"], pair,
                  n_vertices=int(meta["n_vertices"]),
                  n_edges=int(meta["n_edges"]), version=int(meta["version"]),
                  rebucket_frac=float(meta["rebucket_frac"]))
        out.bucket = int(meta["bucket"])
        out._drift = int(meta["drift"])
        return out

    # -- incremental maintenance ---------------------------------------------

    def apply_records(self, col_lo: np.ndarray, col_hi: np.ndarray,
                      sign: np.ndarray, *, epoch: int) -> None:
        """Fold one applied batch: +1 (insert) or -1 (delete) per record per
        direction.  ``col_lo``/``col_hi`` are the endpoints' universe
        columns."""
        if col_lo.size:
            lu = int(self.universe.size)
            for s, keep in ((1, sign > 0), (-1, sign < 0)):
                a, b = col_lo[keep], col_hi[keep]
                self.pair_counts += s * (_pair_counts(a, b, lu)
                                         + _pair_counts(b, a, lu))
                self.deg_sum += s * np.bincount(
                    np.concatenate([a, b]), minlength=lu).astype(np.int64)
            self.n_edges += int(np.asarray(sign, dtype=np.int64).sum())
            self._drift += int(sign.size)
        self.version = int(epoch)
        if self._drift > self.rebucket_frac * max(1, self.n_edges):
            self.bucket += 1
            self._drift = 0

    # -- estimators (the planner's interface) --------------------------------

    def label_columns(self, labels):
        """Map raw labels onto universe columns: (cols, present mask)."""
        labels = np.asarray(labels)
        if self.universe.size == 0:
            return (np.zeros(labels.shape, np.int64),
                    np.zeros(labels.shape, bool))
        cols = np.clip(np.searchsorted(self.universe, labels), 0,
                       self.universe.size - 1)
        present = self.universe[cols] == labels
        return cols, present

    def query_view(self, labels):
        """``(hist_q (Lq,) float, prob_q (Lq, Lq) float)``: data vertices per
        query label, and the probability that a random ordered
        (labels[i], labels[j]) vertex pair is an edge.  Labels absent from
        the universe contribute zero everywhere."""
        cols, present = self.label_columns(labels)
        hist_q = np.where(present, self.label_hist[cols], 0).astype(np.float64)
        pair_q = self.pair_counts[np.ix_(cols, cols)].astype(np.float64)
        pair_q *= np.outer(present, present)
        denom = np.maximum(np.outer(hist_q, hist_q), 1.0)
        return hist_q, pair_q / denom

    def avg_degree(self, label) -> float:
        """Mean degree of the label class (0 for absent/empty labels)."""
        cols, present = self.label_columns(np.asarray([label]))
        if not present[0] or self.label_hist[cols[0]] == 0:
            return 0.0
        return float(self.deg_sum[cols[0]]) / float(self.label_hist[cols[0]])

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"GraphStats(V={self.n_vertices}, E={self.n_edges}, "
                f"L={self.universe.size}, version={self.version}, "
                f"bucket={self.bucket})")
