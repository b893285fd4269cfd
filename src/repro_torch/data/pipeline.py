"""Training data pipeline of the port (``repro.data.pipeline`` in torch).

Deterministic and checkpointable: the sampler cursor and seed live in
``DataState``, which a checkpoint stores, so a restart replays exactly.
``SyntheticLMDataset`` draws with numpy exactly as the reference does, so
a batch is bit-equal in both packages for the same (seed, step).

The CNI engine plugs in as a data operator (``GraphPatternFilter``):
documents carry small entity graphs, and only documents whose graph
contains an embedding of the query pattern pass.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.engine import SubgraphQueryEngine
from repro_torch.graphs.csr import Graph


@dataclasses.dataclass
class DataState:
    seed: int
    step: int

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class SyntheticLMDataset:
    """Deterministic synthetic token stream (zipf-ish unigram mix) with a
    stateless index -> batch map: ``batch_at(i)`` is pure in (seed, i).
    Batches are numpy int32 ``{"tokens", "labels"}`` of (B, S)."""

    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        # zipfian unigrams: realistic logit/loss scales without real text
        ranks = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        tokens = np.minimum(ranks - 1, self.vocab - 1).astype(np.int32)
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def iterate(self, state: DataState) -> Iterator[tuple[dict, DataState]]:
        step = state.step
        while True:
            yield self.batch_at(step), DataState(seed=state.seed, step=step + 1)
            step += 1


class GraphPatternFilter:
    """CNI-engine data operator: keep documents whose entity graph matches.

    ``docs`` are (tokens, Graph) pairs of the port's ``Graph``; each
    document graph runs the full ILGF -> join pipeline of
    ``SubgraphQueryEngine`` on ``device`` (None means CUDA; pass ``"cpu"``
    for the host).
    """

    def __init__(self, query: Graph, *, max_embeddings: int = 1, device=None):
        self.query = query
        self.max_embeddings = max_embeddings
        self.device = device

    def matches(self, doc_graph: Graph) -> bool:
        eng = SubgraphQueryEngine(doc_graph, device=self.device)
        emb, _ = eng.query(self.query, max_embeddings=self.max_embeddings)
        return emb.shape[0] > 0

    def filter(self, docs):
        for tokens, g in docs:
            if self.matches(g):
                yield tokens, g


def make_pipeline(vocab: int, seq_len: int, global_batch: int, *,
                  seed: int = 0, state: Optional[DataState] = None):
    ds = SyntheticLMDataset(vocab, seq_len, global_batch, seed)
    st = state or DataState(seed=seed, step=0)
    return ds, st
