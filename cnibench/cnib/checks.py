"""The comparison that decides ``correct``: every query that the timed path
completed in the window is answered again by the plain reference, and its
embedding set must equal the reference's, whole (rows sorted, duplicates
kept, no cap)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Check(NamedTuple):
    name: str
    value: int
    op: str      # "<=" or ">="
    limit: int

    @property
    def ok(self) -> bool:
        return self.value <= self.limit if self.op == "<=" else self.value >= self.limit

    def as_json(self) -> dict:
        return {"value": self.value, "op": self.op, "limit": self.limit}


def contains_row(rows: np.ndarray, row: np.ndarray) -> bool:
    return bool(rows.shape[0]) and bool((rows == row[None, :]).all(1).any())


def compare(answers, pool, reference, index, *, failed: int) -> list[Check]:
    """``answers``: (pool index, embeddings) of each completed query.

    ``wrong``: answers whose sorted rows differ from the reference's;
    ``failed``: queries that raised or were rejected; ``planted_missing``:
    reference answers that lack the query's own walk (a fault of the
    generator or the reference); ``compared``: answers compared."""
    wrong = planted_missing = 0
    cache: dict[int, np.ndarray] = {}
    for i, emb in answers:
        q = pool[i]
        if i not in cache:
            cache[i] = reference.embeddings(index, q.vlabels, q.edges, q.elabels)
        want = cache[i]
        got = reference.sort_rows(np.asarray(emb, dtype=np.int64).reshape(
            -1, len(q.vlabels)))
        if got.shape != want.shape or not np.array_equal(got, want):
            wrong += 1
        if not contains_row(want, q.planted):
            planted_missing += 1
    return [Check("wrong", wrong, "<=", 0), Check("failed", failed, "<=", 0),
            Check("planted_missing", planted_missing, "<=", 0),
            Check("compared", len(answers), ">=", 1)]
