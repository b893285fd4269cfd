"""Erdos-Renyi G(n, m) with uniform vertex labels, made on the device.

A configuration names this generator with ``"generator": "gnm"`` and gives
``n_vertices``, ``n_edges`` (undirected) and ``n_labels``.  The graph keeps
the invariants of the port's ``Graph`` (``graphs/csr.py::symmetrize``): no
self loops, each undirected edge once, both directions present, the
directed edges sorted by ``src`` (and by ``dst`` within a source), int32
labels, int64 endpoints, one edge label (0).

Everything is drawn with one ``torch.Generator`` on ``device`` in a few
large calls, so a seed gives the same graph on every run on one kind of
card.  Exactly ``n_edges`` distinct edges come out: pairs are drawn with a
small surplus, deduplicated by their key ``lo * n + hi``, and the surplus
is dropped at random.
"""

from __future__ import annotations

import torch


def make_graph(spec: dict, seed: int, device) -> dict:
    """The graph as a dict of tensors on ``device``: ``vlabels`` (V,)
    int32, ``src``/``dst`` (2E,) int64, ``elabels`` (2E,) int32."""
    n = int(spec["n_vertices"])
    m = int(spec["n_edges"])
    if m > n * (n - 1) // 2:
        raise ValueError(f"G({n}, {m}) has more edges than vertex pairs")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    vlabels = torch.randint(0, int(spec["n_labels"]), (n,), generator=gen,
                            device=device, dtype=torch.int32)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw = m + m // 1000 + 1024
    while keys.numel() < m:
        a = torch.randint(0, n, (draw,), generator=gen, device=device)
        b = torch.randint(0, n, (draw,), generator=gen, device=device)
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        del a, b
        fresh = (lo * n + hi)[lo != hi]
        del lo, hi
        keys = torch.unique(torch.cat([keys, fresh]))  # sorted, distinct
        del fresh
        draw = 2 * (m - keys.numel()) + 1024
    if keys.numel() > m:
        drop = torch.randperm(keys.numel(), generator=gen,
                              device=device)[: keys.numel() - m]
        keep = torch.ones(keys.numel(), dtype=torch.bool, device=device)
        keep[drop] = False
        keys = keys[keep]
        del drop, keep
    lo, hi = keys // n, keys % n
    del keys
    src = torch.cat([lo, hi])
    dst = torch.cat([hi, lo])
    del lo, hi
    order = torch.argsort(src * n + dst)
    return {"vlabels": vlabels, "src": src[order], "dst": dst[order],
            "elabels": torch.zeros(src.numel(), dtype=torch.int32, device=device)}
