"""PyTorch/CUDA port of the CNI subgraph-query engine.

The layout mirrors the JAX package ``repro``: ``graphs`` (edge-list graphs,
generators, dataset stand-ins), ``core`` (label maps, CNI digests, filters,
ILGF, k-hop refinement, search, engine), ``obsv`` (enumeration reports and
spans) and ``kernels`` (hand-written Hopper kernels beside their plain
PyTorch versions).

Entry points take ``device=None``, which means ``"cuda"``: they raise when no
CUDA device is present, and run on the CPU only when the caller passes
``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
