"""PyTorch/CUDA port of the CNI subgraph-query engine.

The layout mirrors the JAX package ``repro``: ``graphs`` (edge-list graphs,
generators, dataset stand-ins, the mutable store), ``core`` (label maps, CNI
digests, filters, ILGF, k-hop refinement, search, engines, incremental
index, planner), ``obsv`` (reports and spans), ``kernels`` (hand-written
Hopper kernels beside their plain PyTorch versions), ``configs`` (engine
presets and the ten model architectures), ``models`` (the LM substrate's
dense GQA, MLA, MoE and RWKV-6 families), ``serve`` (the LM
``ServeEngine``), ``train`` (its ``Trainer``) and ``launch`` (their
command-line launchers).

Entry points take ``device=None``, which means ``"cuda"``: they raise when no
CUDA device is present, and run on the CPU only when the caller passes
``device="cpu"``.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
