"""Serving front-ends of the port: the LM ``ServeEngine``.  The graph
query service is not ported yet (ROADMAP A8)."""

from repro_torch.serve.engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
