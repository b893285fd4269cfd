"""Embed-join expansion kernels: validity grid, count pass, emit pass."""

from repro_torch.kernels.embed_join.ops import (
    embed_join,
    embed_join_count,
    embed_join_emit,
    launch_counts,
    reset_launches,
)

__all__ = ["embed_join", "embed_join_count", "embed_join_emit",
           "launch_counts", "reset_launches"]
