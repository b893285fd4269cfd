"""Candidate-filter kernel: the fused cniMatch grid, exact and log modes."""

from repro_torch.kernels.candidate_filter.ops import (
    candidate_filter,
    launch_counts,
    reset_launches,
)

__all__ = ["candidate_filter", "launch_counts", "reset_launches"]
