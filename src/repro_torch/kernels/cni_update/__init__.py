"""CNI update kernel: frontier rows plus their deltas, re-encoded."""

from repro_torch.kernels.cni_update.ops import (
    cni_update,
    launch_counts,
    reset_launches,
)

__all__ = ["cni_update", "launch_counts", "reset_launches"]
