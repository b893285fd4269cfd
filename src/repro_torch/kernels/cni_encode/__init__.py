"""CNI encode kernel: label degree, exact digest and log digest per row."""

from repro_torch.kernels.cni_encode.ops import (
    cni_encode,
    launch_counts,
    reset_launches,
)

__all__ = ["cni_encode", "launch_counts", "reset_launches"]
