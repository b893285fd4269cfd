"""Flash attention: causal GQA attention with a streaming softmax."""

from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    launch_counts,
    reset_launches,
)

__all__ = ["flash_attention", "launch_counts", "reset_launches"]
