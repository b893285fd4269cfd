"""RWKV-6 WKV: the data-dependent-decay recurrence with its state, and its
VJP."""

from repro_torch.kernels.rwkv6_wkv.ops import (
    launch_counts,
    reset_launches,
    wkv6,
    wkv6_backward,
)

__all__ = ["launch_counts", "reset_launches", "wkv6", "wkv6_backward"]
