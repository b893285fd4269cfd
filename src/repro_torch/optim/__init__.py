"""The port's optimizer: AdamW (full or factored second moment), gradient
clipping and int8 compression, LR schedules; all over dicts of tensors
keyed like the params."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_state_specs,
    adamw_update,
    make_optimizer,
)
from repro_torch.optim.grad_utils import (
    clip_by_global_norm,
    compress_int8,
    decompress_int8,
    global_norm,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_state_specs",
    "adamw_update",
    "make_optimizer",
    "clip_by_global_norm",
    "global_norm",
    "compress_int8",
    "decompress_int8",
    "cosine_schedule",
    "linear_warmup_cosine",
]
