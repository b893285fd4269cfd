"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attn+mamba heads [arXiv:2411.13676; hf].

Hymba fuses a sliding-window-attention branch and a Mamba branch in every
layer (outputs mean-combined); the published model keeps 3 full-attention
layers and meta-tokens — we model the uniform SWA+mamba layer (DESIGN.md §5).
Sub-quadratic: the SSM branch + windowed attention give O(1)-per-token decode
state, so long_500k runs.
"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    window=1024,
    sub_quadratic=True,
    tie_embeddings=True,
)
