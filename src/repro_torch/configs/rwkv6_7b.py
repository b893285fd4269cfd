"""rwkv6-7b [ssm]: 32L d=4096 (attn-free) d_ff=14336 vocab=65536 — "Finch",
data-dependent decay [arXiv:2404.05892; hf].  Sub-quadratic: O(1) decode
state -> long_500k runs; this is the pool's long-context representative."""

from repro_torch.models.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # d_model / head_dim; informational for sharding
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    sub_quadratic=True,
)
