"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) moe d_ff=768
vocab=151936, 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=6144,  # unused (no dense layers); kept for reduced variant
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, n_shared=0, d_expert=768,
                  router_aux_free_bias=False),
)
