"""deepseek-v3-671b [moe]: 61L d=7168 128H d_ff(moe)=2048 vocab=129280,
MLA (q_lora 1536 / kv_lora 512 / nope 128 / rope 64 / v 128), 1 shared + 256
routed top-8 experts, aux-loss-free router bias, MTP [arXiv:2412.19437; hf].

First 3 layers use a dense 18432-hidden FFN (the published config); d_ff
below is the *dense-layer* hidden size, moe.d_expert the per-expert size.
Full attention -> long_500k skipped.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab=129280,
    first_k_dense=3,
    moe=MoEConfig(n_experts=256, top_k=8, n_shared=1, d_expert=2048,
                  router_aux_free_bias=True),
    mla_absorb=True,  # adopted: §Perf decode hillclimb (337x compute, 16x memory)
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
)
