"""minicpm3-4b [dense-MLA]: 62L d=2560 40H d_ff=6400 vocab=73448, MLA
(q_lora 768 / kv_lora 256 / nope 64 / rope 32 / v 64)
[hf:openbmb/MiniCPM3-4B; hf]."""

from repro_torch.models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    mla_absorb=True,  # adopted: §Perf decode hillclimb (337x compute, 16x memory)
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
)
