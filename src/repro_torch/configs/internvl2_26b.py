"""internvl2-26b [vlm]: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553,
InternViT frontend + InternLM2 backbone [arXiv:2404.16821; hf].

The InternViT-6B tower is a STUB: ``input_specs()`` supplies 256 pixel-
shuffled patch embeddings at d_model, prepended to the text sequence; the
48-layer InternLM2-20B-style backbone is real."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    frontend="vision",
    frontend_seq=256,
)
