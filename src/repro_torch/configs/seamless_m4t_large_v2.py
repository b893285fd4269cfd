"""seamless-m4t-large-v2 [audio]: enc-dec 24L d=1024 16H (kv=16) d_ff=8192
vocab=256206 [arXiv:2308.11596; hf].

The speech frontend (w2v-BERT conformer stack) is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings at d_model; both the
24-layer text decoder and a 24-layer encoder over those frames are real.
Full attention -> long_500k skipped (DESIGN.md §5).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=256206,
    frontend="audio",
    frontend_seq=1024,  # default frames; input_specs scales with seq
)
