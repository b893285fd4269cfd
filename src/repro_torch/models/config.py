"""Model configuration for the ten architectures (a copy of the reference's).

One frozen dataclass covers every family (dense / GQA / MLA / MoE / hybrid
attn+SSM / RWKV / enc-dec / VLM-stub / audio-stub); configs/<arch>.py
instantiate the exact published numbers, and ``reduced()`` derives the CPU
smoke-test variant of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

Family = Literal["dense", "moe", "hybrid", "rwkv", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0
    d_expert: int = 0            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    router_aux_free_bias: bool = True  # DeepSeek-V3 aux-loss-free balancing
    # GShard grouping: capacity is per (group × expert), so the dispatch
    # one-hot is (G, Tg, E, C) with C = Tg·cf·k/E — total bytes linear in Tg.
    # Small groups keep dispatch ~10MB/device at 1M tokens (DESIGN.md §6).
    group_size: int = 512
    # dispatch plan: 'einsum' = GShard one-hot matmuls (baseline);
    # 'gather' = scatter/gather slot plan — the (G,Tg,E,C) one-hot never
    # materializes (indices only), a large memory-term win (§Perf).
    dispatch: str = "einsum"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0   # 0 -> d_model // 16


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    first_k_dense: int = 0               # leading dense layers in MoE stacks
    n_encoder_layers: int = 0            # enc-dec only
    frontend: Literal["none", "audio", "vision"] = "none"
    frontend_seq: int = 0                # stub frames/patches prepended
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    window: Optional[int] = None         # sliding-window attention
    mtp: bool = False                    # DeepSeek multi-token prediction
    max_seq: int = 131_072
    sub_quadratic: bool = False          # supports long_500k decode
    remat: Literal["none", "full", "dots"] = "full"
    # attention (and RWKV WKV) math: 'auto' and 'kernel' launch the CUDA
    # kernel on a CUDA tensor and run its plain version on a CPU tensor;
    # 'ref' runs the plain version anywhere; 'xla_flash' runs the
    # reference's blocked online softmax in plain torch on any device
    attn_impl: Literal["auto", "kernel", "xla_flash", "ref"] = "auto"
    # the reference's layer-scan unrolling (a dry-run cost option); kept as
    # data so configs compare field for field, read nowhere in the port
    unroll_scan: bool = False
    # MLA decode weight absorption (DeepSeek-V2 §2.1.2): score/value maths
    # stay in the kv_lora latent space, so the cached latents are never
    # re-expanded to per-head K/V — O(S·r) instead of O(S·H·d_head) per step.
    mla_absorb: bool = False
    # chunked cross-entropy: stream the unembed over vocab chunks (flash-
    # style running logsumexp) so the (B,S,V) logits tensor never
    # materializes; 0 = off.  Exact same loss (tested).
    ce_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def active_params_per_token(self) -> int:
        """~N_active for MODEL_FLOPS accounting (6·N·D)."""
        d, L = self.d_model, self.n_layers
        emb = 2 * self.vocab * d if not self.tie_embeddings else self.vocab * d
        if self.family == "rwkv":
            per_layer = 4 * d * d + 2 * d * self.d_ff + 3 * d * d // 2
        else:
            hd = self.head_dim
            if self.mla is not None:
                m = self.mla
                attn = (
                    d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            else:
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            if self.moe is not None:
                ff = 3 * d * self.moe.d_expert * (self.moe.top_k + self.moe.n_shared)
            else:
                ff = 3 * d * self.d_ff
            per_layer = attn + ff
            if self.family == "hybrid" and self.ssm is not None:
                per_layer += 2 * d * d * self.ssm.expand  # mamba branch approx
        return emb + L * per_layer

    @property
    def total_params(self) -> int:
        d, L = self.d_model, self.n_layers
        emb = 2 * self.vocab * d if not self.tie_embeddings else self.vocab * d
        if self.moe is not None:
            hd = self.head_dim
            if self.mla is not None:
                m = self.mla
                attn = (
                    d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            else:
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            ff = 3 * d * self.moe.d_expert * (self.moe.n_experts + self.moe.n_shared)
            return emb + L * (attn + ff)
        return self.active_params_per_token

    def reduced(self) -> "ModelConfig":
        """Same family, CPU-smoke-test size."""
        kw: dict = dict(
            name=self.name + "-reduced",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_head=16,
            d_ff=128,
            vocab=256,
            first_k_dense=min(self.first_k_dense, 1),
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            frontend_seq=8 if self.frontend != "none" else 0,
            max_seq=256,
            remat="none",
            attn_impl="ref",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                n_experts=4, top_k=2,
                n_shared=min(self.moe.n_shared, 1),
                d_expert=32,
                capacity_factor=8.0,  # dropless at smoke-test scale
                router_aux_free_bias=self.moe.router_aux_free_bias,
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=32, kv_lora_rank=16,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            )
            kw["d_head"] = 0
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_dim=8, conv_width=4, expand=2)
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8)
        return dataclasses.replace(self, **kw)
