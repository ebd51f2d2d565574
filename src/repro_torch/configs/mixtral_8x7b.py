"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention (arXiv:2401.04088).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, SWA window 4096.
SWA bounds the KV cache => long_500k runs with a ring cache.
"""
from .base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral_8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=(ATTN,),
    window=4096,
    rope_theta=1e6,
    mlp="swiglu",
    moe=MoEConfig(num_experts=8, experts_per_token=2, capacity_factor=1.25),
    tie_embeddings=False,
    optimizer="adamw",
    microbatches_train=16,
    skip_shapes=(),
)
