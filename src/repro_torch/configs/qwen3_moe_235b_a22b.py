"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 (hf:Qwen/Qwen3-*).

94L d_model=4096 64H (GQA kv=4) d_ff=1536 (per expert) vocab=151936.
Qwen3 uses head_dim=128 (decoupled from d_model/num_heads) and q/k RMSNorm.
Full attention => long_500k skipped (see DESIGN.md §Arch-applicability).
Adafactor + 8 microbatches to fit 16 GB/chip for train_4k.
"""
from .base import ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    block_pattern=(ATTN,),
    qk_norm=True,
    rope_theta=1e6,
    mlp="swiglu",
    moe=MoEConfig(num_experts=128, experts_per_token=8, capacity_factor=1.25),
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp=True,
    microbatches_train=8,
    skip_shapes=("long_500k",),
)
