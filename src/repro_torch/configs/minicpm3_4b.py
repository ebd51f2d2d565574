"""minicpm3-4b [dense] — Multi-head Latent Attention (hf:openbmb/MiniCPM3-4B).

62L d_model=2560 40H d_ff=6400 vocab=73448.  MLA: q_lora 768, kv_lora 256,
qk_nope 64, qk_rope 32, v_head 64 (the "kv=40" in the assignment reflects
that MLA has no GQA grouping - every head reads the shared latent).
Full attention => long_500k skipped.
"""
from .base import ATTN, MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3_4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    block_pattern=(ATTN,),
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    mlp="swiglu",
    tie_embeddings=True,
    optimizer="adamw",
    microbatches_train=8,
    skip_shapes=("long_500k",),
)
