"""internlm2-20b [dense] — GQA llama-style (arXiv:2403.17297).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.  Full attention
=> long_500k skipped.
"""
from .base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="internlm2_20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    block_pattern=(ATTN,),
    rope_theta=1e6,
    mlp="swiglu",
    tie_embeddings=False,
    optimizer="adamw",
    microbatches_train=16,
    skip_shapes=("long_500k",),
)
