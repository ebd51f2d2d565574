"""smollm-360m [dense] — llama-arch small (hf:HuggingFaceTB/SmolLM-360M).

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.  Full attention
=> long_500k skipped.
"""
from .base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="smollm_360m",
    family="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    block_pattern=(ATTN,),
    mlp="swiglu",
    tie_embeddings=True,
    tensor_parallel=False,
    optimizer="adamw",
    microbatches_train=1,
    skip_shapes=("long_500k",),
)
