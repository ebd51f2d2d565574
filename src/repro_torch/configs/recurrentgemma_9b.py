"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 (arXiv:2402.19427).

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000.  Griffin layout:
two RG-LRU residual blocks per local-attention block (window 2048), each
temporal-mix block followed by a gated-GELU MLP.  38 = 12*3 + 2.
Sub-quadratic (bounded window + recurrent state) => long_500k runs.
"""
from .base import LOCAL_ATTN, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    local_window=2048,
    conv_width=4,
    lru_width=4096,
    mlp="gelu_glu",
    tie_embeddings=True,
    scale_embeddings=True,
    optimizer="adamw",
    microbatches_train=8,
    skip_shapes=(),
)
