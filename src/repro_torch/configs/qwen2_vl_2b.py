"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  The vision frontend
is a STUB: input_specs() provides fused precomputed token/patch embeddings
(B, S, d_model) plus (t,h,w) M-RoPE position ids (B, 3, S).  M-RoPE sections
(16,24,24) over the 64 half-dims of head_dim=128.
Full attention => long_500k skipped.
"""
from .base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2_vl_2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    block_pattern=(ATTN,),
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
    embeds_input=True,
    position_inputs=True,
    mlp="swiglu",
    tie_embeddings=True,
    tensor_parallel=False,
    optimizer="adamw",
    microbatches_train=4,
    skip_shapes=("long_500k",),
)

REDUCED_OVERRIDES = dict(mrope_sections=(2, 3, 3))  # sums to head_dim//2 = 8

