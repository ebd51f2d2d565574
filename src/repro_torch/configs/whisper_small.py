"""whisper-small [audio] — encoder-decoder, conv frontend stubbed (arXiv:2212.04356).

12L (x2: encoder+decoder) d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
The conv/mel frontend is a STUB: input_specs() provides precomputed frame
embeddings (B, 1500, d_model).  Assigned seq_len applies to the decoder
backbone.  LayerNorm + GELU + learned positions, per the paper.
Full attention decoder => long_500k skipped.
"""
from .base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="whisper_small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    block_pattern=(ATTN,),
    is_encoder_decoder=True,
    enc_layers=12,
    enc_seq=1500,
    embeds_input=True,          # encoder consumes stub frame embeddings
    norm="layernorm",
    mlp="gelu",
    rope_theta=0.0,             # learned absolute positions, no RoPE
    tie_embeddings=True,
    tensor_parallel=False,
    optimizer="adamw",
    microbatches_train=1,
    skip_shapes=("long_500k",),
)

REDUCED_OVERRIDES = dict(num_layers=2)
