"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

24L d_model=1024 4H (kv=4) d_ff=0 vocab=50304.  xLSTM[7:1]: one sLSTM block
per 7 mLSTM blocks (period-8 pattern, 24 = 3 x 8).  d_ff=0: the blocks carry
their own up/down projections (post-up-projection layout), no separate FFN.
Sub-quadratic: O(1) recurrent state => long_500k runs.
"""
from .base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm_350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=1024 // 4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(MLSTM,) * 7 + (SLSTM,),
    proj_factor=2.0,
    conv_width=4,
    mlp="none",
    tie_embeddings=True,
    tensor_parallel=False,
    optimizer="adamw",
    microbatches_train=1,
    skip_shapes=(),
)

REDUCED_OVERRIDES = dict(num_layers=8, head_dim=16)
