"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP (arXiv:2402.16819).

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.  ~340B params:
Adafactor + 16 microbatches + remat so train_4k fits 16 GB/chip on 256 chips.
Full attention => long_500k skipped.
"""
from .base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="nemotron_4_340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256_000,
    block_pattern=(ATTN,),
    mlp="relu2",
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp=True,
    microbatches_train=32,
    skip_shapes=("long_500k",),
)
