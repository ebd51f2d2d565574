"""Port of ``repro.optim``: AdamW, Adafactor, the warmup-cosine schedule
and global-norm clipping over the port's parameter trees."""
from .optimizer import (adafactor, adamw, clip_by_global_norm,
                        make_optimizer, warmup_cosine)

__all__ = ["adamw", "adafactor", "make_optimizer", "warmup_cosine",
           "clip_by_global_norm"]
