"""Port of ``repro.models``: layers, attention (global, sliding-window,
local, cross and MLA), MoE, the mLSTM, sLSTM and RG-LRU blocks, the
per-layer decoder-only and encoder-decoder assemblies and their
converters from the reference's pytrees."""
from .model import (batch_prefix, batch_specs, build_model, decode_input,
                    make_batch)

__all__ = ["build_model", "batch_specs", "make_batch", "batch_prefix",
           "decode_input"]
