"""Port of ``repro.models`` for the xLSTM and recurrentgemma serve paths:
layers, the mLSTM, sLSTM and RG-LRU blocks, local attention, the
per-layer model assembly and its converters from the reference's
pytrees."""
from .model import batch_specs, build_model, make_batch

__all__ = ["build_model", "batch_specs", "make_batch"]
