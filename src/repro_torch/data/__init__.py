"""Port of ``repro.data``: the deterministic synthetic token stream
(numpy only, copied from the reference)."""
from .pipeline import SyntheticLMData

__all__ = ["SyntheticLMData"]
