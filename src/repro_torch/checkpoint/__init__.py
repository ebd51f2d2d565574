"""Port of ``repro.checkpoint``: the LARK-replicated KV store."""
from .lark_store import LarkStore

__all__ = ["LarkStore"]
