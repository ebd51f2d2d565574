"""Port of ``repro.checkpoint``: the LARK-replicated KV store, the
quorum-log baseline store and the on-disk tier."""
from .lark_store import LarkStore
from .baseline_store import QuorumLogStore
from .disk import load_pytree, save_pytree, AsyncCheckpointer

__all__ = ["LarkStore", "QuorumLogStore", "save_pytree", "load_pytree",
           "AsyncCheckpointer"]
