"""Port of ``repro.serving``: the serve loop and the LARK session store."""
from .kv_session import LarkSessionStore
from .serve_loop import ServeLoop

__all__ = ["LarkSessionStore", "ServeLoop"]
