"""LARK-replicated serving session store (port of
``repro/serving/kv_session.py``).

Decode sessions (per-request recurrent states + generated prefixes) are
the paper's per-key replicated records: linearizable read/write per
session id, available across server failures under PAC.  A session
bounced to another server after a node loss resumes from its last
committed decode state via a per-key dup-res instead of a replay log.

The reference stores ``np.asarray`` of every state leaf; numpy has no
bfloat16, so the port stores CPU clones of the tensors instead, which
come back bit for bit in their own dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.checkpoint.lark_store import LarkStore
from repro_torch.tree import map_leaves


def to_host(state):
    """A copy of every tensor leaf on the CPU (never a view of the
    caller's storage)."""
    return map_leaves(lambda t: t.detach().to("cpu", copy=True), state)


class LarkSessionStore:
    def __init__(self, num_nodes: int = 4, rf: int = 2,
                 num_partitions: int = 32):
        self.store = LarkStore(num_nodes, rf=rf, num_partitions=num_partitions)

    def save_session(self, session_id: str, state, tokens: np.ndarray,
                     pos: int) -> bool:
        blob = {"state": to_host(state), "tokens": np.asarray(tokens),
                "pos": int(pos)}
        return self.store.put(f"session/{session_id}", blob)

    def load_session(self, session_id: str) -> Tuple[bool, Optional[dict]]:
        return self.store.get(f"session/{session_id}")

    def fail_server(self, node_id: int):
        self.store.fail_node(node_id)

    def recover_server(self, node_id: int):
        self.store.recover_node(node_id)
