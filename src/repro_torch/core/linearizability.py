"""Per-key register linearizability checking (Wing & Gong style search);
port of ``repro/core/linearizability.py``, copied verbatim.

Writes carry unique values (the tests guarantee this).  Ops that FAILED at
the client or never completed are *optional*: under LARK a client-visible
write failure may still take effect later (a replica that accepted the
version can win a future dup-res), so failed/indeterminate writes may
linearize anywhere within their interval or be dropped; reads without a
response impose no constraint and are excluded.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

INF = math.inf


@dataclass(frozen=True)
class Op:
    op_id: int
    kind: str            # "write" | "read"
    value: Any           # written value / returned value
    inv: float
    resp: float          # INF if no response observed
    mandatory: bool      # must appear to take effect (successful ops)


def history_to_ops(history, key: str) -> List[Op]:
    """Convert simulator HistEvents into checker Ops for one key."""
    inv: Dict[int, Tuple[float, str, Any]] = {}
    out: List[Op] = []
    for e in history:
        if e.key != key or e.op_id < 0:
            continue  # op_id -1 = no-leader client error: provably no effect
        if e.kind == "invoke":
            inv[e.op_id] = (e.time, e.op_kind, e.value)
        else:
            t0, kind, wval = inv.get(e.op_id, (0.0, e.op_kind, e.value))
            if e.kind == "ok":
                val = wval if kind == "write" else e.value
                out.append(Op(e.op_id, kind, val, t0, e.time, True))
            elif kind == "write":  # fail / indeterminate write: optional
                out.append(Op(e.op_id, kind, wval, t0,
                              e.time if e.kind == "fail" else INF, False))
            # failed/indeterminate reads impose no constraint
    return out


def check_linearizable(ops: Sequence[Op], initial: Any = None) -> bool:
    ops = list(ops)
    n = len(ops)
    if n == 0:
        return True
    if n > 17:
        raise ValueError("history too large for exhaustive checking")

    resp = [o.resp for o in ops]
    inv = [o.inv for o in ops]
    full = (1 << n) - 1
    seen = set()

    def search(done_mask: int, last: Any) -> bool:
        if done_mask == full:
            return True
        state = (done_mask, last)
        if state in seen:
            return False
        seen.add(state)
        # candidates: undone ops invoked before every undone op's response
        min_resp = min(resp[i] for i in range(n) if not done_mask >> i & 1)
        for i in range(n):
            if done_mask >> i & 1:
                continue
            if inv[i] > min_resp:
                continue
            o = ops[i]
            if o.kind == "write":
                if search(done_mask | 1 << i, o.value):
                    return True
                if not o.mandatory:     # optional write may take no effect
                    if search(done_mask | 1 << i, last):
                        return True
            else:  # read
                if o.value == last and search(done_mask | 1 << i, last):
                    return True
        return False

    return search(0, initial)


def check_history(history, keys: Optional[Sequence[str]] = None,
                  initial: Any = None) -> Dict[str, bool]:
    if keys is None:
        keys = sorted({e.key for e in history})
    return {k: check_linearizable(history_to_ops(history, k), initial)
            for k in keys}
