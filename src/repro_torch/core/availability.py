"""Port of ``repro/core/availability.py`` — only the Student-t table the
batched engine's confidence intervals read.  The scalar event engine is
still to be ported (ROADMAP Queue 1 item 11)."""
from __future__ import annotations

#: two-sided 97.5% Student-t quantiles by degrees of freedom (CI helpers)
T975 = {1: 12.706, 2: 4.303, 3: 3.182, 4: 2.776, 5: 2.571, 6: 2.447,
        7: 2.365, 8: 2.306, 9: 2.262, 10: 2.228, 11: 2.201, 12: 2.179,
        13: 2.160, 14: 2.145, 15: 2.131, 20: 2.086, 30: 2.042}


def t975(dof: int) -> float:
    if dof in T975:
        return T975[dof]
    keys = sorted(T975)
    for k in reversed(keys):
        if dof >= k:
            return T975[k]
    return T975[keys[0]]
