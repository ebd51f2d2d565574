"""Analytical availability model — paper Appendix C.

u = per-node unavailability; with per-tick failure probability p and fixed
downtime r ticks, u = p*r / (1 + p*r) (alternating renewal).

  Pr[unavail_LARK] ~ u^{f+1}                      (eq. 2)
  Pr[unavail_Raft] ~ C(2f+1, f+1) u^{f+1}         (eq. 3, leading term)
  improvement      ~ C(2f+1, f+1)  = 3, 10, 35 for f = 1, 2, 3   (eq. 4)
"""
from __future__ import annotations

import math


def node_unavailability(p: float, r: int = 10) -> float:
    return p * r / (1.0 + p * r)


def lark_unavailability(u: float, f: int) -> float:
    return u ** (f + 1)


def raft_unavailability(u: float, f: int, exact: bool = False) -> float:
    n = 2 * f + 1
    if not exact:
        return math.comb(n, f + 1) * u ** (f + 1)
    return sum(math.comb(n, k) * u ** k * (1 - u) ** (n - k)
               for k in range(f + 1, n + 1))


def improvement_factor(f: int) -> int:
    return math.comb(2 * f + 1, f + 1)
