"""Cluster-scale availability Monte Carlo — paper §5.1 (port of
``repro/core/availability.py``, host code copied verbatim: numpy's
``default_rng``, ``heapq`` and the numpy PAC of ``kernels/pac_np.py``; no
device is involved).  The batched engine's confidence intervals read
``t975`` from here.

Event-driven engine with per-tick Bernoulli failure semantics (sampled as
geometric inter-failure gaps — statistically identical, so availability only
needs recomputing at failure/recovery events; between events the unavailable
partition count is constant and accumulates as count x Delta_t).

Model (exactly the paper's):
  * n nodes, P partitions, replication factor RF; i.i.d. failure prob p per
    up-node per tick; fixed downtime r ticks.
  * LARK availability = PAC SimpleMajority only (a lower bound, per §5.1.1):
    database majority up AND >=1 roster replica up AND >=1 latest-copy holder
    up.  Latest-copy holders ("full", data-level): whenever the partition is
    available, holders := the current cluster replicas (migration modeled as
    instantaneous, consistent with Appendix C's leading-order analysis);
    while unavailable the holder set is frozen (no writes can commit).
  * Baseline = majority of the fixed 2f+1 replica-set (first 2f+1 succession
    nodes) reachable.
  * Early stop: checked every `check_every` ticks once >=200 unavailable
    events observed and the 95% CI half-width <= max(eps_abs, eps_rel * U).
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..kernels.pac_np import pac_eval_rank_np
from .succession import succession_matrix_fast


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


def _accumulate_buckets(bl: np.ndarray, bm: np.ndarray, t0: int, t1: int,
                        unl: int, unm: int, bw: int) -> None:
    """Spread a constant-unavailability segment [t0, t1) over time buckets.

    O(1) amortized: a nonzero-unavailability segment ends at the next
    recovery event, so its length is bounded by the downtime scale and
    rarely spans more than two buckets.
    """
    b0, b1 = t0 // bw, (t1 - 1) // bw
    if b0 == b1:
        bl[b0] += unl * (t1 - t0)
        bm[b0] += unm * (t1 - t0)
        return
    first = (b0 + 1) * bw - t0
    bl[b0] += unl * first
    bm[b0] += unm * first
    for b in range(b0 + 1, b1):
        bl[b] += unl * bw
        bm[b] += unm * bw
    last = t1 - b1 * bw
    bl[b1] += unl * last
    bm[b1] += unm * last


def block_ci_halfwidth(bucket_l: np.ndarray, bucket_m: np.ndarray,
                       ticks: int, bw: int, partitions: int,
                       blocks: int = 16) -> tuple:
    """Batch-means 95% CI half-widths from bucketed unavailable
    partition-ticks (per-bucket width bw, accumulated online — O(buckets)
    memory, independent of the event count).

    The binomial CI over partition-ticks badly understates variance here:
    one node failure flips many partitions at once and the whole-cluster
    majority term correlates all of them, so partition-ticks are nowhere
    near independent.  Batch means over ~`blocks` equal time blocks
    captures that correlation (blocks longer than the downtime scale are
    ~i.i.d.).
    """
    m = (ticks + bw - 1) // bw          # buckets covering [0, ticks)
    if ticks <= 0 or m < 2:
        return 0.0, 0.0
    k = min(blocks, m)
    grp = (np.arange(m) * k) // m       # bucket -> block (±1 bucket width)
    widths = np.full(m, float(bw))
    widths[-1] = ticks - (m - 1) * bw
    pt = partitions * np.bincount(grp, weights=widths, minlength=k)
    u_l = np.bincount(grp, weights=bucket_l[:m], minlength=k) / pt
    u_m = np.bincount(grp, weights=bucket_m[:m], minlength=k) / pt
    t = t975(k - 1) / math.sqrt(k)
    return t * float(u_l.std(ddof=1)), t * float(u_m.std(ddof=1))


def evaluate_rank_state(up: np.ndarray, succ: np.ndarray,
                        full_succ: np.ndarray, *, rf: int, voters: int):
    """One availability evaluation step shared by the event engine and the
    cross-backend tests: rank-space PAC via the numpy backend, plus the
    frozen-holder refresh (available partitions adopt the current cluster
    replicas as holders in place; unavailable partitions keep theirs).

    Mutates full_succ.  Returns (unavail_lark, unavail_maj, up_succ).
    """
    up_succ = up[succ]
    lark, maj, creps = pac_eval_rank_np(up_succ, full_succ, rf=rf,
                                        voters=voters, n_real=up.shape[0])
    np.copyto(full_succ, creps, where=lark[:, None])
    return int((~lark).sum()), int((~maj).sum()), up_succ


@dataclass
class AvailabilityResult:
    p: float
    rf: int
    n: int
    partitions: int
    ticks: int
    u_lark: float
    u_maj: float
    lark_events: int
    maj_events: int
    ci_lark: float
    ci_maj: float
    stopped_early: bool

    @property
    def improvement(self) -> float:
        return self.u_maj / self.u_lark if self.u_lark > 0 else math.inf


def simulate_availability(*, n: int = 155, partitions: int = 4096,
                          rf: int = 2, p: float = 1e-3, downtime: int = 10,
                          min_ticks: int = 50_000, max_ticks: int = 3_000_000,
                          eps_abs: float = 5e-6, eps_rel: float = 0.05,
                          check_every: int = 5_000, min_events: int = 200,
                          seed: int = 0) -> AvailabilityResult:
    rng = np.random.default_rng(seed)
    succ = succession_matrix_fast(partitions, range(n), seed=seed)  # (P,n)
    f = rf - 1
    voters = 2 * f + 1

    up = np.ones(n, dtype=bool)
    # succession-rank-space state: column i of row p refers to node succ[p,i]
    up_succ = up[succ]
    full_succ = np.zeros((partitions, n), dtype=bool)
    full_succ[:, :rf] = True          # initially the roster replicas are full

    heap = []  # (tick, seq, kind, node)
    seq = 0
    for node in range(n):
        t = int(rng.geometric(p))
        heapq.heappush(heap, (t, seq, "fail", node))
        seq += 1

    # initial availability
    def evaluate():
        nonlocal up_succ
        unl, unm, up_succ = evaluate_rank_state(up, succ, full_succ,
                                                rf=rf, voters=voters)
        return unl, unm

    unavail_lark, unavail_maj = evaluate()
    lark_pt = 0.0   # unavailable partition-ticks
    maj_pt = 0.0
    lark_events = 0
    maj_events = 0
    prev_t = 0
    now = 0
    stopped = False
    # online time-bucketed unavailable partition-ticks for batch-means CI
    ci_bw = max(1, max_ticks // 4096)
    bucket_l = np.zeros(max_ticks // ci_bw + 2)
    bucket_m = np.zeros(max_ticks // ci_bw + 2)

    while heap and now < max_ticks:
        t, _, kind, node = heapq.heappop(heap)
        t = min(t, max_ticks)
        if t > prev_t:
            lark_pt += unavail_lark * (t - prev_t)
            maj_pt += unavail_maj * (t - prev_t)
            if unavail_lark or unavail_maj:
                _accumulate_buckets(bucket_l, bucket_m, prev_t, t,
                                    unavail_lark, unavail_maj, ci_bw)
            prev_t = t
        now = t
        if t >= max_ticks:
            break
        if kind == "fail":
            if up[node]:
                up[node] = False
                heapq.heappush(heap, (t + downtime, seq, "recover", node))
                seq += 1
        else:
            up[node] = True
            heapq.heappush(heap, (t + int(rng.geometric(p)), seq, "fail", node))
            seq += 1
        new_lark, new_maj = evaluate()
        if new_lark > unavail_lark:
            lark_events += new_lark - unavail_lark
        if new_maj > unavail_maj:
            maj_events += new_maj - unavail_maj
        unavail_lark, unavail_maj = new_lark, new_maj

        # early-stopping check
        if now >= min_ticks and now % check_every < downtime \
                and lark_events >= min_events and maj_events >= min_events:
            pt = partitions * now
            u_l = lark_pt / pt
            u_m = maj_pt / pt
            hw_l = 1.96 * math.sqrt(max(u_l * (1 - u_l), 1e-30) / pt)
            hw_m = 1.96 * math.sqrt(max(u_m * (1 - u_m), 1e-30) / pt)
            if hw_l <= max(eps_abs, eps_rel * u_l) and \
                    hw_m <= max(eps_abs, eps_rel * u_m):
                stopped = True
                break

    ticks = max(prev_t, 1)
    pt = partitions * ticks
    u_l = lark_pt / pt
    u_m = maj_pt / pt
    # honest CI: batch means (captures the node-failure correlation across
    # partitions), floored by the binomial width for the zero-event case
    hw_l, hw_m = block_ci_halfwidth(bucket_l, bucket_m, ticks, ci_bw,
                                    partitions)
    return AvailabilityResult(
        p=p, rf=rf, n=n, partitions=partitions, ticks=ticks,
        u_lark=u_l, u_maj=u_m, lark_events=lark_events,
        maj_events=maj_events,
        ci_lark=max(hw_l, 1.96 * math.sqrt(max(u_l * (1 - u_l), 1e-30) / pt)),
        ci_maj=max(hw_m, 1.96 * math.sqrt(max(u_m * (1 - u_m), 1e-30) / pt)),
        stopped_early=stopped)
