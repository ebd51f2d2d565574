"""Numpy rank-space PAC evaluation — the event engine's evaluate()
(port of ``repro/kernels/pac_np.py``, copied verbatim).  The scalar
Monte Carlo (core/availability.py) runs it on the host; the CUDA kernels'
plain versions in ``pac_eval.py`` follow the same math in torch.
"""
from __future__ import annotations

import numpy as np


def pac_eval_rank_np(up_succ, full_succ, *, rf: int, voters: int,
                     n_real: int):
    """(R, n_pad) bool tiles -> (lark (R,), maj (R,), creps (R, n_pad)).

    Columns >= n_real are padding.  Whole-cluster majority uses any row's
    up-count: each row of up_succ is a permutation of the same node set,
    so row sums all equal the cluster's up-count.
    """
    up = np.asarray(up_succ, dtype=bool)
    full = np.asarray(full_succ, dtype=bool)
    if up.shape[1] > n_real:                      # mask padding columns
        valid = np.arange(up.shape[1]) < n_real
        up = up & valid
        full = full & valid
    n_up = up.sum(axis=1)
    majority = 2 * n_up > n_real
    roster_up = up[:, :rf].any(axis=1)
    full_up = (full & up).any(axis=1)
    lark = majority & roster_up & full_up
    maj = 2 * up[:, :voters].sum(axis=1) > voters
    rank = np.cumsum(up, axis=1) <= rf
    creps = up & rank
    return lark, maj, creps


def downtime_eval_rank_np(up_succ, full_succ, *, rf: int, n_real: int,
                          roster=None, want_repmask: bool = False,
                          want_rleader: bool = False):
    """Per-step protocol evaluation for the downtime engine (§6).

    Same (R, n_pad) rank-space tiles as pac_eval_rank_np.  Returns
      lark        (R,)   bool — PAC SimpleMajority (identical math)
      qmaj        (R,)   bool — majority of the f+1-copy replica set
                         (the first rf succession columns, or the given
                         roster's ranks; equal storage either way)
      leader      (R,)   int32 — succession rank of the acting leader
                         (first up node; n_real when no node is up)
      leader_full (R,)   bool — leader holds the latest copy (pre-refresh
                         full mask, so a fresh leader is visibly stale)
      nrep        (R,)   int32 — up-count within the replica set
      creps       (R, n_pad) bool — cluster replicas (holder refresh)

    roster (R, rf) int32, optional: per-row succession ranks (< n_real) of
    the quorum-log replica set — the reconfiguring baseline's carried
    state.  When given, qmaj/nrep are evaluated over those ranks instead
    of the implicit first-rf lanes (roster=None is exactly the static
    baseline: a roster of [0, ..., rf-1] gives identical outputs).  All
    other outputs are roster-independent.

    The protocol-zoo engines request extra outputs, inserted *before*
    creps (so creps stays last — the contract _initial_full_state keys
    on):
      want_repmask  repmask (R,) int32, bit j set iff the first-rf lane j
                    is up — the Hermes engine's membership view (requires
                    rf <= 30 so the mask fits a non-negative int32)
      want_rleader  rleader (R,) int32, the minimum succession rank among
                    *up roster members* (n_real when none is up) — the
                    Spinnaker engine's electable leader; requires roster
    """
    up = np.asarray(up_succ, dtype=bool)
    full = np.asarray(full_succ, dtype=bool)
    lark, qmaj, creps = pac_eval_rank_np(up, full, rf=rf, voters=rf,
                                         n_real=n_real)
    if up.shape[1] > n_real:
        valid = np.arange(up.shape[1]) < n_real
        up = up & valid
        full = full & valid
    if roster is None:
        nrep = up[:, :rf].sum(axis=1).astype(np.int32)
    else:
        roster = np.asarray(roster)
        if roster.shape != (up.shape[0], rf):
            raise ValueError(f"roster must have shape (R, rf)="
                             f"({up.shape[0]}, {rf}); got {roster.shape}")
        nrep = np.take_along_axis(up, roster, axis=1) \
            .sum(axis=1).astype(np.int32)
    qmaj = 2 * nrep > rf
    lanes = np.arange(up.shape[1], dtype=np.int32)
    leader = np.where(up, lanes[None, :], np.int32(up.shape[1])) \
        .min(axis=1).astype(np.int32)
    leader = np.minimum(leader, np.int32(n_real))
    leader_full = ((full & up) & (lanes[None, :] == leader[:, None])) \
        .any(axis=1)
    extras = ()
    if want_repmask:
        bits = np.int32(1) << np.arange(rf, dtype=np.int32)
        repmask = (up[:, :rf].astype(np.int32) * bits[None, :]) \
            .sum(axis=1, dtype=np.int32)
        extras = extras + (repmask,)
    if want_rleader:
        if roster is None:
            raise ValueError("rleader needs a roster (it elects among "
                             "roster members)")
        rup = np.take_along_axis(up, roster, axis=1)
        rleader = np.where(rup, roster.astype(np.int32),
                           np.int32(n_real)).min(axis=1).astype(np.int32)
        extras = extras + (rleader,)
    return (lark, qmaj, leader, leader_full, nrep) + extras + (creps,)


def rebuild_node_counts_np(recruit, active, *, n_real: int):
    """(B, P) recruit node ids + (B, P) active mask -> (B, n_real) int32.

    counts[b, node] = number of partitions in trial b whose active
    catch-up is ingesting on `node` — the per-node reduction behind the
    downtime engine's bandwidth-contended rebuild model (§6).  Ids outside
    [0, n_real) (the engine's no-recruit sentinel) and inactive entries
    contribute nothing.  The reduction never crosses trials (rows), so it
    commutes with trials-axis sharding.
    """
    recruit = np.asarray(recruit)
    active = np.asarray(active, dtype=bool)
    if recruit.shape != active.shape or recruit.ndim != 2:
        raise ValueError(f"recruit/active must share a (B, P) shape; got "
                         f"{recruit.shape} vs {active.shape}")
    ok = active & (recruit >= 0) & (recruit < n_real)
    counts = np.zeros((recruit.shape[0], n_real), dtype=np.int32)
    rows = np.arange(recruit.shape[0])[:, None]
    np.add.at(counts, (rows, np.clip(recruit, 0, n_real - 1)),
              ok.astype(np.int32))
    return counts
