"""Partition Availability Conditions — paper §3.

A partition P is available in a cluster C (a maximal fully-connected node
set agreeing on ClusterMembers) iff any of:

  1. SuperMajority:      |C ∩ roster| > |roster|/2  and  |roster \\ C| < RF
  2. AllRosterReplicas:  all RF roster replicas of P are in C
  3. SimpleMajority:     |C ∩ roster| > |roster|/2, >=1 roster replica in C,
                         and >=1 node in C is *full* for P
  4. HalfRoster:         |C ∩ roster| == |roster|/2, roster leader in C,
                         and >=1 node in C is *full* for P

This module is the scalar/protocol-level form used by the event simulator and
the LARK checkpoint store; the vectorized (P x n) form for the §5.1 Monte
Carlo lives in repro.kernels.ref.pac_eval_ref (+ the Pallas kernel).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Iterable, Optional, Sequence, Set, Tuple

ALL_CONDITIONS = ("super_majority", "all_roster_replicas", "simple_majority",
                  "half_roster")


@dataclass(frozen=True)
class PACResult:
    available: bool
    condition: Optional[str]  # first satisfied condition, in paper order


def evaluate_pac(*, cluster: Set[int], roster: Sequence[int],
                 succession: Sequence[int], rf: int,
                 full_nodes: Set[int],
                 conditions: Iterable[str] = ALL_CONDITIONS) -> PACResult:
    """Evaluate PAC for one partition.

    cluster: node ids in the (agreed) cluster view
    succession: the partition's succession list over the roster
    full_nodes: nodes *predicted full* for this partition (paper §4.2 step 1)
    """
    roster_set = set(roster)
    present = cluster & roster_set
    missing = len(roster_set) - len(present)
    majority = 2 * len(present) > len(roster_set)
    half = 2 * len(present) == len(roster_set)
    roster_replicas = list(succession[:rf])
    any_rr = any(n in cluster for n in roster_replicas)
    all_rr = all(n in cluster for n in roster_replicas)
    leader_in = succession[0] in cluster
    any_full = any(n in cluster for n in full_nodes)

    checks = {
        "super_majority": majority and missing < rf,
        "all_roster_replicas": all_rr,
        "simple_majority": majority and any_rr and any_full,
        "half_roster": half and leader_in and any_full,
    }
    for name in ALL_CONDITIONS:  # paper order for attribution
        if name in conditions and checks[name]:
            return PACResult(True, name)
    return PACResult(False, None)


def majority_quorum_available(cluster: Set[int], succession: Sequence[int],
                              rf: int, voters: Optional[int] = None) -> bool:
    """Quorum-log baseline: majority of the fixed 2f+1 voter set reachable."""
    nv = voters if voters is not None else 2 * (rf - 1) + 1
    voter_set = list(succession[:nv])
    return 2 * sum(1 for n in voter_set if n in cluster) > nv
