"""Quorum-log baseline store (equal storage budget) — paper §5.2 BASELINE
(port of ``repro/checkpoint/baseline_store.py``, host Python as there).

f+1 data replicas per partition out of 2f+1 voters.  Availability follows
replica-set majority, and — the equal-storage cost — losing a data replica
pauses commits while a replacement hydrates (full-partition transfer at the
configured bandwidth).  ``advance(seconds)`` moves simulated time so tests
and examples can measure the no-commit window.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.core.pac import majority_quorum_available
from repro_torch.core.succession import key_partition, succession_list


class QuorumLogStore:
    def __init__(self, num_nodes: int, rf: int = 2, num_partitions: int = 64,
                 partition_bytes: float = 1e9, bandwidth: float = 50e6):
        self.rf = rf
        self.f = rf - 1
        self.num_partitions = num_partitions
        self.roster = list(range(num_nodes))
        self.succ = {p: succession_list(p, self.roster)
                     for p in range(num_partitions)}
        self.alive = set(self.roster)
        self.time = 0.0
        self.rebuild_s = partition_bytes / bandwidth
        # per-partition: current data-replica set + commit-pause deadline
        self.data_replicas = {p: list(self.succ[p][:rf])
                              for p in range(num_partitions)}
        self.pause_until: Dict[int, float] = {}
        self.store: Dict[int, Dict[str, Any]] = {p: {} for p in range(num_partitions)}

    def advance(self, seconds: float):
        self.time += seconds

    def fail_node(self, node_id: int):
        self.alive.discard(node_id)
        for p in range(self.num_partitions):
            if node_id in self.data_replicas[p]:
                # hydrate a replacement voter: commits pause for the rebuild
                spare = next((n for n in self.succ[p]
                              if n in self.alive and n not in self.data_replicas[p]),
                             None)
                self.data_replicas[p] = [n for n in self.data_replicas[p]
                                         if n != node_id]
                if spare is not None:
                    self.data_replicas[p].append(spare)
                    self.pause_until[p] = self.time + self.rebuild_s
                else:
                    self.pause_until[p] = float("inf")

    def recover_node(self, node_id: int):
        self.alive.add(node_id)
        for p, deadline in list(self.pause_until.items()):
            if deadline == float("inf"):
                spare = next((n for n in self.succ[p]
                              if n in self.alive and n not in self.data_replicas[p]),
                             None)
                if spare is not None and len(self.data_replicas[p]) < self.rf:
                    self.data_replicas[p].append(spare)
                    self.pause_until[p] = self.time + self.rebuild_s

    def _pid(self, key: str) -> int:
        return key_partition(key, self.num_partitions)

    def _available(self, pid: int, for_write: bool) -> bool:
        if not majority_quorum_available(self.alive, self.succ[pid], self.rf):
            return False
        if for_write and self.pause_until.get(pid, 0.0) > self.time:
            return False  # no-commit window while the replacement catches up
        if not any(n in self.alive for n in self.data_replicas[pid]):
            return False
        return True

    def put(self, key: str, value: Any) -> bool:
        pid = self._pid(key)
        if not self._available(pid, for_write=True):
            return False
        self.store[pid][key] = value
        return True

    def get(self, key: str) -> Tuple[bool, Any]:
        pid = self._pid(key)
        if not self._available(pid, for_write=False):
            return False, None
        return (key in self.store[pid]), self.store[pid].get(key)
