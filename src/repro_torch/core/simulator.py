"""Event-level cluster simulator for the LARK protocol.

Drives LarkNode instances through failures, network partitions, reclustering,
rebalancing and migration, with *controllable* message delivery so the
Appendix-A counter-example schedules (delay a specific Replica-Write across
two reclusters, defer one node's rebalance, ...) are expressible as tests.

Delivery modes:
  auto=True   messages delivered FIFO as part of run()/settle()
  auto=False  tests pull messages out of `sim.net` explicitly (hold/deliver)

History: every client op invocation/response is recorded for the
linearizability checker (values are made unique per write by the caller).
"""
from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .messages import Msg
from .node import LarkNode, OpResult
from .pac import ALL_CONDITIONS
from .succession import cluster_replicas, succession_list


@dataclass
class HistEvent:
    time: int
    kind: str       # invoke | ok | fail | indeterminate
    op_id: int
    op_kind: str    # write | read
    key: str
    value: Any = None


class Network:
    """Message store with FIFO auto-delivery and test hooks."""

    def __init__(self, rng: Optional[random.Random] = None):
        self.queue: List[Msg] = []
        self.rng = rng
        self.dropped: List[Msg] = []

    def send_all(self, msgs: Sequence[Msg]):
        self.queue.extend(msgs)

    def pop_matching(self, pred: Callable[[Msg], bool]) -> List[Msg]:
        """Remove and return all queued messages matching pred (test hook)."""
        out = [m for m in self.queue if pred(m)]
        self.queue = [m for m in self.queue if not pred(m)]
        return out

    def pop_next(self) -> Optional[Msg]:
        return self.queue.pop(0) if self.queue else None


class LarkSim:
    def __init__(self, num_nodes: int, rf: int, num_partitions: int = 4,
                 pac_conditions: Sequence[str] = ALL_CONDITIONS,
                 disable_conditions: Sequence[str] = (),
                 seed: int = 0):
        self.rf = rf
        self.roster = list(range(num_nodes))
        self.successions = {pid: succession_list(pid, self.roster)
                            for pid in range(num_partitions)}
        self.nodes: Dict[int, LarkNode] = {
            n: LarkNode(n, self.roster, self.successions, rf,
                        pac_conditions, disable_conditions)
            for n in self.roster}
        self.net = Network(random.Random(seed))
        self.rng = random.Random(seed + 1)
        self.er_counter = 0
        self.time = 0
        self.history: List[HistEvent] = []
        self.alive: Set[int] = set(self.roster)
        self._pending_rebalance: List[Tuple[int, int, int, frozenset,
                                            dict]] = []
        self._last_exchange: Dict[int, dict] = {}
        self._last_members: frozenset = frozenset()

    # ------------------------------------------------------------------
    # Cluster membership control
    # ------------------------------------------------------------------

    def set_succession(self, pid: int, order: Sequence[int]):
        """Tests pin succession lists (e.g. lexicographic per Appendix A)."""
        self.successions[pid] = list(order)
        for n in self.nodes.values():
            n.successions = self.successions

    def fail_node(self, node_id: int, recluster: bool = True):
        self.alive.discard(node_id)
        self.nodes[node_id].alive = False
        if recluster:
            self.recluster()

    def recover_node(self, node_id: int, recluster: bool = True):
        self.alive.add(node_id)
        self.nodes[node_id].alive = True
        if recluster:
            self.recluster()

    def recluster(self, members: Optional[Set[int]] = None,
                  defer_rebalance: Sequence[int] = ()) -> int:
        """One reclustering step over `members` (default: all alive nodes).

        Models the single consensus round: mints a new exchange number, runs
        the full-status/leader exchange, then rebalances every (member,
        partition) — except nodes in `defer_rebalance`, whose rebalance is
        queued for the test to release later via run_deferred_rebalance().
        """
        members = frozenset(members if members is not None else self.alive)
        self.er_counter += 1
        er = self.er_counter
        for n in members:
            self.nodes[n].on_recluster(er)
        exchange = {n: self.nodes[n].exchange_info(er) for n in members}
        self._last_exchange = exchange
        self._last_members = members
        for n in members:
            for pid in self.successions:
                if n in defer_rebalance:
                    self._pending_rebalance.append((n, pid, er, members,
                                                    exchange))
                else:
                    self.net.send_all(self.nodes[n].rebalance(pid, members,
                                                              exchange))
        return er

    def run_deferred_rebalance(self, node_id: int, pid: Optional[int] = None):
        """Release rebalances queued by recluster(defer_rebalance=...).

        A deferred rebalance is only valid within the regime that queued it:
        if the node has since observed a newer exchange round (its er moved
        past the one captured at defer time), replaying the old rebalance
        would roll protocol state back to a dead regime — stale entries are
        dropped instead of released.
        """
        keep = []
        for (n, p, er, members, exchange) in self._pending_rebalance:
            if n == node_id and (pid is None or p == pid):
                if self.nodes[n].er == er:        # still the same regime?
                    self.net.send_all(self.nodes[n].rebalance(p, members,
                                                              exchange))
            else:
                keep.append((n, p, er, members, exchange))
        self._pending_rebalance = keep

    # ------------------------------------------------------------------
    # Migration driver (asynchronous steps 5-6)
    # ------------------------------------------------------------------

    def run_migrations(self, max_rounds: int = 8):
        """Kick off & settle immigration/emigration for all partitions."""
        for _ in range(max_rounds):
            sent = False
            for pid in self.successions:
                for n in self.alive:
                    node = self.nodes[n]
                    st = node.p[pid]
                    if st.leader == n and st.available:
                        if not st.full and st.pending_immigration:
                            for d in list(st.pending_immigration):
                                if d in self.alive and \
                                        self.nodes[d].p[pid].pr == st.pr:
                                    self.net.send_all(
                                        self.nodes[d].migrate_out(pid, n, False))
                                    sent = True
                                elif d not in self.alive:
                                    # dead duplicate can't contribute now
                                    st.pending_immigration.discard(d)
                                    if not st.pending_immigration and not st.full:
                                        self.net.send_all(
                                            node._immigration_complete(pid))
                        elif st.full and st.pending_emigration:
                            for r in list(st.pending_emigration):
                                if r in self.alive:
                                    self.net.send_all(
                                        node.migrate_out(pid, r, True))
                                    sent = True
            self.settle()
            if not sent:
                break

    # ------------------------------------------------------------------
    # Client operations
    # ------------------------------------------------------------------

    def leader_of(self, pid: int) -> Optional[int]:
        best = None
        for n in self.alive:
            st = self.nodes[n].p[pid]
            if st.available and st.leader == n:
                if best is None or st.pr > self.nodes[best].p[pid].pr:
                    best = n
        return best

    def client_write(self, pid: int, key: str, value: Any,
                     contact: Optional[int] = None) -> int:
        node_id = contact if contact is not None else self.leader_of(pid)
        if node_id is None:
            op = OpResult(-1, "write", key, ok=False, reason="no-leader")
            self.history.append(HistEvent(self.time, "invoke", -1, "write",
                                          key, value))
            self.history.append(HistEvent(self.time, "fail", -1, "write",
                                          key, value))
            return -1
        self.time += 1
        op_id, msgs = self.nodes[node_id].client_write(pid, key, value)
        self.history.append(HistEvent(self.time, "invoke", op_id, "write",
                                      key, value))
        self.net.send_all(msgs)
        self._op_owner = getattr(self, "_op_owner", {})
        self._op_owner[op_id] = node_id
        return op_id

    def client_read(self, pid: int, key: str,
                    contact: Optional[int] = None) -> int:
        node_id = contact if contact is not None else self.leader_of(pid)
        if node_id is None:
            self.history.append(HistEvent(self.time, "invoke", -1, "read", key))
            self.history.append(HistEvent(self.time, "fail", -1, "read", key))
            return -1
        self.time += 1
        op_id, msgs = self.nodes[node_id].client_read(pid, key)
        self.history.append(HistEvent(self.time, "invoke", op_id, "read", key))
        self.net.send_all(msgs)
        self._op_owner = getattr(self, "_op_owner", {})
        self._op_owner[op_id] = node_id
        return op_id

    def result(self, op_id: int) -> Optional[OpResult]:
        for n in self.nodes.values():
            if op_id in n.results:
                return n.results[op_id]
        return None

    # ------------------------------------------------------------------
    # Delivery
    # ------------------------------------------------------------------

    def deliver(self, m: Msg):
        self.time += 1
        node = self.nodes.get(m.dst)
        if node is None or not node.alive:
            self.net.dropped.append(m)
            return
        self.net.send_all(node.handle(m))

    def settle(self, max_msgs: int = 100_000):
        """Deliver all queued messages FIFO until quiescent."""
        for _ in range(max_msgs):
            m = self.net.pop_next()
            if m is None:
                break
            self.deliver(m)
        self._record_completions()

    def _record_completions(self):
        recorded = {e.op_id for e in self.history if e.kind != "invoke"}
        for n in self.nodes.values():
            for op_id, res in n.results.items():
                if op_id in recorded or res.ok is None:
                    continue
                self.history.append(HistEvent(
                    self.time, "ok" if res.ok else "fail", op_id, res.kind,
                    res.key, res.value))

    def finalize_history(self) -> List[HistEvent]:
        """Mark still-pending ops indeterminate (no client response)."""
        self._record_completions()
        recorded = {e.op_id for e in self.history if e.kind != "invoke"}
        for n in self.nodes.values():
            for op_id, res in n.results.items():
                if op_id not in recorded:
                    self.history.append(HistEvent(
                        self.time, "indeterminate", op_id, res.kind, res.key,
                        res.value))
        return self.history
