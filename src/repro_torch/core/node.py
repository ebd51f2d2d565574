"""LARK node: per-node protocol state machine (paper §4).

Transport-agnostic: every handler returns a list of outgoing messages; the
event simulator (core/simulator.py) or the in-process checkpoint store
(repro.checkpoint.lark_store) routes them.  All five Replica-Write guard
conditions, dup-res, regimes (ER/PR/LR), rebalance with PR-match migration,
and duplicates are implemented exactly as in Algorithms 1-4 + §4.2.

Condition toggles (``disable_conditions``) exist ONLY so the Appendix-A
necessity tests can replay each counter-example schedule with one condition
switched off and observe the safety violation.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from .messages import (CheckRegime, CheckRegimeReply, DuplicateRelease,
                       DupResReply, DupResReq, MarkReplicated, MigrateAck,
                       MigratePush, Msg, ReplicaWrite, ReplicaWriteAck)
from .pac import ALL_CONDITIONS, evaluate_pac
from .succession import cluster_replicas

LC = Tuple[int, int]
ZERO_LC: LC = (-1, -1)

REPLICATED = "replicated"
UNREPLICATED = "unreplicated"


@dataclass
class Version:
    value: Any
    lc: LC
    status: str


@dataclass
class PartitionState:
    pr: int = -1
    lr: int = -1
    leader: int = -1
    acting_leader: bool = False
    nodes_in_cluster: frozenset = frozenset()
    is_replica: bool = False
    full: bool = False
    duplicate: bool = False
    available: bool = False
    condition: Optional[str] = None
    # migration bookkeeping (leader side): duplicates yet to immigrate
    pending_immigration: Set[int] = field(default_factory=set)
    pending_emigration: Set[int] = field(default_factory=set)


@dataclass
class OpResult:
    op_id: int
    kind: str                   # "write" | "read"
    key: str
    ok: Optional[bool] = None   # None = still pending / indeterminate
    value: Any = None
    reason: str = ""


class LarkNode:
    def __init__(self, node_id: int, roster: Sequence[int],
                 successions: Dict[int, Sequence[int]], rf: int,
                 pac_conditions: Sequence[str] = ALL_CONDITIONS,
                 disable_conditions: Sequence[str] = ()):
        self.node_id = node_id
        self.roster = list(roster)
        self.successions = successions
        self.rf = rf
        self.pac_conditions = tuple(pac_conditions)
        self.disabled = set(disable_conditions)
        self.alive = True
        self.er = 0
        self.p: Dict[int, PartitionState] = {
            pid: PartitionState() for pid in successions}
        self.records: Dict[int, Dict[str, Version]] = {pid: {} for pid in successions}
        self.last_replicated: Dict[int, Dict[str, Version]] = {
            pid: {} for pid in successions}
        self.ops: Dict[int, dict] = {}
        self.results: Dict[int, OpResult] = {}
        # audit trail for safety tests: every replica-write accepted here
        self.accept_log: List[Tuple[str, LC, Any, str]] = []

    # ------------------------------------------------------------------
    # Clustering / rebalance (paper §4.1-4.2)
    # ------------------------------------------------------------------

    def predict_full(self, pid: int, new_er: int) -> bool:
        st = self.p[pid]
        return st.pr == new_er - 1 and st.full

    def exchange_info(self, new_er: int) -> dict:
        """Info this node contributes to the reclustering exchange."""
        return {
            "node": self.node_id,
            "predicted_full": {pid: self.predict_full(pid, new_er)
                               for pid in self.p},
            "duplicates": {pid: self.p[pid].duplicate for pid in self.p},
            "leader_view": {pid: (self.p[pid].pr, self.p[pid].leader,
                                  self.p[pid].lr) for pid in self.p},
        }

    def on_recluster(self, new_er: int):
        """Clustering subsystem atomically updates ER; cancels rebalances."""
        if new_er > self.er:
            self.er = new_er
        # in-flight migrations for old regimes are cancelled implicitly by
        # the PR-match check on arrival.

    def rebalance(self, pid: int, members: frozenset,
                  exchange: Dict[int, dict]) -> List[Msg]:
        """Steps 1-6 of §4.2 for one partition.  `exchange` is keyed by node.

        Returns migration messages (step 5/6 kickoff happens lazily via
        request_migrations()).
        """
        assert self.node_id in members
        new_er = self.er
        st = self.p[pid]
        succ = self.successions[pid]
        predicted_full = {n for n in members
                          if exchange[n]["predicted_full"].get(pid, False)}

        # Step 2: availability
        res = evaluate_pac(cluster=set(members), roster=self.roster,
                           succession=succ, rf=self.rf,
                           full_nodes=predicted_full,
                           conditions=self.pac_conditions)
        if not res.available:
            st.full = False
            st.available = False
            st.condition = None
            st.is_replica = False
            # PR is NOT advanced (paper: steps 3-6 skipped).
            return []

        creps = cluster_replicas(succ, set(members), self.rf)

        # Step 3: retain previous leader if it is a member AND cluster replica
        leader = -1
        lr = -1
        acting = False
        prev = [(exchange[n]["leader_view"][pid]) for n in members]
        prev_regime = [(p, l, r) for (p, l, r) in prev if p == new_er - 1]
        if prev_regime:
            cand = max(prev_regime)[1]
            if cand in members and cand in creps:
                leader = cand
                lr = max(r for (p, l, r) in prev_regime if l == cand)
        if leader < 0:
            # first full node by succession order
            fulls = [n for n in succ if n in predicted_full]
            if fulls:
                leader = fulls[0]
                lr = new_er
                acting = leader not in creps
            else:
                avail = [n for n in succ if n in members]
                leader = avail[0]
                lr = new_er

        # Step 4: atomic local update
        was_replica_or_dup = st.duplicate
        st.pr = new_er
        st.lr = lr
        st.leader = leader
        st.acting_leader = acting and leader == self.node_id
        st.nodes_in_cluster = frozenset(members)
        st.is_replica = self.node_id in creps
        st.full = self.node_id in predicted_full
        st.available = True
        st.condition = res.condition
        if st.is_replica:
            st.duplicate = True  # §4.2.2: becomes duplicate on becoming replica

        # Step 5 bookkeeping (leader side): who must immigrate into me?
        if leader == self.node_id and not st.full:
            dups = {n for n in members
                    if n != self.node_id and (
                        exchange[n]["predicted_full"].get(pid, False)
                        or self._claims_duplicate(exchange[n], pid))}
            st.pending_immigration = set(dups)
            if not dups:
                # no node may hold anything newer: trivially full (step 5)
                self._immigration_complete(pid)
        else:
            st.pending_immigration = set()
        if leader == self.node_id and st.full:
            st.pending_emigration = {n for n in creps if n != self.node_id}
        return []

    @staticmethod
    def _claims_duplicate(xinfo: dict, pid: int) -> bool:
        return xinfo.get("duplicates", {}).get(pid, False)

    # ------------------------------------------------------------------
    # Migration (steps 5-6, PR-match constraint)
    # ------------------------------------------------------------------

    def migrate_out(self, pid: int, dst: int, emigration: bool) -> List[Msg]:
        """Push latest record versions into dst (leader or replica)."""
        recs = {k: (v.value, v.lc, v.status)
                for k, v in self.records[pid].items()}
        return [MigratePush(self.node_id, dst, pid, recs, self.p[pid].pr,
                            emigration)]

    def handle_migrate_push(self, m: MigratePush) -> List[Msg]:
        st = self.p[m.partition]
        # PR-match for migration (paper §4.2.1): only accept when sender and
        # receiver share the same partition regime.
        if m.sender_pr != st.pr:
            return []
        for key, (value, lc, status) in m.records.items():
            cur = self.records[m.partition].get(key)
            if cur is None or tuple(lc) > tuple(cur.lc):
                self.records[m.partition][key] = Version(value, tuple(lc), status)
                if status == REPLICATED:
                    self.last_replicated[m.partition][key] = Version(
                        value, tuple(lc), REPLICATED)
        out = [MigrateAck(self.node_id, m.src, m.partition, st.pr, m.emigration)]
        if m.emigration:
            # Step 6 receipt: replica now holds the latest of every record.
            st.full = True
            st.duplicate = True
        else:
            # Step 5 receipt (I am the immigrating leader).
            st.pending_immigration.discard(m.src)
            if not st.pending_immigration and st.leader == self.node_id \
                    and not st.full:
                out += self._immigration_complete(m.partition)
        return out

    def handle_migrate_ack(self, m: MigrateAck) -> List[Msg]:
        st = self.p[m.partition]
        if m.sender_pr != st.pr:
            return []
        if m.emigration and st.leader == self.node_id:
            st.pending_emigration.discard(m.src)
            if not st.pending_emigration:
                return self._emigration_complete(m.partition)
        return []

    def _immigration_complete(self, pid: int) -> List[Msg]:
        """All duplicates have pushed into this (leader) node -> full."""
        st = self.p[pid]
        st.full = True
        st.pending_emigration = {
            n for n in cluster_replicas(self.successions[pid],
                                        set(st.nodes_in_cluster), self.rf)
            if n != self.node_id}
        return []

    def _emigration_complete(self, pid: int) -> List[Msg]:
        """All cluster replicas full: release non-replica duplicates (§4.2.2)."""
        st = self.p[pid]
        creps = set(cluster_replicas(self.successions[pid],
                                     set(st.nodes_in_cluster), self.rf))
        return [DuplicateRelease(self.node_id, n, pid, st.pr)
                for n in st.nodes_in_cluster
                if n not in creps and n != self.node_id]

    def handle_duplicate_release(self, m: DuplicateRelease) -> List[Msg]:
        st = self.p[m.partition]
        if st.pr == m.pr and not st.is_replica:
            st.duplicate = False
        return []

    # ------------------------------------------------------------------
    # Algorithm 1: CLIENT-WRITE (leader side, phased state machine)
    # ------------------------------------------------------------------

    _op_ids = itertools.count(1)

    def client_write(self, pid: int, key: str, value: Any,
                     claimed_leader: Optional[int] = None) -> Tuple[int, List[Msg]]:
        op_id = next(self._op_ids)
        st = self.p[pid]
        leader = claimed_leader if claimed_leader is not None else self.node_id
        res = OpResult(op_id, "write", key)
        self.results[op_id] = res
        rr = st.pr                                  # Read Atomically: RR <- PR
        if leader != st.leader or st.leader != self.node_id or not st.available:
            res.ok = False
            res.reason = "not-leader"
            return op_id, []
        op = {"kind": "write", "pid": pid, "key": key, "value": value,
              "rr": rr, "lr": st.lr, "phase": "start", "pending": set(),
              "dup_replies": []}
        self.ops[op_id] = op
        return op_id, self._write_advance(op_id)

    def _needs_dupres(self, pid: int, key: str) -> bool:
        st = self.p[pid]
        cur = self.records[pid].get(key)
        cur_rr = cur.lc[0] if cur is not None else None
        return (not st.full) and (cur_rr != st.pr)

    def _write_advance(self, op_id: int) -> List[Msg]:
        op = self.ops[op_id]
        pid, key = op["pid"], op["key"]
        st = self.p[pid]
        out: List[Msg] = []

        if op["phase"] == "start":
            if self._needs_dupres(pid, key):             # line 8-10
                targets = self._dupres_targets(pid)
                if targets:
                    op["phase"] = "dupres"
                    op["pending"] = set(targets)
                    return [DupResReq(self.node_id, t, op_id, pid, key,
                                      self.node_id) for t in targets]
            op["phase"] = "after_dupres"

        if op["phase"] == "after_dupres":
            cur = self.records[pid].get(key)
            if cur is not None and cur.status == UNREPLICATED:  # line 12-15
                creps = cluster_replicas(self.successions[pid],
                                         set(st.nodes_in_cluster), self.rf)
                # re-replicate, tagged with the current regime (§4.4.1)
                new_lc = (st.pr, cur.lc[1])
                cur.lc = new_lc
                op["phase"] = "rereplicate"
                op["pending"] = {n for n in creps if n != self.node_id}
                op["rere_lc"] = new_lc
                if not op["pending"]:
                    cur.status = REPLICATED
                    self.last_replicated[pid][key] = Version(cur.value, new_lc,
                                                             REPLICATED)
                    op["phase"] = "write_local"
                else:
                    return [ReplicaWrite(self.node_id, n, op_id, pid, key,
                                         self.node_id, op["rr"], new_lc,
                                         op["lr"], cur.value, True)
                            for n in op["pending"]]
            else:
                op["phase"] = "write_local"

        if op["phase"] == "write_local":                   # lines 17-21
            cur = self.records[pid].get(key)
            vn = (cur.lc[1] + 1) if cur is not None else 0
            lc = (op["rr"], vn)
            self.records[pid][key] = Version(op["value"], lc, UNREPLICATED)
            op["lc"] = lc
            creps = cluster_replicas(self.successions[pid],
                                     set(st.nodes_in_cluster), self.rf)
            op["phase"] = "await_acks"
            op["pending"] = {n for n in creps if n != self.node_id}
            if not op["pending"]:
                return self._write_commit(op_id)
            return [ReplicaWrite(self.node_id, n, op_id, pid, key,
                                 self.node_id, op["rr"], lc, op["lr"],
                                 op["value"], False)
                    for n in op["pending"]]
        return out

    def _dupres_targets(self, pid: int) -> List[int]:
        """Nodes that may hold the latest version: reachable duplicates."""
        st = self.p[pid]
        return [n for n in st.nodes_in_cluster
                if n != self.node_id and n in st.pending_immigration
                or n != self.node_id and self._known_duplicate(pid, n)]

    def _known_duplicate(self, pid: int, n: int) -> bool:
        # The simulator fills per-exchange duplicate claims into
        # pending_immigration; additionally all cluster replicas of the
        # current regime are candidates (they accept writes).
        st = self.p[pid]
        return n in cluster_replicas(self.successions[pid],
                                     set(st.nodes_in_cluster), self.rf)

    def _write_commit(self, op_id: int) -> List[Msg]:
        op = self.ops.pop(op_id)
        pid, key = op["pid"], op["key"]
        cur = self.records[pid].get(key)
        if cur is not None and cur.lc == op.get("lc"):
            cur.status = REPLICATED                        # line 23
            self.last_replicated[pid][key] = Version(cur.value, cur.lc,
                                                     REPLICATED)
        res = self.results[op_id]
        res.ok = True                                      # line 24
        st = self.p[pid]
        creps = cluster_replicas(self.successions[pid],
                                 set(st.nodes_in_cluster), self.rf)
        if self.rf > 2:                                    # line 25 (advice)
            return [MarkReplicated(self.node_id, n, pid, key, op["lc"])
                    for n in creps if n != self.node_id]
        return []

    def _write_abort(self, op_id: int, reason: str) -> List[Msg]:
        op = self.ops.pop(op_id, None)
        res = self.results[op_id]
        res.ok = False
        res.reason = reason
        if op is None:
            return []
        pid, key = op["pid"], op["key"]
        if op.get("lc") is not None:
            cur = self.records[pid].get(key)
            if cur is not None and cur.lc == op["lc"]:
                prev = self.last_replicated[pid].get(key)   # lines 27-28
                if prev is not None:
                    self.records[pid][key] = Version(prev.value, prev.lc,
                                                     REPLICATED)
                else:
                    del self.records[pid][key]
        return []

    # ------------------------------------------------------------------
    # Algorithm 2: DUP-RES replica handler
    # ------------------------------------------------------------------

    def handle_dupres(self, m: DupResReq) -> List[Msg]:
        st = self.p[m.partition]
        if m.leader in st.nodes_in_cluster:                # line 2
            cur = self.records[m.partition].get(m.key)
            if cur is None:
                return [DupResReply(self.node_id, m.src, m.op_id, True,
                                    present=False)]
            return [DupResReply(self.node_id, m.src, m.op_id, True,
                                value=cur.value, lc=cur.lc, status=cur.status,
                                present=True)]
        return [DupResReply(self.node_id, m.src, m.op_id, False)]

    def handle_dupres_reply(self, m: DupResReply) -> List[Msg]:
        if m.op_id not in self.ops:
            return []
        op = self.ops[m.op_id]
        if m.src not in op["pending"]:
            return []
        if not m.ok:
            kind = op["kind"]
            return (self._write_abort(m.op_id, "dupres-failed") if kind == "write"
                    else self._read_abort(m.op_id, "dupres-failed"))
        op["pending"].discard(m.src)
        if m.present:
            op["dup_replies"].append(m)
        if op["pending"]:
            return []
        # all replies in: adopt the max-LC version (line: select largest LC)
        pid, key = op["pid"], op["key"]
        cur = self.records[pid].get(key)
        best = max(op["dup_replies"], key=lambda r: tuple(r.lc),
                   default=None)
        if best is not None and (cur is None or tuple(best.lc) > tuple(cur.lc)):
            self.records[pid][key] = Version(best.value, tuple(best.lc),
                                             best.status)
            if best.status == REPLICATED:
                self.last_replicated[pid][key] = Version(best.value,
                                                         tuple(best.lc),
                                                         REPLICATED)
        op["phase"] = "after_dupres"
        return (self._write_advance(m.op_id) if op["kind"] == "write"
                else self._read_advance(m.op_id))

    # ------------------------------------------------------------------
    # Algorithm 3: REPLICA-WRITE
    # ------------------------------------------------------------------

    def handle_replica_write(self, m: ReplicaWrite) -> List[Msg]:
        pid = m.partition
        st = self.p[pid]
        succ = self.successions[pid]
        # Compute atomically (paper lines 3-8):
        leader_in_cluster = m.leader in st.nodes_in_cluster
        node_in_replica_set = self.node_id in cluster_replicas(
            succ, set(st.nodes_in_cluster), self.rf)
        leader_not_too_old = m.rr + 1 >= self.er
        same_leader_regime = m.lrm == st.lr
        leader_not_too_new = st.pr + 1 >= self.er

        checks = {
            "LeaderInCluster": leader_in_cluster,
            "NodeInReplicaSet": node_in_replica_set,
            "LeaderNotTooOld": leader_not_too_old,
            "SameLeaderRegime": same_leader_regime,
            "LeaderNotTooNew": leader_not_too_new,
        }
        for c in self.disabled:   # appendix-A necessity experiments only
            checks[c] = True

        ok = ((checks["LeaderNotTooOld"] or checks["SameLeaderRegime"])
              and checks["LeaderInCluster"] and checks["LeaderNotTooNew"]
              and checks["NodeInReplicaSet"])
        if not ok:
            return [ReplicaWriteAck(self.node_id, m.src, m.op_id, False,
                                    "conditions")]
        cur = self.records[pid].get(m.key)
        cur_lc = cur.lc if cur is not None else ZERO_LC
        if tuple(m.lc) > tuple(cur_lc):                    # line 11
            status = REPLICATED if self.rf == 2 else UNREPLICATED
            self.records[pid][m.key] = Version(m.value, tuple(m.lc), status)
            if status == REPLICATED:
                self.last_replicated[pid][m.key] = Version(m.value,
                                                           tuple(m.lc),
                                                           REPLICATED)
            st.duplicate = True
            self.accept_log.append((m.key, tuple(m.lc), m.value, status))
            return [ReplicaWriteAck(self.node_id, m.src, m.op_id, True)]
        # Equal LC: idempotent re-replication of the same version is an ack.
        if tuple(m.lc) == tuple(cur_lc) and (cur is None or cur.value == m.value):
            return [ReplicaWriteAck(self.node_id, m.src, m.op_id, True)]
        return [ReplicaWriteAck(self.node_id, m.src, m.op_id, False, "stale-lc")]

    def handle_replica_write_ack(self, m: ReplicaWriteAck) -> List[Msg]:
        if m.op_id not in self.ops:
            return []
        op = self.ops[m.op_id]
        if m.src not in op["pending"]:
            return []
        if not m.ok:
            kind = op["kind"]
            return (self._write_abort(m.op_id, f"replica-reject:{m.reason}")
                    if kind == "write"
                    else self._read_abort(m.op_id, f"replica-reject:{m.reason}"))
        op["pending"].discard(m.src)
        if op["pending"]:
            return []
        if op["phase"] == "rereplicate":
            pid, key = op["pid"], op["key"]
            cur = self.records[pid].get(key)
            if cur is not None and cur.lc == op["rere_lc"]:
                cur.status = REPLICATED
                self.last_replicated[pid][key] = Version(cur.value, cur.lc,
                                                         REPLICATED)
            op["phase"] = "write_local"
            return (self._write_advance(m.op_id) if op["kind"] == "write"
                    else self._read_advance(m.op_id))
        if op["phase"] == "await_acks":
            return self._write_commit(m.op_id)
        return []

    def handle_mark_replicated(self, m: MarkReplicated) -> List[Msg]:
        cur = self.records[m.partition].get(m.key)
        if cur is not None and tuple(cur.lc) == tuple(m.lc):
            cur.status = REPLICATED
            self.last_replicated[m.partition][m.key] = Version(
                cur.value, cur.lc, REPLICATED)
        return []

    # ------------------------------------------------------------------
    # Algorithm 4: CLIENT-READ
    # ------------------------------------------------------------------

    def client_read(self, pid: int, key: str,
                    claimed_leader: Optional[int] = None) -> Tuple[int, List[Msg]]:
        op_id = next(self._op_ids)
        st = self.p[pid]
        leader = claimed_leader if claimed_leader is not None else self.node_id
        res = OpResult(op_id, "read", key)
        self.results[op_id] = res
        if leader != st.leader or st.leader != self.node_id or not st.available:
            res.ok = False
            res.reason = "not-leader"
            return op_id, []
        op = {"kind": "read", "pid": pid, "key": key, "rr": st.pr,
              "lr": st.lr, "phase": "start", "pending": set(),
              "dup_replies": []}
        self.ops[op_id] = op
        return op_id, self._read_advance(op_id)

    def _read_advance(self, op_id: int) -> List[Msg]:
        op = self.ops[op_id]
        pid, key = op["pid"], op["key"]
        st = self.p[pid]

        if op["phase"] == "start":
            if self._needs_dupres(pid, key):               # line 4-6
                targets = self._dupres_targets(pid)
                if targets:
                    op["phase"] = "dupres"
                    op["pending"] = set(targets)
                    return [DupResReq(self.node_id, t, op_id, pid, key,
                                      self.node_id) for t in targets]
            op["phase"] = "after_dupres"

        if op["phase"] == "after_dupres":
            cur = self.records[pid].get(key)
            if cur is not None and cur.status == UNREPLICATED:  # line 8-10
                creps = cluster_replicas(self.successions[pid],
                                         set(st.nodes_in_cluster), self.rf)
                new_lc = (st.pr, cur.lc[1])
                cur.lc = new_lc
                op["phase"] = "rereplicate"
                op["rere_lc"] = new_lc
                op["pending"] = {n for n in creps if n != self.node_id}
                if op["pending"]:
                    return [ReplicaWrite(self.node_id, n, op_id, pid, key,
                                         self.node_id, op["rr"], new_lc,
                                         op["lr"], cur.value, True)
                            for n in op["pending"]]
                cur.status = REPLICATED
            op["phase"] = "write_local"   # reuse label: next = check_regime

        if op["phase"] == "write_local":                   # lines 11-15
            creps = cluster_replicas(self.successions[pid],
                                     set(st.nodes_in_cluster), self.rf)
            op["phase"] = "check_regime"
            op["pending"] = {n for n in creps if n != self.node_id}
            if not op["pending"]:
                return self._read_commit(op_id)
            return [CheckRegime(self.node_id, n, op_id, pid, self.node_id,
                                st.pr) for n in op["pending"]]
        return []

    def handle_check_regime(self, m: CheckRegime) -> List[Msg]:
        st = self.p[m.partition]
        ok = st.pr == m.pr and st.leader == m.leader
        return [CheckRegimeReply(self.node_id, m.src, m.op_id, ok)]

    def handle_check_regime_reply(self, m: CheckRegimeReply) -> List[Msg]:
        if m.op_id not in self.ops:
            return []
        op = self.ops[m.op_id]
        if not m.ok:
            return self._read_abort(m.op_id, "check-regime-failed")
        op["pending"].discard(m.src)
        if op["pending"]:
            return []
        return self._read_commit(m.op_id)

    def _read_commit(self, op_id: int) -> List[Msg]:
        op = self.ops.pop(op_id)
        cur = self.records[op["pid"]].get(op["key"])
        res = self.results[op_id]
        res.ok = True
        res.value = cur.value if cur is not None else None
        return []

    def _read_abort(self, op_id: int, reason: str) -> List[Msg]:
        self.ops.pop(op_id, None)
        res = self.results[op_id]
        res.ok = False
        res.reason = reason
        return []

    # ------------------------------------------------------------------
    # Dispatch
    # ------------------------------------------------------------------

    def handle(self, m: Msg) -> List[Msg]:
        if not self.alive:
            return []
        if isinstance(m, DupResReq):
            return self.handle_dupres(m)
        if isinstance(m, DupResReply):
            return self.handle_dupres_reply(m)
        if isinstance(m, ReplicaWrite):
            return self.handle_replica_write(m)
        if isinstance(m, ReplicaWriteAck):
            return self.handle_replica_write_ack(m)
        if isinstance(m, MarkReplicated):
            return self.handle_mark_replicated(m)
        if isinstance(m, CheckRegime):
            return self.handle_check_regime(m)
        if isinstance(m, CheckRegimeReply):
            return self.handle_check_regime_reply(m)
        if isinstance(m, MigratePush):
            return self.handle_migrate_push(m)
        if isinstance(m, MigrateAck):
            return self.handle_migrate_ack(m)
        if isinstance(m, DuplicateRelease):
            return self.handle_duplicate_release(m)
        raise TypeError(m)
