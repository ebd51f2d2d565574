"""Protocol messages (transport-agnostic dataclasses)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

LC = Tuple[int, int]  # (RR, VN) lexicographic logical clock


@dataclass
class Msg:
    src: int
    dst: int


@dataclass
class DupResReq(Msg):
    op_id: int
    partition: int
    key: str
    leader: int


@dataclass
class DupResReply(Msg):
    op_id: int
    ok: bool
    value: Any = None
    lc: Optional[LC] = None
    status: str = "replicated"
    present: bool = False


@dataclass
class ReplicaWrite(Msg):
    op_id: int
    partition: int
    key: str
    leader: int
    rr: int                 # leader PR at client-write start (paper line 4)
    lc: LC                  # new version's logical clock
    lrm: int                # leader's LR piggy-backed (paper: LRM)
    value: Any = None
    rereplication: bool = False


@dataclass
class ReplicaWriteAck(Msg):
    op_id: int
    ok: bool
    reason: str = ""


@dataclass
class MarkReplicated(Msg):
    partition: int
    key: str
    lc: LC


@dataclass
class CheckRegime(Msg):
    op_id: int
    partition: int
    leader: int
    pr: int


@dataclass
class CheckRegimeReply(Msg):
    op_id: int
    ok: bool


@dataclass
class MigratePush(Msg):
    partition: int
    records: Dict[str, Tuple[Any, LC, str]]
    sender_pr: int
    emigration: bool = False   # leader -> replicas (step 6) vs duplicate -> leader


@dataclass
class MigrateAck(Msg):
    partition: int
    sender_pr: int
    emigration: bool = False


@dataclass
class DuplicateRelease(Msg):
    """Leader -> non-replica duplicates after emigration completes (§4.2.2)."""
    partition: int
    pr: int
