"""Data partitioning & placement (paper §2.1-§2.2).

Keys hash to a 160-bit RIPEMD-160 digest (hashlib) -> 4096 partitions; each
partition orders all roster nodes by Rendezvous hashing [22] into a
*succession list*: first RF nodes = roster replicas, first = roster leader.
Given a cluster (set of reachable nodes), *cluster replicas* are the first RF
succession-list nodes present in the cluster.

The paper's key placement properties hold by construction and are verified in
tests/test_succession.py: (i) deterministic; (ii) uniform load; (iii) minimal
disruption — removing a node only left-shifts lists where it appeared,
adding a node right-shifts lower-ranked nodes only.
"""
from __future__ import annotations

import hashlib
import struct
from typing import List, Sequence, Tuple

import numpy as np

NUM_PARTITIONS = 4096


def key_digest(key: bytes | str) -> bytes:
    if isinstance(key, str):
        key = key.encode()
    return hashlib.new("ripemd160", key).digest() if "ripemd160" in \
        hashlib.algorithms_available else hashlib.sha1(key).digest()


def key_partition(key: bytes | str, num_partitions: int = NUM_PARTITIONS) -> int:
    d = key_digest(key)
    return int.from_bytes(d[:4], "little") % num_partitions


def rendezvous_score(partition: int, node: int) -> int:
    """Collision-resistant hash score on (P, N) (paper: any such hash works)."""
    h = hashlib.blake2b(struct.pack("<II", partition, node), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def succession_list(partition: int, roster: Sequence[int]) -> List[int]:
    """Roster node ids sorted by descending rendezvous score (stable)."""
    return sorted(roster, key=lambda n: (-rendezvous_score(partition, n), n))


def succession_matrix(num_partitions: int, roster: Sequence[int]) -> np.ndarray:
    """(P, n) int32 matrix of node ids by rank — the vectorized-sim layout."""
    roster = list(roster)
    scores = np.empty((num_partitions, len(roster)), dtype=np.uint64)
    for j, n in enumerate(roster):
        for p in range(num_partitions):
            scores[p, j] = rendezvous_score(p, n)
    order = np.argsort(-scores.astype(np.int64), axis=1, kind="stable")
    return np.asarray(roster, dtype=np.int32)[order]


def succession_matrix_fast(num_partitions: int, roster: Sequence[int],
                           seed: int = 0) -> np.ndarray:
    """Vectorized stand-in (splitmix-style integer hash) for large sims."""
    roster_arr = np.asarray(list(roster), dtype=np.uint64)
    p = np.arange(num_partitions, dtype=np.uint64)[:, None]
    x = (p << np.uint64(32)) ^ roster_arr[None, :] \
        ^ np.uint64((seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    order = np.argsort(x, axis=1, kind="stable")
    return np.asarray(list(roster), dtype=np.int32)[order]


def cluster_replicas(succ: Sequence[int], cluster: set, rf: int) -> List[int]:
    """First RF succession-list nodes present in the cluster (paper §2.2)."""
    out = []
    for n in succ:
        if n in cluster:
            out.append(n)
            if len(out) == rf:
                break
    return out
