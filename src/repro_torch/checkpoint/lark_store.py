"""LARK-replicated in-memory KV store — the framework's fault-tolerance layer.

This is the paper's protocol (repro.core) embedded as a service: "nodes" are
(possibly simulated) workers, keys are checkpoint shard names / serving
session ids, values are arbitrary blobs (ndarray bytes).  Every read/write
goes through Algorithms 1-4 — linearizable per key, log-free, PAC-governed
availability — so a training job keeps committing checkpoints through
worker failures whenever PAC holds (vs the quorum-log baseline which pauses;
see checkpoint/baseline_store.py and examples/outage_timeseries.py).

put/get return (ok, value) and never block: an unavailable partition fails
fast, exactly like the production system's client-visible behavior.

Port of ``repro/checkpoint/lark_store.py`` over the port's copies of the
protocol modules.  ``put_pytree``/``get_pytree`` store a tree's leaves
(``repro_torch.tree``: dicts, lists and tuples) under the reference's
keys ``<prefix>/<leafpath>``; a tensor leaf is stored detached, as the
value it holds now (the port's train step builds new tensors and never
updates a stored one in place).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch import tree as _tree
from repro_torch.core.pac import ALL_CONDITIONS
from repro_torch.core.simulator import LarkSim
from repro_torch.core.succession import key_partition


class LarkStore:
    def __init__(self, num_nodes: int, rf: int = 2, num_partitions: int = 64,
                 pac_conditions=ALL_CONDITIONS, seed: int = 0):
        self.sim = LarkSim(num_nodes=num_nodes, rf=rf,
                           num_partitions=num_partitions,
                           pac_conditions=pac_conditions, seed=seed)
        self.num_partitions = num_partitions
        self.sim.recluster()
        self.sim.settle()
        self.sim.run_migrations()

    # -- membership ------------------------------------------------------
    def fail_node(self, node_id: int):
        self.sim.fail_node(node_id)
        self.sim.settle()
        self.sim.run_migrations()

    def recover_node(self, node_id: int):
        self.sim.recover_node(node_id)
        self.sim.settle()
        self.sim.run_migrations()

    @property
    def regime(self) -> int:
        return self.sim.er_counter

    def available_fraction(self) -> float:
        avail = 0
        for pid in range(self.num_partitions):
            if self.sim.leader_of(pid) is not None:
                avail += 1
        return avail / self.num_partitions

    # -- KV API ------------------------------------------------------------
    def _pid(self, key: str) -> int:
        return key_partition(key, self.num_partitions)

    def put(self, key: str, value: Any) -> bool:
        pid = self._pid(key)
        op = self.sim.client_write(pid, key, value)
        self.sim.settle()
        res = self.sim.result(op)
        return bool(res and res.ok)

    def get(self, key: str) -> Tuple[bool, Any]:
        pid = self._pid(key)
        op = self.sim.client_read(pid, key)
        self.sim.settle()
        res = self.sim.result(op)
        if res and res.ok:
            return True, res.value
        return False, None

    # -- pytree checkpointing --------------------------------------------
    def put_pytree(self, prefix: str, tree) -> Tuple[int, int]:
        """Store every leaf under '<prefix>/<leafpath>'.  Returns (ok,
        total)."""
        ok = total = 0
        for path, leaf in _tree.leaves_with_paths(tree):
            if hasattr(leaf, "detach"):
                leaf = leaf.detach()
            total += 1
            ok += self.put(prefix + "/" + _tree.path_name(path), leaf)
        return ok, total

    def get_pytree(self, prefix: str, like) -> Tuple[bool, Any]:
        """Every leaf of `like`'s structure from '<prefix>/<leafpath>':
        (True, the tree), or (False, None) when one cannot be read."""
        leaves = []
        for path, _ in _tree.leaves_with_paths(like):
            good, val = self.get(prefix + "/" + _tree.path_name(path))
            if not good:
                return False, None
            leaves.append(val)
        return True, _tree.unflatten(like, leaves)
