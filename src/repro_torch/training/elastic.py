"""Elastic training: LARK-style regimes applied to the training job itself
(port of ``repro/training/elastic.py``).

Membership changes (worker loss/join, straggler eviction) mint a new regime:
  1. recluster    — agree on the worker set (exchange number++),
  2. rebalance    — rebuild the step over the surviving workers,
  3. restore      — pull the latest committed train state from the
                    LARK-replicated store (no log replay: per-key
                    dup-res gives the newest checkpoint shards),
  4. resume       — continue with the new step.

On one card "workers" are simulated, as on the reference's CPU; on a pod
they are processes, and the control flow is the same.  Straggler
mitigation takes the same path: a worker exceeding `straggler_timeout`
per step is treated as a membership change.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.checkpoint.lark_store import LarkStore


@dataclass
class ElasticState:
    regime: int = 0
    workers: List[int] = field(default_factory=list)
    steps_in_regime: int = 0
    restores: int = 0


class ElasticTrainer:
    def __init__(self, num_workers: int,
                 make_step: Callable[[List[int]], Callable],
                 store: Optional[LarkStore] = None, rf: int = 2,
                 straggler_timeout: float = 60.0):
        """make_step(workers) -> the step closure for that worker set."""
        self.all_workers = list(range(num_workers))
        self.make_step = make_step
        self.store = store or LarkStore(num_workers, rf=rf, num_partitions=16)
        self.state = ElasticState(regime=1, workers=list(self.all_workers))
        self.step_fn = make_step(self.state.workers)
        self.straggler_timeout = straggler_timeout

    def on_membership_change(self, workers: List[int], train_state, like):
        """Recluster + rebalance + restore; returns the restored train
        state (`train_state` when the store cannot serve it)."""
        self.state.regime += 1
        self.state.workers = list(workers)
        self.state.steps_in_regime = 0
        # store membership follows the job membership
        for w in self.all_workers:
            alive = w in workers
            was_alive = w in self.store.sim.alive
            if alive and not was_alive:
                self.store.recover_node(w)
            elif not alive and was_alive:
                self.store.fail_node(w)
        self.step_fn = self.make_step(workers)
        ok, restored = self.store.get_pytree("train_state", like)
        self.state.restores += 1
        return restored if ok else train_state

    def checkpoint(self, train_state) -> bool:
        ok, total = self.store.put_pytree("train_state", train_state)
        return ok == total

    def run_step(self, *args):
        t0 = time.time()
        out = self.step_fn(*args)
        self.state.steps_in_regime += 1
        if time.time() - t0 > self.straggler_timeout:
            # straggler path: callers may evict and remesh
            pass
        return out
