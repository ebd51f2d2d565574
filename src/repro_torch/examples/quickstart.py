"""Quickstart: the LARK protocol and the training stack (port of the
reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Part 1 runs the protocol simulator on the host: a linearizable KV over a
5-node cluster keeps partition 0 available through its leader's failure.
Part 2 trains the reduced smollm for 5 steps of 4 x 64 tokens on the
device.  The weights come from torch's seed-0 generator (the reference
draws them from ``jax.random.PRNGKey(0)``), so the losses are the port's
own; the protocol lines are the reference's.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs import reduced_config
from repro_torch.core.linearizability import check_history
from repro_torch.core.simulator import LarkSim
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.training import make_train_step


def run(steps: int = 5, device=None, emit=print) -> dict:
    """Both parts; {"leader", "new_leader", "regime", "read",
    "linearizable", "losses"}."""
    dev = resolve_device(device)
    # --- 1. The paper's protocol: linearizable KV over a 5-node cluster
    sim = LarkSim(num_nodes=5, rf=2, num_partitions=4)
    sim.recluster()
    sim.settle()
    sim.run_migrations()
    pid = 0
    out = {"leader": sim.leader_of(pid)}
    emit(f"leader of partition 0: {out['leader']}")
    sim.client_write(pid, "bank-balance", 100)
    sim.settle()
    sim.fail_node(sim.leader_of(pid))        # the leader dies
    sim.settle()
    sim.run_migrations()                     # PAC keeps it available
    out.update(new_leader=sim.leader_of(pid), regime=sim.er_counter)
    emit(f"new leader: {out['new_leader']} (regime {out['regime']} )")
    sim.client_write(pid, "bank-balance", 250)
    sim.settle()
    r = sim.client_read(pid, "bank-balance")
    sim.settle()
    out["read"] = sim.result(r).value
    emit(f"read after failover: {out['read']}")
    out["linearizable"] = check_history(sim.finalize_history())
    emit(f"linearizable: {out['linearizable']}")

    # --- 2. The training stack: a tiny LM trained for a few steps
    cfg = reduced_config("smollm_360m")
    data = SyntheticLMData(cfg, batch=4, seq=64)
    init_fn, step_fn, _ = make_train_step(cfg, peak_lr=3e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params, opt_state = init_fn(gen)
    out["losses"] = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(i).items()}
        params, opt_state, m = step_fn(params, opt_state, batch)
        out["losses"].append(float(m["loss"]))
        emit(f"step {i}: loss {out['losses'][-1]:.4f}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise RuntimeError(f"a loss is not finite: {out['losses']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                 "quickstart")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
