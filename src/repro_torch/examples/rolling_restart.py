"""Zero-downtime rolling restart at RF=2 (paper §1, SuperMajority; port
of the reference's ``examples/rolling_restart.py``).

    PYTHONPATH=src python -m repro_torch.examples.rolling_restart [--device cpu]

Restart every node of a 5-node cluster one at a time.  Under
SuperMajority (fewer than RF=2 roster nodes missing) every partition
stays available throughout: when one original replica reboots, the
other serves with an interim second copy; on return, only accrued
deltas flow back.  Writes continue during every phase.  The protocol
simulator runs on the host; the device is resolved as every entry point
resolves it, and nothing runs on it.
"""
from __future__ import annotations

import argparse

from repro_torch.core.linearizability import check_history
from repro_torch.core.simulator import LarkSim
from repro_torch.device import resolve_device

NODES, RF, PARTS = 5, 2, 8


def run(nodes: int = NODES, rf: int = RF, parts: int = PARTS, device=None,
        emit=print) -> dict:
    """The restarts; {"available" (per restarted node), "regimes",
    "writes", "reads_ok", "unavailable", "linearizable"}."""
    resolve_device(device)
    sim = LarkSim(num_nodes=nodes, rf=rf, num_partitions=parts)
    sim.recluster()
    sim.settle()
    sim.run_migrations()

    out = {"available": [], "regimes": []}
    writes = unavailable_any = 0
    for victim in range(nodes):
        sim.fail_node(victim)
        sim.settle()
        sim.run_migrations()
        avail = sum(1 for p in range(parts) if sim.leader_of(p) is not None)
        unavailable_any += parts - avail
        # keep writing during the restart window
        for p in range(parts):
            op = sim.client_write(p, f"key-{p}", f"v{victim}-{p}")
            sim.settle()
            writes += 1 if sim.result(op).ok else 0
        sim.recover_node(victim)
        sim.settle()
        sim.run_migrations()
        out["available"].append(avail)
        out["regimes"].append(sim.er_counter)
        emit(f"restarted node {victim}: partitions available during "
             f"window: {avail}/{parts}, regime {sim.er_counter}")

    reads_ok = 0
    for p in range(parts):
        op = sim.client_read(p, f"key-{p}")
        sim.settle()
        r = sim.result(op)
        reads_ok += 1 if (r.ok and r.value == f"v{nodes - 1}-{p}") else 0

    out.update(writes=writes, reads_ok=reads_ok, unavailable=unavailable_any,
               linearizable=all(check_history(
                   sim.finalize_history()).values()))
    emit(f"\nwrites committed during restarts: {writes}/{nodes * parts}")
    emit(f"final reads correct: {reads_ok}/{parts}")
    emit(f"partition-unavailability events: {unavailable_any} (expect 0)")
    emit(f"linearizable: {out['linearizable']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                 "rolling_restart")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
