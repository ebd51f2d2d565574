"""The paper's §5.2 single-outage timeline for one table row, the
checkpoint stores through an outage, and a §5.1 rolling-restart
timeline (port of the reference's ``examples/outage_timeseries.py``).

    PYTHONPATH=src python -m repro_torch.examples.outage_timeseries [--device cpu]

1. Table 3 row 3 (rs 1 KB, ps 1 GB, bw 5 MB/s, u 0.5, lf 0.5) through
   the micro-simulator at 520,000 ticks (``core/microsim.run_table``:
   the ``microsim_scan`` kernel on the card), its throughput as ASCII
   bars of 20 s buckets.
2. The training stack's analogue: LARK keeps committing checkpoints
   while the quorum-log baseline pauses for its hydration window.
3. A rolling restart over a 12-node rf 2 cluster in the batched Monte
   Carlo (``core/availability_batched``: ``pac_eval`` on the card; the
   reference runs its numpy backend), rendered from trial 0's event
   trajectory.

The engines are bit-identical to the reference's, so every figure is
the reference's.  ``run(ticks=...)`` shortens part 1 (tests); below
20 s the bars take one bucket of the whole run.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.checkpoint import LarkStore, QuorumLogStore
from repro_torch.core.availability_batched import \
    simulate_availability_batched
from repro_torch.core.microsim import MicroConfig, run_table
from repro_torch.device import resolve_device

TICKS = 520_000
N_STEPS = 60
HORIZON = 40_000
BUCKETS = 64
#: the Monte Carlo's knobs (the reference's, less its backend)
MC = dict(n=12, partitions=64, rf=2, p=5e-4, trials=2, max_ticks=HORIZON,
          min_ticks=HORIZON, restart_period=1_500, chunk_steps=128,
          trajectory=True)


def throughput_bars(ts, ticks: int) -> str:
    """'#' above 0.9 of the peak, '+' above 0.1, else '.', per bucket of
    20 s of ops completed a second (1,000 ticks)."""
    per_s = ts[:ticks - ticks % 1000].reshape(-1, 1000).sum(1)
    width = min(20, len(per_s))
    buckets = per_s[:len(per_s) - len(per_s) % width].reshape(
        -1, width).mean(1)
    peak = buckets.max()
    return "".join("#" if b > 0.9 * peak else ("+" if b > 0.1 * peak
                                                else ".")
                   for b in buckets)


def bucket_peaks(t, series, horizon: int = HORIZON,
                 buckets: int = BUCKETS) -> np.ndarray:
    """The most partitions unavailable in each time bucket: events inside
    the bucket, and the step function's value entering it (an outage
    across a bucket boundary shows in both buckets)."""
    per_bucket = np.zeros(buckets)
    idx = np.minimum((t * buckets) // horizon, buckets - 1)
    np.maximum.at(per_bucket, idx, series)
    edges = np.arange(buckets) * (horizon // buckets)
    enter_idx = np.searchsorted(t, edges, side="right") - 1
    entering = np.where(enter_idx >= 0, series[np.maximum(enter_idx, 0)], 0)
    return np.maximum(per_bucket, entering)


def run(ticks: int = TICKS, device=None, emit=print) -> dict:
    """The three parts; returns their figures: "row" (run_table's row),
    "bars", "lark_ok", "base_ok", "u_lark", "u_maj", "trajectory"
    (trial 0's times and series) and "peaks"."""
    dev = resolve_device(device)
    cfg = MicroConfig(rs=1e3, ps=1e9, bw=5e6, u=0.5, lf=0.5)
    emit("row: rs=1KB ps=1GB bw=5MB/s u=0.5 lf=0.5 (Table 3 row 3)")
    res = run_table([cfg], ticks=ticks, device=dev)[0]
    emit(f"LARK {res['lark']['throughput']:.0f} ops/s vs BASE "
         f"{res['base']['throughput']:.0f} ops/s (ratio "
         f"{res['throughput_ratio']:.2f}); backfill "
         f"{res['lark_backfill_s']:.0f}s, baseline down "
         f"{res['base_down_s']:.0f}s")
    out = {"row": res, "bars": {}}
    for name, ts in (("LARK", res["lark_ts"]), ("BASE", res["base_ts"])):
        out["bars"][name] = throughput_bars(ts, ticks)
        emit(f"{name:5s} |{out['bars'][name]}| 0..{ticks // 1000}s  "
             "(fail@2s recover@302s)")

    # the training stack's analogue: checkpoint commits through an outage
    lark = LarkStore(num_nodes=4, rf=2, num_partitions=32)
    base = QuorumLogStore(num_nodes=4, rf=2, num_partitions=32,
                          partition_bytes=1e9, bandwidth=5e6)
    lark_ok = base_ok = 0
    for step in range(N_STEPS):
        if step == 10:
            lark.fail_node(3)
            base.fail_node(3)
        if step == 40:
            lark.recover_node(3)
            base.recover_node(3)
        base.advance(10.0)  # 10 s a step
        k = f"ckpt/step{step}"
        lark_ok += lark.put(k, step)
        base_ok += base.put(k, step)
    out.update(lark_ok=lark_ok, base_ok=base_ok)
    emit(f"\ncheckpoint commits during outage run: LARK {lark_ok}/{N_STEPS}, "
         f"quorum-log baseline {base_ok}/{N_STEPS}")

    # §5.1: a rolling restart over a small cluster, from trial 0's events
    mc = simulate_availability_batched(**MC, device=dev)
    traj = mc.trajectory
    t = traj["times"][:, 0]
    out.update(u_lark=mc.u_lark, u_maj=mc.u_maj, trajectory={
        k: traj[k][:, 0] for k in ("times", "unavail_lark", "unavail_maj")},
        peaks={})
    emit(f"\nrolling restart MC (n=12 rf=2 P=64, restart every 1500 "
         f"ticks): u_lark={mc.u_lark:.2e} u_maj={mc.u_maj:.2e}")
    for name, series in (("LARK", traj["unavail_lark"][:, 0]),
                         ("MAJ", traj["unavail_maj"][:, 0])):
        peaks = bucket_peaks(t, series)
        out["peaks"][name] = peaks
        bars = "".join("#" if b >= 4 else ("+" if b > 0 else ".")
                       for b in peaks)
        emit(f"{name:5s}|{bars}| 0..{HORIZON} ticks  "
             f"(peak {int(peaks.max())} partitions down)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                 "outage_timeseries")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
