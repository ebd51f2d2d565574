"""Where the availability engine's time goes on the card.

    PYTHONPATH=src python -m repro_torch.profile_step [--packed] \\
        [--n 155 --partitions 4096 --trials 8 --chunks 4] [--json OUT]

Runs ``simulate_availability_batched`` on cuda once to warm up, then
for ``--chunks`` chunks of 512 steps twice: once timed on the host clock
with nothing else attached (wall seconds, steps per second), once under
``torch.profiler`` for the kernels' device times.  Prints one JSON
object: the unprofiled wall time, the device-busy seconds (the sum of
the CUDA kernel events' durations), the idle share 1 - busy / wall, and
the kernels by device time.  The run's setup (succession matrix, tables,
the t = 0 eval) is inside both windows; at four chunks it is a small
part.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .core.availability_batched import simulate_availability_batched


def _device_self_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=155)
    ap.add_argument("--partitions", type=int, default=4096)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--rf", type=int, default=2)
    ap.add_argument("--p", type=float, default=1e-3)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--packed", action="store_true")
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step measures the card; torch sees none")
    kw = dict(n=args.n, partitions=args.partitions, trials=args.trials,
              rf=args.rf, p=args.p, min_ticks=10 ** 9, seed=0,
              packed=args.packed, device="cuda")
    simulate_availability_batched(max_steps=2, **kw)          # warm-up
    torch.cuda.synchronize()
    steps = 512 * args.chunks
    t0 = time.monotonic()
    simulate_availability_batched(max_steps=steps, **kw)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        simulate_availability_batched(max_steps=steps, **kw)
        torch.cuda.synchronize()
        wall_profiled = time.monotonic() - t0
    # kernel events only: a CPU op's self device time repeats the
    # durations of the kernels it launched
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                _device_self_us(evt)
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    out = {"device": torch.cuda.get_device_name(0), "n": args.n,
           "partitions": args.partitions, "trials": args.trials,
           "rf": args.rf, "packed": args.packed, "steps": steps,
           "wall_s": wall, "steps_per_s": steps / wall,
           "wall_s_profiled": wall_profiled, "device_busy_s": busy,
           "idle_share": (1.0 - busy / wall) if busy > 0 else None,
           "kernels_us": [{"name": k[:120], "us": v,
                           "us_per_step": v / steps} for k, v in top]}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
