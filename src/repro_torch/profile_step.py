"""Where an engine's time goes on the card.

    PYTHONPATH=src python -m repro_torch.profile_step [--packed] \\
        [--n 155 --partitions 4096 --trials 8 --chunks 4] [--json OUT] \\
        [--metric downtime --rebuild-model reconfig --size-dist zipf \\
         --size-skew 1 --node-bandwidth-gibps 1] \\
        [--engines lark,quorum,hermes,spinnaker --lease-ticks 40 \\
         --view-change-ticks 200] [--metric latency]

Runs ``simulate_availability_batched`` (``--metric availability``, the
default), ``simulate_downtime_batched`` (``--metric downtime``, with the
§6 rebuild knobs and the protocol zoo's ``--engines``) or
``simulate_client_latency`` (``--metric latency``: the §6 engine with
the client-latency layer under the paper workload — zipf keys, 32
requests/tick, 80 % reads, an 8-tick SLO) on cuda once to warm up, then for ``--chunks``
chunks of 512 steps twice: once timed on the host clock with nothing
else attached (wall seconds, steps per second), once under
``torch.profiler`` for the kernels' device times.  Prints one JSON
object: the unprofiled wall time, the device-busy seconds (the sum of
the CUDA kernel events' durations), the idle share 1 - busy / wall, the
device ops (kernels and memsets) per step, and the kernels by device
time.  The run's setup (succession matrix, tables,
the t = 0 eval) is inside both windows; at four chunks it is a small
part.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .core.availability_batched import simulate_availability_batched
from .core.client_latency import simulate_client_latency
from .core.downtime_batched import simulate_downtime_batched


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
    ap.add_argument("--metric", default="availability",
                    choices=("availability", "downtime", "latency"))
    ap.add_argument("--rebuild-model", default="fixed",
                    choices=("fixed", "reconfig"))
    ap.add_argument("--size-dist", default="uniform",
                    choices=("uniform", "zipf", "lognormal"))
    ap.add_argument("--size-skew", type=float, default=1.0)
    ap.add_argument("--node-bandwidth-gibps", type=float, default=math.inf)
    ap.add_argument("--engines", default="lark,quorum",
                    help="comma-separated protocol zoo (§6 metrics)")
    ap.add_argument("--lease-ticks", type=int, default=0)
    ap.add_argument("--view-change-ticks", type=int, default=0)
    ap.add_argument("--json", metavar="PATH")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step measures the card; torch sees none")
    kw = dict(n=args.n, partitions=args.partitions, trials=args.trials,
              rf=args.rf, p=args.p, min_ticks=10 ** 9, seed=0,
              packed=args.packed, device="cuda")
    knobs = {}
    if args.metric == "availability":
        simulate = simulate_availability_batched
    else:
        knobs = dict(rebuild_model=args.rebuild_model,
                     size_dist=args.size_dist, size_skew=args.size_skew,
                     node_bandwidth_gibps=args.node_bandwidth_gibps)
        zoo = dict(engines=tuple(args.engines.split(",")),
                   lease_ticks=args.lease_ticks,
                   view_change_ticks=args.view_change_ticks)
        if args.metric == "downtime":
            knobs.update(zoo)
            simulate = simulate_downtime_batched
        elif zoo != dict(engines=("lark", "quorum"), lease_ticks=0,
                         view_change_ticks=0):
            ap.error("--engines, --lease-ticks and --view-change-ticks "
                     "apply to --metric downtime")
        else:
            # the workload knobs keep simulate_client_latency's defaults
            simulate = simulate_client_latency
        kw.update(knobs)
    simulate(max_steps=2, **kw)                               # warm-up
    torch.cuda.synchronize()
    steps = 512 * args.chunks
    t0 = time.monotonic()
    simulate(max_steps=steps, **kw)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        simulate(max_steps=steps, **kw)
        torch.cuda.synchronize()
        wall_profiled = time.monotonic() - t0
    # kernel events only: a CPU op's self device time repeats the
    # durations of the kernels it launched
    kernels, ops = {}, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + \
                _device_self_us(evt)
            ops += evt.count
    busy = sum(kernels.values()) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:20]
    out = {"device": torch.cuda.get_device_name(0), "metric": args.metric,
           **knobs, "n": args.n,
           "partitions": args.partitions, "trials": args.trials,
           "rf": args.rf, "packed": args.packed, "steps": steps,
           "wall_s": wall, "steps_per_s": steps / wall,
           "wall_s_profiled": wall_profiled, "device_busy_s": busy,
           "idle_share": (1.0 - busy / wall) if busy > 0 else None,
           "device_ops_per_step": ops / steps,
           "kernels_us": [{"name": k[:120], "us": v,
                           "us_per_step": v / steps} for k, v in top]}
    print(json.dumps(out), flush=True)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
