"""Kernel micro-benchmarks of the port's Monte Carlo step.

    python -m repro_torch.tools.kernel_bench [--autotune] [--device cpu]
        [--trials B --partitions P --nodes n] [--iters K]

The ``kernel_step_*`` rows time one ``kernels.ops.step_eval`` call (the
wrapper and its launch) in both layouts — unpacked (R, n) bool tiles and
packed (B, W, P) words — for the §5.1 PAC, the §6 eval and the
reconfiguring baseline's (roster and in-flight counts), in µs per call:
by CUDA events over `iters` back-to-back calls on the card, or with
``--device cpu`` by the host clock over the plain versions (a CPU time,
never a device one).  The ``kernel_step_hbm_*`` rows print the bytes one
step moves in each layout (``ops.step_hbm_bytes``), a pure function of
the shapes.  ``--autotune`` races the row tile of ``pac_eval`` and the
(block_t, block_p) block of the reconfig kind of ``fused_downtime_eval``
on the card and prints each candidate's µs (on the CPU the tuners return
the kernels' default tiles as "heuristic-fallback").

The reference's ``benchmarks/kernel_bench.py`` also times its jnp
oracles (attention, mLSTM, RG-LRU, the reference PAC); they are the
reference's code and have no counterpart here: this tool times the
port's own kernels only.  The default shape is the paper tile (B = 8,
P = 4096, n = 155) at the reference tool's rf = 3, voters = 5.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import bitpack
from repro_torch.kernels.ops import (StepSpec, autotune_block_p,
                                     autotune_fused_blocks, step_eval,
                                     step_hbm_bytes)
from repro_torch.tools import option_strings, parse


def _time_us(fn, iters: int, dev: torch.device) -> float:
    """Mean µs per call of `iters` back-to-back calls after a warm one: by
    CUDA events on the card, by the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize(dev)
        return t0.elapsed_time(t1) * 1e3 / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e6 / iters


def _card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(dev)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools."
                                 "kernel_bench",
                                 description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--autotune", action="store_true",
                    help="race the row tile and the fused block")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--trials", type=int, default=8,
                    help="trials B of the step's (B, P, n) tile")
    ap.add_argument("--partitions", type=int, default=4096)
    ap.add_argument("--nodes", type=int, default=155)
    ap.add_argument("--iters", type=int, default=100)
    return ap


def cli_options() -> tuple:
    return option_strings(build_parser())


def main(argv=None, *, strict: bool = True) -> int:
    args = parse(build_parser(), argv, strict)
    dev = resolve_device(args.device)
    B, P, n, iters = args.trials, args.partitions, args.nodes, args.iters
    R = B * P
    rf, voters = 3, 5
    print(f"kernel_bench_device,{dev.type},0,card={_card(dev)};"
          f"torch={torch.__version__}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    up = torch.rand((R, n), generator=gen, device=dev) < 0.95
    full = torch.rand((R, n), generator=gen, device=dev) < 0.3
    roster = torch.argsort(torch.rand((R, n), generator=gen, device=dev),
                           dim=1)[:, :rf].to(torch.int32).contiguous()
    recruit = torch.randint(0, n + 1, (B, P), generator=gen, device=dev,
                            dtype=torch.int32)
    active = torch.rand((B, P), generator=gen, device=dev) < 0.1
    upw = bitpack.pack_words(up.reshape(B, P, n)).movedim(-1, 1) \
        .contiguous()
    fullw = bitpack.pack_words(full.reshape(B, P, n)).movedim(-1, 1) \
        .contiguous()
    specs = {
        "pac": (StepSpec(metric="availability", rf=rf, voters=voters,
                         n_real=n), {}),
        "downtime": (StepSpec(metric="downtime", rf=rf, n_real=n), {}),
        "downtime_reconfig": (
            StepSpec(metric="downtime", rf=rf, n_real=n,
                     rebuild_model="reconfig"),
            dict(recruit=recruit, active=active)),
    }
    shape = f"b{B}p{P}n{n}"
    for name, (spec, counted) in specs.items():
        for packed in (False, True):
            s = dataclasses.replace(spec, packed=packed)
            reconfig = spec.rebuild_model == "reconfig"
            if packed:
                args_ = (upw, fullw)
                kw = dict(counted, roster=roster.reshape(B, P, rf)
                          if reconfig else None)
            else:
                args_ = (up, full)
                kw = dict(counted, roster=roster if reconfig else None)
            if spec.metric == "availability":
                kw = {}
            us = _time_us(lambda: step_eval(s, *args_, **kw), iters, dev)
            layout = "packed" if packed else "unpacked"
            print(f"kernel_step_{name}_{layout},{shape},{us:.2f},"
                  f"device={dev.type};rf={rf}")
    for name, (spec, _) in specs.items():
        hbm = step_hbm_bytes(spec, B, P, n)
        assert hbm["fused_bytes"] <= hbm["unfused_bytes"]
        print(f"kernel_step_hbm_{name},{shape},0,"
              f"unfused={hbm['unfused_bytes']};fused={hbm['fused_bytes']};"
              f"ratio={hbm['ratio']:.1f}")
    if args.autotune:
        res = autotune_block_p(R, n, rf=rf, voters=voters, n_real=n,
                               device=dev)
        print(f"kernel_pac_autotune,r{R}n{n},0,"
              f"choice={res.block_p};source={res.source}")
        for bp in sorted(res.timings_us):
            print(f"kernel_pac_block,bp{bp},{res.timings_us[bp]:.2f},"
                  f"autotune_candidate")
        fres = autotune_fused_blocks(B, P, n, rf=rf, voters=voters,
                                     n_real=n, kernel="fused_downtime_roster",
                                     device=dev)
        print(f"kernel_fused_autotune,{shape},0,"
              f"choice={fres.block_t}x{fres.block_p};source={fres.source}")
        for bt, bp in sorted(fres.timings_us):
            print(f"kernel_fused_block,bt{bt}bp{bp},"
                  f"{fres.timings_us[(bt, bp)]:.2f},autotune_candidate")
    return 0


if __name__ == "__main__":
    sys.exit(main())
