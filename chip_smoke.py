#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the §5.1 availability Monte Carlo at the paper tile (n = 155
nodes, P = 4096 partitions, 8 trials).  One JSON line per phase:

1. ``nvidia-smi``: the card's name and power limit.
2. ``build``: nvcc for sm_90a, one process per source, and its seconds.
3. ``kernel``: each kernel against its plain PyTorch version on the
   card, ``torch.equal`` on random tiles at the paper tile (rf 2, 3, 4;
   n_pad 155 and 160), plus its time per call beside the plain version's.
4. ``engine``: ``simulate_availability_batched`` on cuda, unpacked and
   packed, about 6k steps with the trajectory kept.  The two runs must
   agree exactly, the first 512 steps must equal a ``device="cpu"`` run,
   and each kernel's launch count over this phase (the main path) must
   be positive.
5. ``bench_row``: the BENCH_sweep i.i.d. row and the hetero-mttf row at
   rf = 2, p = 1e-3, rebuilt by the port's runner on cuda, packed and
   unpacked, must equal the committed rows of
   ``benchmarks/BENCH_sweep.json`` byte for byte.
6. ``kernels``: every ported kernel with its launches on the main path,
   time, plain time, bound and error.

Any failure raises and exits non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import availability_batched as ab  # noqa: E402
from repro_torch.experiments import runner  # noqa: E402
from repro_torch.kernels import _build, bitpack  # noqa: E402
from repro_torch.kernels import fused_step as fk  # noqa: E402
from repro_torch.kernels import pac_eval as pk  # noqa: E402

#: paper tile (runner.py --full scale): nodes, partitions, trials
N, P, B = 155, 4096, 8
DEVICE = "cuda"
#: published HBM rates by card (NVIDIA data sheets), bytes/s
HBM_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12,
          "H100": 3.35e12}
#: 32-bit integer lane rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT_OPS = 132 * 64 * 1.98e9
#: integer ops per element, counted from the kernels' inner loops:
#: pac_eval per (row, column) byte lane; fused_pac_eval per word
OPS_PER_LANE = {"pac_eval": 10, "fused_pac_eval": 16}


def emit(obj):
    print(json.dumps(obj, sort_keys=True), flush=True)


def hbm_bw(name: str) -> float:
    for key, bw in HBM_BW.items():
        if key in name:
            return bw
    raise RuntimeError(f"no HBM rate on record for {name!r}")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over `reps` back-to-back calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        d = (g.to(torch.int64) - w.to(torch.int64)).abs().max().item()
        err = max(err, float(d))
    return err


def check_kernels(bw):
    """Phase 3: bitwise agreement with the plain versions at the paper
    tile, and per-call times.  Returns the timing/bound records."""
    dev = torch.device(DEVICE)
    worst = {"pac_eval": 0.0, "fused_pac_eval": 0.0}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    R = B * P
    for n_pad in (155, 160):
        for rf in (2, 3, 4):
            voters = 2 * (rf - 1) + 1
            up = torch.rand((R, n_pad), generator=gen, device=dev) < 0.9
            full = torch.rand((R, n_pad), generator=gen, device=dev) < 0.3
            got = pk.pac_eval(up, full, rf=rf, voters=voters, n_real=N)
            torch.cuda.synchronize()
            want = pk.pac_eval_plain(up, full, rf=rf, voters=voters,
                                     n_real=N)
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            # the packed kernel on the same state gives the same bits
            upw = bitpack.pack_words(up.reshape(B, P, n_pad)) \
                .movedim(-1, 1).contiguous()
            fullw = bitpack.pack_words(full.reshape(B, P, n_pad)) \
                .movedim(-1, 1).contiguous()
            pgot = fk.fused_pac_eval(upw, fullw, rf=rf, voters=voters,
                                     n_real=N)
            torch.cuda.synchronize()
            creps_w = bitpack.pack_words(got[2].reshape(B, P, n_pad)) \
                .movedim(-1, 1)
            ok = ok and torch.equal(pgot[0].reshape(R), got[0]) \
                and torch.equal(pgot[1].reshape(R), got[1]) \
                and torch.equal(pgot[2], creps_w)
            err = max_abs_err(got, want)
            worst["pac_eval"] = max(worst["pac_eval"], err)
            emit({"phase": "kernel", "kernel": "pac_eval", "n_pad": n_pad,
                  "rf": rf, "equal": ok, "max_abs_err": err,
                  "lark_frac": got[0].float().mean().item()})
            if not ok:
                raise SystemExit(f"pac_eval disagrees (n_pad={n_pad}, "
                                 f"rf={rf})")
    W = bitpack.n_words(N)
    for rf in (2, 3, 4):
        voters = 2 * (rf - 1) + 1
        # words with every bit pattern, bit 31 included
        upw = torch.randint(-2 ** 31, 2 ** 31, (B, W, P), generator=gen,
                            device=dev, dtype=torch.int64).to(torch.int32)
        fullw = torch.randint(-2 ** 31, 2 ** 31, (B, W, P), generator=gen,
                              device=dev, dtype=torch.int64) \
            .to(torch.int32)
        got = fk.fused_pac_eval(upw, fullw, rf=rf, voters=voters, n_real=N)
        torch.cuda.synchronize()
        want = fk.fused_pac_eval_plain(upw, fullw, rf=rf, voters=voters,
                                       n_real=N)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max_abs_err(got, want)
        worst["fused_pac_eval"] = max(worst["fused_pac_eval"], err)
        emit({"phase": "kernel", "kernel": "fused_pac_eval", "W": W,
              "rf": rf, "equal": ok, "max_abs_err": err,
              "lark_frac": got[0].float().mean().item()})
        if not ok:
            raise SystemExit(f"fused_pac_eval disagrees (rf={rf})")

    # times at the main path's shapes: rf = 2, n_pad = n = 155 unpacked,
    # (8, 5, 4096) words packed.  The raw launcher is timed (the kernel),
    # and the wrapper (checks + allocation + launch) beside it.
    rf, voters = 2, 3
    up = torch.rand((R, N), generator=gen, device=dev) < 0.9
    full = torch.rand((R, N), generator=gen, device=dev) < 0.3
    upw = bitpack.pack_words(up.reshape(B, P, N)).movedim(-1, 1).contiguous()
    fullw = bitpack.pack_words(full.reshape(B, P, N)) \
        .movedim(-1, 1).contiguous()
    stream = torch.cuda.current_stream().cuda_stream
    outs = pk.pac_eval(up, full, rf=rf, voters=voters, n_real=N)
    raw = _build.function("pac_eval", "pac_eval_launch", pk._ARGTYPES)
    ptrs = [t.data_ptr() for t in (up, full, *outs)]
    pac_ms = time_ms(lambda: raw(*ptrs, R, N, N, rf, voters, stream), 200)
    pac_wrap_ms = time_ms(lambda: pk.pac_eval(up, full, rf=rf,
                                              voters=voters, n_real=N), 200)
    pac_plain_ms = time_ms(lambda: pk.pac_eval_plain(
        up, full, rf=rf, voters=voters, n_real=N), 20)
    fouts = fk.fused_pac_eval(upw, fullw, rf=rf, voters=voters, n_real=N)
    fraw = _build.function("fused_step", "fused_pac_eval_launch",
                           fk._ARGTYPES)
    fptrs = [t.data_ptr() for t in (upw, fullw, *fouts)]
    fused_ms = time_ms(lambda: fraw(*fptrs, B, W, P, N, rf, voters, stream),
                       200)
    fused_wrap_ms = time_ms(lambda: fk.fused_pac_eval(
        upw, fullw, rf=rf, voters=voters, n_real=N), 200)
    fused_plain_ms = time_ms(lambda: fk.fused_pac_eval_plain(
        upw, fullw, rf=rf, voters=voters, n_real=N), 20)

    pac_bytes = 3 * R * N + 2 * R
    fused_bytes = 3 * B * W * P * 4 + 2 * B * P
    rec = {}
    for name, nbytes, lanes, ms, wrap_ms, plain_ms in (
            ("pac_eval", pac_bytes, R * N, pac_ms, pac_wrap_ms,
             pac_plain_ms),
            ("fused_pac_eval", fused_bytes, B * W * P, fused_ms,
             fused_wrap_ms, fused_plain_ms)):
        bytes_ms = nbytes / bw * 1e3
        ops_ms = lanes * OPS_PER_LANE[name] / INT_OPS * 1e3
        rec[name] = {"ms": ms, "wrapper_ms": wrap_ms, "plain_ms": plain_ms,
                     "max_abs_err": worst[name],
                     "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations"}
        emit({"phase": "kernel_time", "kernel": name, **rec[name]})
    return rec


def check_engine():
    """Phase 4, the main path: the engine on cuda, unpacked and packed.
    Returns each kernel's launches over the phase."""
    kw = dict(n=N, partitions=P, rf=2, p=1e-3, trials=B, min_ticks=10 ** 9,
              max_steps=6000, seed=0, trajectory=True)
    pk.pac_eval.launches = 0
    fk.fused_pac_eval.launches = 0
    runs = {}
    for packed in (False, True):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        runs[packed] = ab.simulate_availability_batched(
            packed=packed, device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        steps = len(runs[packed].trajectory["times"])
        emit({"phase": "engine", "packed": packed, "steps": steps,
              "wall_s": wall, "steps_per_s": steps / wall,
              "ticks": runs[packed].ticks, "u_lark": runs[packed].u_lark,
              "u_maj": runs[packed].u_maj,
              "lark_events": runs[packed].lark_events})
    launches = {"pac_eval": pk.pac_eval.launches,
                "fused_pac_eval": fk.fused_pac_eval.launches}
    a, b = runs[False], runs[True]
    same = all(np.array_equal(a.trajectory[k], b.trajectory[k])
               for k in a.trajectory) and a.u_lark == b.u_lark \
        and a.u_maj == b.u_maj and a.lark_events == b.lark_events \
        and a.maj_events == b.maj_events \
        and np.array_equal(a.u_lark_trials, b.u_lark_trials)
    lark_down = int(a.trajectory["unavail_lark"].sum())
    emit({"phase": "engine", "packed_equals_unpacked": same,
          "launches": launches, "unavail_lark_partition_steps": lark_down})
    if not same:
        raise SystemExit("packed and unpacked engine runs disagree")
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel was not launched on the main path: "
                         f"{launches}")

    # the first chunk (512 steps) on the CPU, through the plain versions
    t0 = time.monotonic()
    cpu = ab.simulate_availability_batched(
        packed=False, device="cpu", **{**kw, "max_steps": 2})
    cpu_wall = time.monotonic() - t0
    k = len(cpu.trajectory["times"])
    cpu_same = all(np.array_equal(cpu.trajectory[c], a.trajectory[c][:k])
                   for c in cpu.trajectory)
    emit({"phase": "engine", "cpu_prefix_steps": k, "cpu_equal": cpu_same,
          "cpu_wall_s": cpu_wall})
    if not cpu_same:
        raise SystemExit("cuda run disagrees with the cpu run over the "
                         "first chunk")
    return launches


def check_bench_rows():
    """Phase 5: two committed BENCH_sweep rows, rebuilt on cuda."""
    base = json.loads((ROOT / "benchmarks" / "BENCH_sweep.json").read_text())
    spec = runner.ExperimentSpec.from_file(
        str(ROOT / "benchmarks" / "configs" / "sweep.toml"))

    def committed(kind, scenario=None):
        for r in base["rows"]:
            if r["kind"] == kind and r["rf"] == 2 and r["p"] == 1e-3 and \
                    r.get("scenario") == scenario:
                return json.dumps(r, sort_keys=True)
        raise SystemExit(f"no committed {kind} {scenario} row")

    seeds = tuple(range(spec.seed, spec.seed + spec.trials))
    for packed in (False, True):
        t0 = time.monotonic()
        iid = next(runner._gen_run(full=spec.full, seeds=seeds,
                                   devices=spec.devices, smoke=spec.smoke,
                                   packed=packed, device=DEVICE))
        sc = next(runner._gen_run_scenarios(
            ["hetero-mttf"], full=spec.full, trials=spec.trials,
            seed=spec.seed, devices=spec.devices, smoke=spec.smoke,
            packed=packed, device=DEVICE))
        wall = time.monotonic() - t0
        for row, want in ((iid, committed("iid")),
                          (sc, committed("scenario", "hetero-mttf"))):
            got = json.dumps(runner._json_safe(row), sort_keys=True)
            emit({"phase": "bench_row", "packed": packed,
                  "kind": row["kind"], "scenario": row.get("scenario"),
                  "identical": got == want, "u_lark": row["u_lark"],
                  "ticks": row["ticks"], "wall_s_pair": wall})
            if got != want:
                raise SystemExit(f"row differs from BENCH_sweep.json:\n"
                                 f"got  {got}\nwant {want}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 2
    t_start = time.monotonic()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "nvidia-smi", "gpu": smi, "device_name": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    secs = _build.build(verbose=True)
    emit({"phase": "build", "seconds": secs,
          "flags": " ".join(_build.NVCC_FLAGS)})

    rec = check_kernels(hbm_bw(name))
    launches = check_engine()
    check_bench_rows()

    sources = {"pac_eval": ("src/repro_torch/kernels/csrc/pac_eval.cu",
                            "src/repro/kernels/pac_eval.py:23"),
               "fused_pac_eval": (
                   "src/repro_torch/kernels/csrc/fused_step.cu",
                   "src/repro/kernels/fused_step.py:62")}
    kernels = []
    for kname in ("pac_eval", "fused_pac_eval"):
        r = rec[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1], "launches": launches[kname],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None})
    emit({"phase": "total", "wall_s": time.monotonic() - t_start})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
