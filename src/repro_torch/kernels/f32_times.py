"""Times of the float32 routes' CUDA sources at their main-path shapes,
beside their bounds and SDPA's time, and against an earlier commit's
sources of the same launchers.

* ``mlstm_chunk`` (csrc/mlstm_chunk.cu, the simt forward) at the reduced
  xlstm's shape, which ``serve_cpu``'s prefill and ``train_cpu``'s
  forward give it: (B, H, S, Dq, Dv, chunk) = (2, 4, 300, 32, 32, 256),
  float32; and at the xlstm-350m serve shape in float32, (4, 4, 1024,
  512, 512, 256).
* ``mlstm_chunk_bwd`` (csrc/mlstm_chunk_bwd.cu) at the same shape
  (``train_cpu``'s backward) and at the xlstm-350m train shape in
  float32, (4, 4, 1024, 512, 512, 256).
* ``flash_attention`` (csrc/flash_attention.cu) at the cases that its
  entry point takes on the card (``flash_check.SIMT_CASES``: float32 at D
  = 256 and bf16 at D = 32, (4, 16, ~3072), window 2048), beside
  ``F.scaled_dot_product_attention`` with the same boolean mask, whose
  kernels are named from a profiler trace.

Each time is the device time of one launch from ``mc_check.device_times``
(the profiler's kernel durations), taken in three passes, and each
kernel's share of it.  With
``--parent DIR`` (an earlier commit's tree, e.g. a ``git archive``
unpacked under ``build/``) DIR's copies of the three sources are built
beside these and every case is timed in turns parent, this, this,
parent; the backward of each tree is launched on the arguments its own
``mlstm_chunk.bwd_launch_args`` lays out (DIR's module loaded beside
this one), so a parent whose backward takes other scratch is timed on
its own layout.  The float32 bounds are those of the three-term TF32
split these sources run (three TF32 products a product, at the TF32
tensor-core peak), with the float32 CUDA-core figure beside them.
Prints one JSON line per case and exits 0; needs nvcc and a card:

    PYTHONPATH=src python -m repro_torch.kernels.f32_times [--parent DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import _build
from . import flash_attention as fa
from . import flash_check as fc
from . import mc_check as mcc
from . import mlstm_check as mc
from . import mlstm_chunk as mk

#: the float32 CUDA-core peak, the TF32 and bf16 tensor-core peaks of an
#: H100 SXM (dense), FLOP/s
F32_PEAK, TF32_PEAK, BF16_PEAK = 67e12, 495e12, 989e12
#: its device memory rate, bytes/s
HBM_BW = 3.35e12
#: the mLSTM shapes: (B, H, S, Dq, Dv, chunk)
REDUCED = (2, 4, 300, 32, 32, 256)
TRAIN = (4, 4, 1024, 512, 512, 256)
#: passes of the profiler over each time
RUNS = 3
#: the sources timed, by their launchers
SOURCES = {"mlstm_chunk": mk.ROUTES["simt"][1:],
           "mlstm_chunk_bwd": mk.BWD_ROUTES["simt"][1:],
           "flash_attention": fa.ROUTES["simt"][1:]}


def mlstm_flops(B, H, S, Dq, Dv, chunk):
    """The forward's float ops: per chunk of l positions q C and the C
    update (2 l Dq Dv each), and the causal half of q k^T and W v."""
    total = 0
    for c0 in range(0, S, chunk):
        ln = min(chunk, S - c0)
        total += 4 * ln * Dq * Dv + ln * (ln + 1) * (Dq + Dv)
    return B * H * total


def mlstm_bwd_flops(B, H, S, Dq, Dv, chunk):
    """The gradient's float ops (as ``chip_smoke.mlstm_bwd_flops``): per
    chunk the causal pairs' five products and the state terms."""
    total, nC = 0, -(-S // chunk)
    for c in range(nC):
        ln = min(chunk, S - c * chunk)
        total += ln * (ln + 1) * (3 * Dq + 2 * Dv)
        total += ((c + 1 < nC) * 3 + (c > 0) * 2) * 2 * ln * Dq * Dv
    return B * H * total


def bound(nbytes, flops, bw, rate):
    """(ms, "bytes" | "operations"): the larger of the two times."""
    b_ms, o_ms = nbytes / bw * 1e3, flops / rate * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def f32_bound(nbytes, flops):
    """The bound of float32 work on the three-term TF32 split: (ms, "bytes"
    | "operations", the float32 CUDA-core figure in ms)."""
    b_ms, by = bound(nbytes, 3 * flops, HBM_BW, TF32_PEAK)
    return b_ms, by, flops / F32_PEAK * 1e3


def parent_module(parent: Path, name: str):
    """DIR's kernels/`name`.py, loaded beside this tree's module of that
    name (its relative imports resolve to this tree's modules)."""
    path = parent / "src" / "repro_torch" / "kernels" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}._parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_parent(parent: Path, out_dir: Path) -> dict:
    """DIR's copies of SOURCES (with its csrc/ headers) built into
    `out_dir`: {source: ctypes launcher}; the backward bound by DIR's own
    ``BWD_ARGTYPES``, with DIR's ``bwd_launch_args`` as its
    ``launch_args``."""
    csrc = parent / "src" / "repro_torch" / "kernels" / "csrc"
    for header in csrc.glob("*.cuh"):
        shutil.copy(header, out_dir / header.name)
    procs = {}
    for name in SOURCES:
        cu = out_dir / f"{name}.cu"
        shutil.copy(csrc / f"{name}.cu", cu)
        so = out_dir / f"lib{name}-parent.so"
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(out_dir),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the parent's {name}.cu:\n"
                               f"{log}")
        symbol, argtypes = SOURCES[name]
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        if name == "mlstm_chunk_bwd":
            pmk = parent_module(parent, "mlstm_chunk")
            argtypes, fn.launch_args = pmk.BWD_ARGTYPES, pmk.bwd_launch_args
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def device_ms(launch, reps, runs):
    """The profiler's device ms per launch, one per pass."""
    return [mcc.device_times(launch, reps=reps, cold_reps=2)["device_ms"]
            for _ in range(runs)]


def by_kernel(launch, reps=50):
    """Device µs per launch of each kernel that one launch runs, by name
    (the profiler's; the demangled name cut at its template arguments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    s = torch.cuda.current_stream().cuda_stream
    _build.check(launch(s), "timed launch")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch(s)
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name().replace("(anonymous namespace)::", "")
            name = name.split("<")[0].split("(")[0].split()[-1]
            out[name] = out.get(name, 0.0) + e.duration_ns() / reps / 1e3
    return out


def turns(variants, launch_of, reps, runs):
    """{variant: [device ms, ...]}: with a parent, in turns P, C, C, P."""
    order = ["parent", "this", "this", "parent"] if "parent" in variants \
        else ["this"]
    out = {v: [] for v in variants}
    for v in order:
        out[v] += device_ms(launch_of(variants[v]), reps, runs)
    out["this_by_kernel_us"] = by_kernel(launch_of(variants["this"]),
                                         min(reps, 50))
    return out


def sdpa(q, k, v, mask, reps):
    """F.scaled_dot_product_attention with the boolean mask: CUDA-event ms
    per call and the device kernels one call runs (the backend it
    picked).  A yardstick only: the port never calls it."""
    from torch.profiler import ProfilerActivity, profile
    f = torch.nn.functional.scaled_dot_product_attention
    f(q, k, v, attn_mask=mask)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        f(q, k, v, attn_mask=mask)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type.name == "CUDA"})
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        f(q, k, v, attn_mask=mask)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, names


def time_8b(variants, gen, shape, reps, runs):
    """The simt forward at `shape`, float32."""
    B, H, S, Dq, Dv, L = shape
    (q, k, v, lf, li), _ = mc.mlstm_inputs(gen, B, H, S, Dq, Dv,
                                           torch.float32)
    a, _, keep = mk.launch_args(q, k, v, lf, li, L, None)
    # the last scratch (the chunk-start states; an earlier source's
    # masked scores, (B H nC, L, L) rounded to 64) large enough for both
    nC, Lp = -(-S // L), -(-L // 64) * 64
    work = torch.empty(B * H * nC * max(Dq * Dv + Dq, Lp * Lp),
                       device="cuda")
    a = a[:16] + (work.data_ptr(),) + a[17:]
    t = turns(variants, lambda fn: lambda s: fn(*a[:-1], s), reps, runs)
    flops = mlstm_flops(*shape)
    nbytes = 4 * B * H * S * (2 * Dq + 2 * Dv) + 8 * B * H * S + \
        4 * B * H * (Dq * Dv + Dq + 1)
    b_ms, by, core_ms = f32_bound(nbytes, flops)
    del keep
    return {"source": "mlstm_chunk", "row": "8b", "shape": list(shape),
            "dtype": "float32", "device_ms": t, "flops": flops,
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": by,
            "f32_cuda_core_bound_ms": core_ms}


def time_13b(variants, gen, shape, reps, runs):
    """The simt backward at `shape`, float32, each variant on the
    arguments its own tree's ``bwd_launch_args`` lays out."""
    B, H, S, Dq, Dv, L = shape
    ins = mc.mlstm_bwd_inputs(gen, B, H, S, Dq, Dv, torch.float32, "gates")
    keep = []

    def launch_of(fn):
        a, _, held = fn.launch_args(*ins, L)
        keep.append(held)
        return lambda s: fn(*a[:-1], s)

    t = turns(variants, launch_of, reps, runs)
    flops = mlstm_bwd_flops(*shape)
    nbytes = 4 * B * H * S * (4 * Dq + 3 * Dv) + 16 * B * H * S
    b_ms, by, core_ms = f32_bound(nbytes, flops)
    del ins, keep
    return {"source": "mlstm_chunk_bwd", "row": "13b", "shape": list(shape),
            "dtype": "float32", "device_ms": t, "flops": flops,
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": by,
            "f32_cuda_core_bound_ms": core_ms}


def time_10b(variants, gen, case, runs):
    """flash_attention.cu at one of ``flash_check.SIMT_CASES``, beside
    SDPA with the same boolean mask."""
    name, dtype, D, S, window, q_scale = case
    B, H = fc.SHAPE["B"], fc.SHAPE["H"]
    q, k, v = fc.flash_inputs(gen, B, H, S, D, dtype, q_scale)
    o = torch.empty_like(q)
    scale = 1.0 / math.sqrt(D)
    ptrs = [x.data_ptr() for x in (q, k, v, o)]
    bf16 = int(dtype == torch.bfloat16)
    reps = 5 if dtype == torch.float32 else 20
    t = turns(variants, lambda fn: lambda s: fn(
        *ptrs, B * H, S, S, D, D, scale, 1, window, bf16, s), reps, runs)
    mask = fa.attention_mask(S, S, causal=True, window=window,
                             device=q.device)
    pairs = int(mask.sum().item()) * B * H
    flops = 4 * D * pairs
    nbytes = 4 * q.element_size() * B * H * S * D
    # float32: three TF32 products for q k^T and for p v (the bound); bf16:
    # the function at the bf16 peak, and the split's mix (one product for
    # q k^T and two for p v) beside it
    f32 = dtype == torch.float32
    if f32:
        b_ms, by, core_ms = f32_bound(nbytes, flops)
    else:
        b_ms, by = bound(nbytes, flops, HBM_BW, BF16_PEAK)
        core_ms = None
    mix_ms = (3 * flops / TF32_PEAK if f32 else
              6 * D * pairs / BF16_PEAK) * 1e3
    sdpa_ms, sdpa_kernels = sdpa(q, k, v, mask, reps)
    return {"source": "flash_attention", "row": "10b", "case": name,
            "shape": [B, H, S, D], "dtype": str(dtype), "window": window,
            "device_ms": t, "pairs": pairs, "flops": flops,
            "bytes": nbytes, "bound_ms": b_ms, "bound_by": by,
            "split_mix_ms": mix_ms, "f32_cuda_core_bound_ms": core_ms,
            "sdpa_ms": sdpa_ms,
            "sdpa_kernels": sdpa_kernels}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("f32_times: needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.build(tuple(SOURCES))
    variants = {name: {"this": _build.function(name, *SOURCES[name])}
                for name in SOURCES}
    variants["mlstm_chunk_bwd"]["this"].launch_args = mk.bwd_launch_args
    tmp = tempfile.TemporaryDirectory()
    if args.parent is not None:
        for name, fn in build_parent(args.parent, Path(tmp.name)).items():
            variants[name]["parent"] = fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(32)

    def emit(obj):
        print(json.dumps({**obj, "gpu": smi}), flush=True)

    for shape, reps in ((REDUCED, 200), (TRAIN, 10)):
        emit(time_8b(variants["mlstm_chunk"], gen, shape, reps, RUNS))
    for shape, reps in ((REDUCED, 200), (TRAIN, 5)):
        emit(time_13b(variants["mlstm_chunk_bwd"], gen, shape, reps, RUNS))
    for case in fc.SIMT_CASES:
        emit(time_10b(variants["flash_attention"], gen, case, RUNS))
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
