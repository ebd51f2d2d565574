"""Where a train step's time goes on the card, and how far rounding alone
moves the step-0 gradient.

    PYTHONPATH=src python -m repro_torch.profile_train \\
        [--arch xlstm_350m] [--layers N] [--batch 4] [--seq 1024] \\
        [--microbatches M] [--conditioning]

Builds the config at full width (depth cut to --layers when given, the
train launcher's microbatches otherwise the config's), draws seed-0
weights on the card and runs ``make_train_step`` (AdamW, remat as
configured) on ``SyntheticLMData`` under torch's deterministic algorithms,
as ``chip_smoke.py``'s train phases do: one warm-up step, one step timed
on the host clock, and one under ``torch.profiler`` (the CUDA activity
alone; the device's events are read from the trace, since building the
profiler's own events takes about a minute at the 330,000 launches of an
xlstm step), printing the device busy time, the idle share (1 - busy /
that step's wall), the top kernels by device time and the cells'
kernels' shares.

With ``--conditioning`` it then takes step 0's gradient three ways: the
kernels; the plain forward and backward (float32 sums); and the plain
versions with float64 sums (their float32 casts made float64, the
outputs in the same dtypes).  Per gradient leaf it prints |kernels - f64|
/ |f64| and |plain - f64| / |f64|, and their medians: how far rounding
alone moves a leaf of this model's gradient.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch

from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import mlstm_chunk as mk
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rk
from repro_torch.models import build_model
from repro_torch.training import accumulate_grads, make_train_step

#: kernel names of the cells' kernels, for their shares
CELL_KERNELS = {"mlstm_chunkwise_bwd": ("bwd_fstates", "bwd_rows",
                                        "bwd_dstates", "bwd_cols"),
                "mlstm_chunkwise_bwd_sm90": ("bwd90_",),
                "mlstm_chunkwise_sm90": ("mlstm_gates_kernel",
                                         "mlstm_states_kernel",
                                         "mlstm_output_kernel"),
                "rglru_scan_bwd": ("rglru_scan_bwd_kernel",),
                "rglru_scan": ("rglru_scan_kernel",)}


def profile_step(step_once, top: int = 15) -> dict:
    """One call of `step_once` under the profiler's CUDA activity: wall,
    device busy, idle share, top kernels, the cells' shares, and the
    seconds the profiler took to stop and hand over its trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_once()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # the device's events straight from the trace: building the
    # profiler's own events (``key_averages``) takes about a minute at an
    # xlstm step's 330,000 launches
    per = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or \
                e.name().startswith("block:"):
            continue
        us, count = per.get(e.name(), (0.0, 0))
        per[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    rows = [(us, count, key) for key, (us, count) in per.items()]
    busy = sum(t for t, _, _ in rows)
    shares = {}
    for name, keys in CELL_KERNELS.items():
        t = sum(us for us, _, k in rows if any(x in k for x in keys) and
                not (name == "rglru_scan" and "bwd" in k))
        if t:
            shares[name] = t / busy
    rows.sort(reverse=True)
    return {"wall_s": wall, "device_busy_s": busy / 1e6,
            "idle_share": 1 - busy / 1e6 / wall, "cell_shares": shares,
            "trace_s": time.monotonic() - t0 - wall,
            "top": [{"kernel": k[:100], "ms": t / 1e3, "count": c}
                    for t, c, k in rows[:top]]}


class plain_cells:
    """Within: the model's mLSTM and RG-LRU cells call the plain forward
    and backward (``*_reference``) on the card, as a check; with `f64`
    the plain versions sum in float64 (their float32 casts made float64,
    the outputs in the same dtypes)."""

    def __init__(self, f64: bool = False):
        self.f64 = f64

    def __enter__(self):
        self.saved = (ops.mlstm_chunkwise, ops.rglru_scan, mk._f32,
                      mk.mlstm_chunkwise_bwd_plain, rk.rglru_scan_bwd_plain,
                      rk._work_dtype)
        ops.mlstm_chunkwise = mk.mlstm_chunkwise_reference
        ops.rglru_scan = rk.rglru_scan_reference
        if not self.f64:
            return self
        bwd_m, bwd_r = self.saved[3], self.saved[4]

        def mlstm_bwd64(q, k, v, lf, li, dh, *, chunk=256):
            out = bwd_m(*(t.double() for t in (q, k, v, lf, li, dh)),
                        chunk=chunk)
            return tuple(o.to(t.dtype) for o, t in zip(out, (q, k, v, lf,
                                                             li)))

        def rglru_bwd64(x, la, h, dh):
            return tuple(o.float() for o in bwd_r(x.double(), la.double(),
                                                  h.double(), dh.double()))

        # the plain versions count their calls through these names
        mlstm_bwd64.calls = rglru_bwd64.calls = 0
        mk._f32 = lambda *xs: tuple(x.double() for x in xs)
        mk.mlstm_chunkwise_bwd_plain = mlstm_bwd64
        rk.rglru_scan_bwd_plain = rglru_bwd64
        rk._work_dtype = lambda *xs: torch.float64
        return self

    def __exit__(self, *exc):
        (ops.mlstm_chunkwise, ops.rglru_scan, mk._f32,
         mk.mlstm_chunkwise_bwd_plain, rk.rglru_scan_bwd_plain,
         rk._work_dtype) = self.saved


def leaf_distances(kernels, plain, f64) -> list:
    """Per gradient leaf, float32 norms: |f64|, |kernels - f64| / |f64|,
    |plain - f64| / |f64|, |plain| and |kernels - plain|."""
    rows = []
    for (path, a), b, w in zip(tree.leaves_with_paths(kernels),
                               tree.leaves(plain), tree.leaves(f64)):
        a, b, w = a.float(), b.float(), w.float()
        n = w.norm().item()
        rows.append({"leaf": tree.path_name(path), "norm": n,
                     "kernels_vs_f64": (a - w).norm().item() / max(n, 1e-30),
                     "plain_vs_f64": (b - w).norm().item() / max(n, 1e-30),
                     "plain_norm": b.norm().item(),
                     "kernels_vs_plain": (a - b).norm().item()})
    return rows


def conditioning(model, params, batch, nmb: int) -> dict:
    """Step 0's gradient with the kernels, the plain versions (float32
    sums) and the plain versions with float64 sums; per leaf the relative
    distance of the first two from the third."""
    def grads():
        return accumulate_grads(model["loss_fn"], params, batch, nmb)

    lk, gk = grads()
    with plain_cells():
        lp, gp = grads()
    with plain_cells(f64=True):
        l64, g64 = grads()
    leaves = leaf_distances(gk, gp, g64)
    return {"loss": {"kernels": lk.item(), "plain": lp.item(),
                     "plain_f64": l64.item()},
            "median_kernels_vs_f64": statistics.median(
                r["kernels_vs_f64"] for r in leaves),
            "median_plain_vs_f64": statistics.median(
                r["plain_vs_f64"] for r in leaves),
            "leaves": sorted(leaves, key=lambda r: -r["plain_vs_f64"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="xlstm_350m")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--conditioning", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: needs an NVIDIA card")
        return 2
    # cuBLAS's deterministic workspace, read when cuBLAS starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    full = get_config(args.arch)
    cfg = full.replace(num_layers=args.layers or full.num_layers,
                       microbatches_train=args.microbatches or
                       full.microbatches_train)
    init_fn, step_fn, _ = make_train_step(cfg, peak_lr=1e-3)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params, opt = init_fn(gen)
    batch = {k: torch.from_numpy(v).cuda() for k, v in
             SyntheticLMData(cfg, args.batch, args.seq).batch_at(0).items()}
    step_fn(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    step_fn(params, opt, batch)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    out = {"gpu": torch.cuda.get_device_name(0), "arch": args.arch,
           "layers": cfg.num_layers, "batch": args.batch, "seq": args.seq,
           "microbatches": cfg.microbatches_train, "step_s": wall,
           "tokens_per_s": args.batch * args.seq / wall,
           "profiled": profile_step(lambda: step_fn(params, opt, batch))}
    print(json.dumps(out), flush=True)
    if args.conditioning:
        nmb = max(1, cfg.microbatches_train)
        print(json.dumps(conditioning(build_model(cfg), params, batch, nmb)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
