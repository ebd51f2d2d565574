"""Re-trace one dry-run cell under config and sharding variants (the
port's counterpart of ``benchmarks/perf_probe.py``).

    python -m repro_torch.tools.perf_probe --arch smollm_360m \\
        --shape train_4k --variant baseline --variant no_zero_grads \\
        --variant nmb2 [--multipod]

Each variant runs ``launch/dryrun.run_cell`` on a fake process group of
512 ranks (``dryrun.fake_world``) and prints one line:

  PROBE <arch> <shape> <variant>: peak=not measured flops=... bytes=...
        coll=... microbatches=<k>x<rows> trace=...s total=...s

with ``op_analysis``'s flops, bytes and collective bytes of one rank's
step (host arithmetic on meta tensors; see ``launch/op_analysis.py``),
the microbatches the step cut a rank's rows into (train cells), and the
trace's seconds.  The peak is not measured: a meta-tensor trace has no
allocator.  The variants, as the reference's:

* ``baseline`` — the cell as configured;
* ``no_fsdp`` — ``param_shardings(..., fsdp=False)``;
* ``no_zero_grads`` — ``grad_shardings`` gives None: the gradients keep
  the parameters' placement, all-reduced over the batch axes;
* ``nmbN`` — ``microbatches_train=N``;
* ``rgN`` — ``remat_group=N``;
* ``no_remat`` — ``remat=False``.

The sharding variants replace the names ``launch/dryrun.py`` calls, and
each variant starts from the names as they were.  Nothing runs on a
device: the dry run traces on the host.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

import torch

from repro_torch.launch import dryrun

VARIANTS = ("baseline", "no_fsdp", "no_zero_grads", "nmbN", "rgN",
            "no_remat")


def _overrides(name: str) -> dict:
    """The config fields a variant replaces."""
    if name.startswith("nmb"):
        return {"microbatches_train": int(name[3:])}
    if name.startswith("rg"):
        return {"remat_group": int(name[2:])}
    if name == "no_remat":
        return {"remat": False}
    if name in ("baseline", "no_fsdp", "no_zero_grads"):
        return {}
    raise ValueError(f"unknown variant {name!r}; expected one of "
                     f"{', '.join(VARIANTS)}")


@contextlib.contextmanager
def variant(name: str):
    """Apply a variant for the length of the block: yields the config
    overrides, with dryrun's sharding functions replaced as the variant
    says and put back after."""
    overrides = _overrides(name)
    saved = dryrun.param_shardings, dryrun.grad_shardings
    base_params = saved[0]
    if name == "no_fsdp":
        dryrun.param_shardings = \
            lambda cfg, mesh, tree, fsdp=None: base_params(cfg, mesh, tree,
                                                           fsdp=False)
    elif name == "no_zero_grads":
        dryrun.grad_shardings = lambda cfg, mesh, tree: None
    try:
        yield overrides
    finally:
        dryrun.param_shardings, dryrun.grad_shardings = saved


def probe(arch: str, shape: str, name: str, multi_pod: bool = False) -> dict:
    """One variant's dry-run record (the fake group must be up)."""
    with variant(name) as overrides:
        return dryrun.run_cell(arch, shape, multi_pod, overrides=overrides)


def line(arch: str, shape: str, name: str, rec: dict, total_s: float) -> str:
    """The probe's line for one variant's record."""
    head = f"PROBE {arch} {shape} {name}:"
    if rec["status"] != "ok":
        return f"{head} {rec['status']} {rec.get('reason', '')}".rstrip()
    op = rec["op_analysis"]
    if op["status"] != "ok":
        return f"{head} ERROR {op['reason']} at {op['op']}"
    mb = rec.get("microbatches")
    split = f" microbatches={mb['traced']}x{mb['traced_rows']}" if mb else ""
    return (f"{head} peak=not measured flops={op['flops']:.3e} "
            f"bytes={op['bytes']:.3e} "
            f"coll={op['collective_bytes_total']:.3e}{split} "
            f"trace={op['trace_s']:.1f}s total={total_s:.0f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.perf_probe",
                                 description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", action="append", default=[],
                    help=f"one of {', '.join(VARIANTS)} (repeatable; "
                         "default baseline)")
    ap.add_argument("--multipod", action="store_true")
    args = ap.parse_args(argv)
    names = args.variant or ["baseline"]
    for name in names:
        _overrides(name)                 # a bad name fails before tracing
    failed = 0
    dryrun.fake_world(512)
    try:
        for name in names:
            t0 = time.monotonic()
            try:
                rec = probe(args.arch, args.shape, name, args.multipod)
                text = line(args.arch, args.shape, name, rec,
                            time.monotonic() - t0)
            except Exception as e:       # reported per variant
                text = f"PROBE {args.arch} {args.shape} {name}: ERROR {e!r}"
            failed += " ERROR " in text
            print(text, flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
