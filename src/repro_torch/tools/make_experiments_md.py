"""Write an EXPERIMENTS document from the port's dry-run records.

    python -m repro_torch.tools.make_experiments_md OUT.md [--results DIR]

The port's counterpart of ``benchmarks/make_experiments_md.py``: a
hardware header for one NVIDIA H100 and its peaks, the roofline table of
every single-pod cell of ``DIR`` (``tools/roofline.py``; the dry run's
records, ``results/dryrun_torch`` by default) with a one-line note per
cell, and the Monte Carlo step's traffic in both layouts.  The
reference's §Repro validation tables and its TPU hill-climb log are
results of the reference, not of the port, and are not carried over.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import roofline as rl

HEADER = f"""# EXPERIMENTS (PyTorch/CUDA port)

Every number below is generated by the repository
(`python -m repro_torch.tools.make_experiments_md`) from the port's dry
run (`python -m repro_torch.launch.dryrun --all`) and from shapes alone:
none is a measurement on a card.  Hardware model: {rl.CARD}: dense bf16
{rl.PEAK_FLOPS / 1e12:.0f} TFLOP/s, {rl.HBM_BW / 1e12:.2f} TB/s HBM,
NVLink 4 at {rl.LINK_BW / 1e9:.0f} GB/s each way; single pod = (data=16,
model=16) = 256 ranks, multi-pod = (pod=2, data=16, model=16) = 512.
The dry run's flops and bytes are an eager, unfused count of one rank's
step on meta tensors (`launch/op_analysis.py`), so the memory term is an
upper bound and `useful` (MODEL_FLOPS / (flops x ranks)) the sturdier
figure.

"""


def roofline_section(results_dir=rl.RESULTS_DIR) -> str:
    rows = rl.load_cells(results_dir)
    out = ["## Roofline — single pod (16x16 = 256 ranks)\n",
           "Terms in seconds per step per rank; `useful` = MODEL_FLOPS / "
           "(flops x ranks); `frac` = compute term / max(term); args GB = "
           "a rank's params, grads, optimizer state, batch and decode "
           "state (80 GB a card).\n",
           "| arch | shape | compute s | memory s | collective s | dominant "
           "| useful | frac | args GB | fits 80GB |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r["status"] != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                       f"{r['status']} | — | — | — | — |")
            continue
        fits = "yes" if r["args_gb"] <= 80 else f"no ({r['args_gb']:.0f})"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3f} | "
            f"{r['memory_s']:.3f} | {r['collective_s']:.4f} | "
            f"{r['dominant']} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} | {r['args_gb']:.1f} | {fits} |")
    ok = [r for r in rows if r["status"] == "ok"]
    dom = {}
    for r in ok:
        dom[r["dominant"]] = dom.get(r["dominant"], 0) + 1
    out.append("")
    out.append(f"Summary: {len(ok)} traced cells of {len(rows)}; "
               f"dominance: {dom}.  Per cell:\n")
    notes = {"memory": "keep score and chunk tensors on chip (the flash "
                       "and chunkwise kernels) and fuse the eager passes",
             "collective": "overlap the weight gathers and all-reduces "
                           "with compute (NCCL on streams of their own)",
             "compute": "raise each rank's arithmetic intensity (larger "
                        "microbatches) or shard what is replicated"}
    for r in ok:
        out.append(f"* {r['arch']} x {r['shape']}: dominant={r['dominant']}"
                   f" -> {notes[r['dominant']]}.")
    return "\n".join(out) + "\n"


def mc_step_section() -> str:
    out = ["## Monte Carlo step traffic\n",
           "Bytes one step's eval moves (`kernels/ops.step_hbm_bytes`), "
           "unpacked bool tiles against packed words, and the time each "
           f"takes at {rl.HBM_BW / 1e12:.2f} TB/s.\n",
           "| cell | kernel | B x P x n | unpacked bytes | packed bytes | "
           "ratio | unpacked s | packed s |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rl.mc_step_rows():
        out.append(f"| {r['label']} | {r['kernel']} | {r['B']} x {r['P']} "
                   f"x {r['n']} | {r['unfused_bytes']} | {r['fused_bytes']} "
                   f"| {r['ratio']:.1f} | {r['unfused_memory_s']:.3e} | "
                   f"{r['fused_memory_s']:.3e} |")
    return "\n".join(out) + "\n"


def render(results_dir=rl.RESULTS_DIR) -> str:
    return HEADER + roofline_section(results_dir) + "\n" + mc_step_section()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="where to write the document")
    ap.add_argument("--results", default=str(rl.RESULTS_DIR),
                    help="the dry run's records")
    args = ap.parse_args(argv)
    Path(args.out).write_text(render(args.results))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
