"""Roofline terms of the port's dry run on one NVIDIA H100, and the Monte
Carlo step's traffic in both layouts.

    python -m repro_torch.tools.roofline [--results DIR] [--mesh MESH]

Per (arch x shape) cell of ``python -m repro_torch.launch.dryrun``'s
records (``results/dryrun_torch/<arch>__<shape>__<mesh>.json`` by
default; ``results/`` is git-ignored, so the directory is an argument):

  compute_term    = flops_per_rank / PEAK_FLOPS       (989 TFLOP/s bf16)
  memory_term     = bytes_per_rank / HBM_BW           (3.35 TB/s)
  collective_term = collective_bytes_per_rank / LINK_BW
                                        (NVLink 4: 450 GB/s each way)

with MODEL_FLOPS = 6·N·D (train; 2·N·D prefill, 2·N per decoded row,
N the active parameters) and the useful ratio MODEL_FLOPS / (flops ·
ranks).  The peaks are those of ``CARD`` (NVIDIA's data sheet, SXM part
at its 700 W limit; ``PERF.md`` §6 uses the same).  The dry run's flops
and bytes are an eager, unfused count of one rank's step on meta
tensors (``launch/op_analysis.py``), host arithmetic on shapes: these
terms are a model, not a measurement.  ``args_gb`` is the bytes of a
rank's arguments (params, grads, optimizer state, batch, decode state);
the eager step's temporaries are not counted.

The ``roofline_mc_step`` rows take the Monte Carlo step's bytes in the
unpacked and the packed layout (``kernels/ops.step_hbm_bytes``) over the
sweep grid and the memory-roofline seconds each implies; the packed step
must move no more bytes than the unpacked one on every grid cell, and
the tool fails if it does.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.tools import option_strings, parse

#: the card the peaks are for, with the power limit they assume
CARD = "NVIDIA H100 SXM 80GB, 700 W"
PEAK_FLOPS = 989e12        # dense bf16, tensor cores
HBM_BW = 3.35e12           # bytes/s
LINK_BW = 450e9            # NVLink 4 to the host's other cards, each way
CHIPS = {"pod16x16": 256, "pod2x16x16": 512}

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"


def active_params(cfg: ModelConfig) -> float:
    """~Active parameters per token (MoE counts top-k experts only) — the
    reference roofline's estimate, term for term."""
    d, L, ff, V = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.vocab_size
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    glu = 3 if cfg.mlp in ("swiglu", "gelu_glu") else 2
    per_layer = 0.0
    for kind in (cfg.block_pattern * (L // len(cfg.block_pattern) + 1))[:L]:
        if kind in ("attn", "local"):
            if cfg.mla is not None:
                m = cfg.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                per_layer += (d * m.q_lora_rank + m.q_lora_rank * h * qk
                              + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                              + m.kv_lora_rank * h * (m.qk_nope_head_dim
                                                      + m.v_head_dim)
                              + h * m.v_head_dim * d)
            else:
                per_layer += d * h * dh + 2 * d * kv * dh + h * dh * d
            if cfg.moe is not None:
                per_layer += cfg.moe.experts_per_token * glu * d * ff
            elif ff:
                per_layer += glu * d * ff
        elif kind == "mlstm":
            inner = int(cfg.proj_factor * d)
            per_layer += 2 * d * inner + 3 * inner * inner + inner * d
        elif kind == "slstm":
            per_layer += 4 * d * d + int(4 * d / 3) * d * 3
        elif kind == "rglru":
            w = cfg.lru_width
            per_layer += 2 * d * w + 2 * w * w + w * d + glu * d * ff
    emb = V * d * (1 if cfg.tie_embeddings else 2)
    if cfg.is_encoder_decoder:
        per_layer *= 2  # encoder + cross-attention, roughly
    return per_layer + emb


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    n_act = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_act * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * shape.tokens
    return 2.0 * n_act * shape.global_batch  # decode: one token per row


def cell_row(rec: dict) -> Dict:
    """One record's roofline row (``status`` other than "ok" when the cell
    was skipped or its step not traced)."""
    row = {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"]}
    if rec["status"] != "ok":
        return {**row, "status": rec["status"]}
    ops = rec.get("op_analysis", {"status": "not traced"})
    if ops["status"] != "ok":
        return {**row, "status": ops["status"]}
    compute_s = ops["flops"] / PEAK_FLOPS
    memory_s = ops["bytes"] / HBM_BW
    coll_s = ops["collective_bytes_total"] / LINK_BW
    dom = max((compute_s, "compute"), (memory_s, "memory"),
              (coll_s, "collective"))[1]
    mf = model_flops(get_config(rec["arch"]), SHAPES_BY_NAME[rec["shape"]])
    return {**row, "status": "ok", "compute_s": compute_s,
            "memory_s": memory_s, "collective_s": coll_s, "dominant": dom,
            "model_flops": mf,
            "useful_ratio": mf / max(ops["flops"] * CHIPS[rec["mesh"]], 1),
            "roofline_fraction": compute_s / max(compute_s, memory_s,
                                                 coll_s),
            "args_gb": sum(rec.get("per_device_bytes", {}).values()) / 1e9,
            "collectives": ops["collectives"]}


def load_cells(results_dir=RESULTS_DIR, mesh: str = "pod16x16") -> List[Dict]:
    """A row per (arch, shape) whose record `results_dir` holds."""
    rows = []
    for arch in ARCH_IDS:
        for shape_name in SHAPES_BY_NAME:
            f = Path(results_dir) / f"{arch}__{shape_name}__{mesh}.json"
            if f.exists():
                rows.append(cell_row(json.loads(f.read_text())))
    return rows


#: Monte Carlo step grid: (label, metric, rebuild_model, B, P, n) — the
#: sweep's reduced and full scales and a million-trial target, as the
#: reference's
MC_STEP_GRID = (
    ("reduced_avail", "availability", "fixed", 8, 512, 63),
    ("full_avail", "availability", "fixed", 8, 4096, 155),
    ("full_downtime", "downtime", "fixed", 8, 4096, 155),
    ("full_reconfig", "downtime", "reconfig", 8, 4096, 155),
    ("mega_reconfig", "downtime", "reconfig", 1024, 4096, 155),
)


def mc_step_rows() -> List[Dict]:
    """The unpacked and packed bytes of one Monte Carlo step per grid cell,
    with the memory-roofline time each implies; raises if the packed step
    moves more bytes than the unpacked one anywhere."""
    from repro_torch.kernels.ops import StepSpec, step_hbm_bytes
    rows = []
    for label, metric, model, B, P, n in MC_STEP_GRID:
        spec = StepSpec(metric=metric, rf=3, n_real=n, rebuild_model=model,
                        packed=True)
        hbm = step_hbm_bytes(spec, B, P, n)
        assert hbm["fused_bytes"] <= hbm["unfused_bytes"], \
            f"the packed step moves more bytes than the unpacked on {label}"
        rows.append({
            "label": label, "kernel": spec.fused_kernel, "B": B, "P": P,
            "n": n, "unfused_bytes": hbm["unfused_bytes"],
            "fused_bytes": hbm["fused_bytes"], "ratio": hbm["ratio"],
            "unfused_memory_s": hbm["unfused_bytes"] / HBM_BW,
            "fused_memory_s": hbm["fused_bytes"] / HBM_BW,
        })
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.roofline",
                                 description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--results", default=str(RESULTS_DIR),
                    help="the dry run's records (default "
                         "results/dryrun_torch)")
    ap.add_argument("--mesh", default="pod16x16", choices=sorted(CHIPS))
    return ap


def cli_options() -> tuple:
    return option_strings(build_parser())


def main(argv=None, *, strict: bool = True) -> int:
    args = parse(build_parser(), argv, strict)
    print(f"roofline_card,{args.mesh},0,card={CARD};"
          f"peak_flops={PEAK_FLOPS:.3g};hbm_bw={HBM_BW:.3g};"
          f"link_bw={LINK_BW:.3g}")
    for r in load_cells(args.results, args.mesh):
        if r["status"] != "ok":
            print(f"roofline,{r['arch']}__{r['shape']},0,"
                  f"status={r['status']}")
            continue
        print(f"roofline,{r['arch']}__{r['shape']},0,"
              f"compute_s={r['compute_s']:.4f};memory_s={r['memory_s']:.4f};"
              f"collective_s={r['collective_s']:.4f};dominant={r['dominant']};"
              f"useful={r['useful_ratio']:.3f};"
              f"frac={r['roofline_fraction']:.3f};argsGB={r['args_gb']:.1f}")
    for r in mc_step_rows():
        print(f"roofline_mc_step,{r['label']},0,"
              f"kernel={r['kernel']};b{r['B']}p{r['P']}n{r['n']};"
              f"unfused_bytes={r['unfused_bytes']};"
              f"fused_bytes={r['fused_bytes']};ratio={r['ratio']:.1f};"
              f"unfused_memory_s={r['unfused_memory_s']:.3e};"
              f"fused_memory_s={r['fused_memory_s']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
