"""Where the time of csrc/mlstm_chunk_sm90.cu goes: each of its kernels
timed alone at the xlstm-350m serve shape, on the source and on copies
with one part of the work taken out.

    PYTHONPATH=src python -m repro_torch.kernels.mlstm_ablate

builds the copies (``ABLATIONS``: each a list of (text, replacement),
every text once in the source) beside the source, launches each once at
the serve shape (B = 4, H = 4, S = 1024, Dq = Dv = 512, chunk 256, bf16),
then times each of its kernels alone (``mlstm_chunk.PARTS``, CUDA events,
back to back, on the scratch the full launch left) and prints one JSON
line per copy, the card's name and power limit first.  With the
tensor-core products taken out a kernel still loads every tile, so the
copies without them time the loads alone.  The copies compute wrong
outputs: they are for timing only.  Needs nvcc and a card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import mlstm_check as mc
from . import mlstm_chunk as mk

_NO_KEYS = ("const int ntiles = (rows_end - 1) / 64 + 1;",
            "const int ntiles = 0;")
_NO_CARRY_WGMMA = (
    "sm90::wgmma_m64k16_ss_tb<NV>(acc, dq + kk * 2, dc + kk * 128);", "")
#: the copies: {name: [(text, replacement), ...]}
ABLATIONS = {
    # the states kernel without its stores of C_c hi and lo
    "no_chunk_state_stores": [("if (c > 0 || has_init) {", "if (false) {")],
    # ... without its wgmma (and the conversions that feed them): the
    # slab loads, the ldmatrix reads and n alone
    "states_no_wgmma": [
        ("sm90::wgmma_m64k16_rs_tb<NV>(acc, khi_r + 4 * kk, dv + kk * 128);",
         ""),
        ("sm90::wgmma_m64k16_rs_tb<NV>(acc, klo_r + 4 * kk, dv + kk * 128);",
         "")],
    # the output kernel without q C_c (no C_c items)
    "output_no_carry": [("const int nCi = carry ? 2 * DP : 0;",
                         "const int nCi = 0;")],
    # the output kernel with q C_c alone (no key tiles)
    "output_carry_only": [_NO_KEYS],
    # ... and without its wgmma: the C_c and q loads alone
    "output_carry_loads_only": [_NO_KEYS, _NO_CARRY_WGMMA],
}
SHAPE = (4, 4, 1024, 512, 512, 256)


def build(out_dir: Path) -> dict:
    """Compile the source and each copy, all at once, into `out_dir`;
    returns {name: ctypes launcher} ("source" unchanged)."""
    src = (_build.CSRC / "mlstm_chunk_sm90.cu").read_text()
    procs = {}
    for name, pairs in {"source": [], **ABLATIONS}.items():
        text = src
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} occurs "
                                   f"{text.count(old)} times")
            text = text.replace(old, new)
        cu = out_dir / f"mlstm_chunk_sm90-{name}.cu"
        cu.write_text(text)
        so = out_dir / f"libmlstm_chunk_sm90-{name}.so"
        procs[name] = (_build._nvcc(so, cu), so)
    return _build.finish_variants(procs, *mk.ROUTES["sm90"][1:])


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


def main() -> int:
    if not torch.cuda.is_available():
        print("mlstm_ablate: needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out_dir = _build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = build(out_dir)
    B, H, S, Dq, Dv, L = SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    args, _ = mc.mlstm_inputs(gen, B, H, S, Dq, Dv, torch.bfloat16)
    a, _, keep = mk.launch_args(*args, L, None, route="sm90")
    for name, fn in fns.items():
        _build.check(fn(*a), f"mlstm_ablate ({name})")
        row = {"copy": name, "shape": list(SHAPE),
               "ms": time_ms(lambda: fn(*a), 50)}
        for part, bit in mk.PARTS.items():
            row[f"{part}_ms"] = time_ms(
                lambda: fn(*a[:-2], bit, a[-1]), 50)
        print(json.dumps(row), flush=True)
    del keep
    return 0


if __name__ == "__main__":
    sys.exit(main())
