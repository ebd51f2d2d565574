"""Paper §5.2 Tables 3-4 on the port: per-partition throughput and
latency through a node outage (port of ``benchmarks/microsim_tables.py``).

    python -m repro_torch.microsim_tables [--device cuda|cpu] [--ticks N]

Prints one CSV line per table cell, as the reference:

  microsim_t<3|4>,row<i>,0,thrL=...;thrB=...;ratio=...;avgL=...;avgB=...;
                           p99L=...;p99B=...;backfill=...;down=...;
                           paper_thrL=...;paper_backfill=...;paper_down=...

at the reference's 520,000 ticks.  On the card both tables are one launch
of ``microsim_scan`` (``core/microsim.run_tables``); on the CPU the plain
tick loop runs (minutes a table: use ``--ticks`` or ``run(ticks=...)``
for a short run).
``experiments/microsim_tables_ref.csv`` holds the reference's own lines
at 520,000 ticks, which ``chip_smoke.py`` holds these against.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .core.microsim import TABLES, run_tables, table_configs
from .tools import option_strings, parse

TICKS = 520_000
#: the reference's lines, committed (header line: command, jax, commit)
REF_LINES = Path(__file__).resolve().parent / "experiments" / \
    "microsim_tables_ref.csv"

# published values for drift-checking: (thr_lark, thr_base, backfill, down)
PAPER_T3 = [(2500, 2364, 66, 20), (25000, 24839, 8, 2), (2500, 1356, 135, 200),
            (25000, 23640, 66, 20), (2500, 837, 149, 300),
            (25000, 13547, 135, 200), (250, 236, 65, 20), (2500, 2484, 8, 2),
            (250, 136, 135, 200), (2500, 2364, 66, 20), (250, 84, 149, 300),
            (2500, 1356, 135, 200)]
PAPER_T4 = [(3326, 3153, 69, 20), (33327, 33118, 8, 2), (3316, 1926, 172, 200),
            (33275, 31535, 69, 20), (3313, 1330, 197, 300),
            (33187, 19248, 171, 200), (332, 315, 69, 20), (3333, 3312, 8, 2),
            (331, 193, 172, 200), (3326, 3153, 69, 20), (331, 134, 199, 300),
            (3316, 1926, 172, 200)]


def run(ticks: int = TICKS, device=None) -> dict:
    """{table name: run_table rows} for both tables, in one call of
    ``run_tables``."""
    return run_tables({name: table_configs(u, lf)
                       for name, (u, lf) in TABLES.items()},
                      ticks=ticks, device=device)


def lines(results: dict) -> list:
    """The reference's CSV lines of `results` (as ``run`` returns)."""
    paper = {"t3": PAPER_T3, "t4": PAPER_T4}
    out = []
    for name, rows in results.items():
        for i, r in enumerate(rows):
            pl = paper[name][i]
            out.append(f"microsim_{name},row{i+1},0,"
                       f"thrL={r['lark']['throughput']:.0f};"
                       f"thrB={r['base']['throughput']:.0f};"
                       f"ratio={r['throughput_ratio']:.2f};"
                       f"avgL={r['lark']['avg_ms']:.1f};"
                       f"avgB={r['base']['avg_ms']:.1f};"
                       f"p99L={r['lark']['p99_ms']};p99B={r['base']['p99_ms']};"
                       f"backfill={r['lark_backfill_s']:.0f};"
                       f"down={r['base_down_s']:.0f};"
                       f"paper_thrL={pl[0]};paper_backfill={pl[2]};"
                       f"paper_down={pl[3]}")
    return out


def reference_lines() -> list:
    """The committed reference lines, header dropped."""
    return [ln for ln in REF_LINES.read_text().splitlines()
            if ln and not ln.startswith("#")]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.microsim_tables",
                                 description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the tables run (default cuda; cpu runs "
                         "the plain tick loop)")
    ap.add_argument("--ticks", type=int, default=TICKS)
    return ap


def cli_options() -> tuple:
    return option_strings(build_parser())


def main(argv=None, *, strict: bool = True) -> int:
    args = parse(build_parser(), argv, strict)
    for ln in lines(run(ticks=args.ticks, device=args.device)):
        print(ln)
    return 0


if __name__ == "__main__":
    sys.exit(main())
