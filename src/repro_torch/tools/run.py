"""Every paper table and figure of the port in one command (the port's
counterpart of ``benchmarks/run.py``).

    python -m repro_torch.tools.run [--device cpu] [flags ...]

Prints ``name,us_per_call,derived`` CSV rows, suite by suite:

* heartbeat_crossover — §4.1 footnote 6 (n* ~ 157);
* kernel_bench — the Monte Carlo step's kernels, µs a call;
* availability_sweep — ``repro_torch.sweep``: §5.1 Figure 6 / Table 2,
  §6 and client latency (the reduced grid; --full the paper's);
* microsim_tables — §5.2 Tables 3 and 4, all 24 cells;
* roofline — per (arch x shape) terms of the dry run's records;

then ``benchmarks_total,all,<µs>,seconds=<s>``.

Every suite gets the same argv and parses it with ``strict=False``, so
one suite's flags (the sweep's --backend, kernel_bench's --partitions,
the tables' --ticks) pass through the suites that do not know them, and
a flag two suites share means the same in both (--trials the trial
count, --device the device, cuda by default: a suite that computes runs
on the card unless it is told cpu).  A flag no suite knows is a typo:
every suite publishes ``cli_options()``, and a token outside their union
draws a warning naming the nearest valid flag, or, under ``$CI`` or a
``--config`` run (where a dropped override would change a pinned
experiment), exit 2 before any suite runs.  Run a suite alone to get
strict parsing back.

``STANDALONE_TOOLS`` are the tool modules that are not suites: they
parse their own argv strictly and print no suite rows.
"""
from __future__ import annotations

import difflib
import importlib
import os
import sys
import time

#: the suites in the order they run, by the reference's names
SUITE_NAMES = ("heartbeat_crossover", "kernel_bench",
               "availability_sweep", "microsim_tables", "roofline")
#: each suite's module in the port
SUITE_MODULES = {
    "heartbeat_crossover": "repro_torch.tools.heartbeat_crossover",
    "kernel_bench": "repro_torch.tools.kernel_bench",
    "availability_sweep": "repro_torch.sweep",
    "microsim_tables": "repro_torch.microsim_tables",
    "roofline": "repro_torch.tools.roofline",
}
#: ``repro_torch.tools`` modules that run alone, never as a suite:
#: perf_probe re-traces one dry-run cell under variants on its own fake
#: process group; make_experiments_md writes a document from the dry
#: run's records
STANDALONE_TOOLS = ("perf_probe", "make_experiments_md")


def suites() -> tuple:
    """The suite modules, in SUITE_NAMES order."""
    return tuple(importlib.import_module(SUITE_MODULES[name])
                 for name in SUITE_NAMES)


def _unknown_flags(argv, suites):
    """argv tokens that look like flags but appear in no suite's
    cli_options(), each as (flag, the nearest known flag or None)."""
    known = {"-h", "--help"}
    for suite in suites:
        known.update(suite.cli_options())
    unknown = []
    for tok in argv:
        if not tok.startswith("-") or tok == "-":
            continue
        flag = tok.split("=", 1)[0]
        if flag in known:
            continue
        close = difflib.get_close_matches(flag, sorted(known), n=1)
        unknown.append((flag, close[0] if close else None))
    return unknown


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    mods = suites()
    unknown = _unknown_flags(argv, mods)
    if unknown:
        for flag, close in unknown:
            hint = f" (did you mean {close!r}?)" if close else ""
            print(f"repro_torch.tools.run: warning: no suite recognizes "
                  f"{flag!r}{hint}; it would be silently dropped",
                  file=sys.stderr)
        if os.environ.get("CI") or "--config" in {t.split("=", 1)[0]
                                                  for t in argv}:
            print("repro_torch.tools.run: error: refusing to run with "
                  "unrecognized flags (CI/spec mode)", file=sys.stderr)
            return 2
    t0 = time.time()
    for suite in mods:
        suite.main(argv, strict=False)
    wall = time.time() - t0
    print(f"benchmarks_total,all,{wall * 1e6:.0f},seconds={wall:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
