"""The port's counterparts of the reference's benchmark tools, as modules
of the package (``python -m repro_torch.tools.<name>``):

* ``run`` — every suite below, ``repro_torch.sweep`` and
  ``repro_torch.microsim_tables`` in one command, on one argv;
* ``kernel_bench`` — µs per ``step_eval`` call in both layouts on the
  card, the traffic model's ``kernel_step_hbm_*`` rows, and with
  ``--autotune`` both tile races;
* ``roofline`` — roofline terms of the dry run's records at the H100's
  peaks, and the Monte Carlo step's traffic in both layouts;
* ``heartbeat_crossover`` — the §4.1 control-plane crossover (stdlib);
* ``perf_probe`` — one dry-run cell under sharding and config variants;
* ``make_experiments_md`` — an EXPERIMENTS document from the dry run's
  records, written where the command line says.

A suite of ``run`` publishes ``cli_options()`` and takes
``main(argv=None, *, strict=True)``; the two helpers here give both from
its parser.
"""
from __future__ import annotations

import argparse


def option_strings(parser: argparse.ArgumentParser) -> tuple:
    """Every option string `parser` accepts."""
    return tuple(s for a in parser._actions for s in a.option_strings)


def parse(parser: argparse.ArgumentParser, argv, strict: bool):
    """`parser`'s namespace of `argv`; flags it does not know are an error
    when `strict`, and passed over otherwise (the suite runner gives
    every suite the same argv)."""
    args, extra = parser.parse_known_args(argv)
    if strict and extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args
