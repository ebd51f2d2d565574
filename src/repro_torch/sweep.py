"""§5.1 availability, §6 downtime and client-latency sweeps on the
PyTorch/CUDA port.

The port's counterpart of ``benchmarks/availability_sweep.py``'s config
mode: it runs an experiment spec through ``repro_torch.experiments``
and writes the same provenance-stamped summary, whose rows are
byte-identical to the reference's for the same spec.

    PYTHONPATH=src python -m repro_torch.sweep \\
        --config benchmarks/configs/sweep.toml --json OUT.json \\
        [--events OUT.jsonl] [--device cuda|cpu]
    python benchmarks/check_regression.py OUT.json \\
        benchmarks/BENCH_sweep.json --identical

``--config`` is mutually exclusive with the spec flags, which build a
spec directly and map one to one onto ``ExperimentSpec`` fields, as the
reference sweep's flags do: a committed config and its documented flag
line give the same spec and ``content_hash()``.  Beside the
availability flags (--backend, --trials, ...) that covers the §6 knobs
(--dupres-ticks, --rebuild-steps, --rebuild-model,
--rebuild-ticks-per-gib, --size-dist, --size-skew,
--node-bandwidth-gibps), the protocol zoo (--engines, --lease-ticks,
--view-change-ticks) and the client-latency workload (--key-zipf,
--read-frac, --requests-per-tick, --slo-ticks, --write-skew,
--slo-curve-bins); a combination the spec refuses fails with its
message.  ``--autotune`` (with ``--backend pallas``) races the
kernel's tiles before the grid, on the shape this rank launches, prints
an ``autotune,...`` line and runs every row at the chosen tile (with
``--packed`` the fused kernel's (block_t, block_p) race); the rows are
those of the run without it.  ``--device`` defaults to cuda.
``main(argv, strict=False)`` passes over flags it does not know, as
the suite runner (``python -m repro_torch.tools.run``) needs, and
``cli_options()`` names every flag it does know.

Across ranks, ``torchrun --nproc-per-node R -m repro_torch.sweep ...``
runs the spec on R ranks (``gloo``; R must divide the spec's
``devices``, 8 in every committed config): each rank takes its share
of every run's trials on ``cuda:LOCAL_RANK % device_count`` (or the CPU
with ``--device cpu``), and rank 0 alone prints and writes, rows equal
to a one-process run's.
"""
from __future__ import annotations

import argparse
import os
import sys

from .core.downtime_batched import ENGINES, SIZE_DISTS
from .experiments.runner import ExperimentRunner
from .experiments.spec import ExperimentSpec, SpecError
from .launch import dist as rdist
from .tools import option_strings, parse

#: argparse dest -> ExperimentSpec field for every spec flag (the
#: reference's one-to-one mapping; --config, --device, --json and
#: --events are not spec fields)
SPEC_FLAGS = {
    "full": "full", "smoke": "smoke", "backend": "backend",
    "metric": "metric", "trials": "trials", "devices": "devices",
    "seed": "seed", "dupres_ticks": "dupres_ticks",
    "rebuild_steps": "rebuild_steps", "rebuild_model": "rebuild_model",
    "rebuild_ticks_per_gib": "rebuild_ticks_per_gib",
    "size_dist": "size_dist", "size_skew": "size_skew",
    "node_bandwidth_gibps": "node_bandwidth_gibps", "engines": "engines",
    "lease_ticks": "lease_ticks", "view_change_ticks": "view_change_ticks",
    "key_zipf": "key_zipf", "read_frac": "read_frac",
    "requests_per_tick": "requests_per_tick", "slo_ticks": "slo_ticks",
    "write_skew": "write_skew", "slo_curve_bins": "slo_curve_bins",
    "scenario": "scenarios", "scenarios": "scenarios",
    "scenarios_only": "scenarios_only", "packed": "packed",
    "autotune": "autotune",
}


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev off: a prefix typo like --ful must fail, not launch the
    # paper-scale grid, and the suite runner's loose parse must not bind
    # another suite's flag by its prefix
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep",
                                 description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--config", metavar="PATH",
                    help="run an experiment config (TOML/JSON spec, e.g. "
                         "benchmarks/configs/sweep.toml) instead of spec "
                         "flags — mutually exclusive with them")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine runs (default cuda; cpu runs "
                         "the plain PyTorch kernels)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny grid/scale (n=31, P=128)")
    ap.add_argument("--backend", default=None,
                    choices=("event", "numpy", "jax", "pallas"),
                    help="the spec's backend field; numpy/jax/pallas all "
                         "run the port's engine")
    ap.add_argument("--metric", default=None,
                    choices=("availability", "downtime", "latency"),
                    help="instantaneous availability (§5.1), commit-pause "
                         "durations (§6), or client-visible commit "
                         "latency under a keyed request workload")
    ap.add_argument("--dupres-ticks", type=int, default=None,
                    help="LARK dup-res round-trip cost in ticks "
                         "(downtime metric only; default 1)")
    ap.add_argument("--rebuild-steps", type=int, default=None,
                    help="quorum-log rebuild pause in ticks after a "
                         "replica loss (--rebuild-model fixed only; "
                         "default 100)")
    ap.add_argument("--rebuild-model", default=None,
                    choices=("fixed", "reconfig"),
                    help="quorum-log baseline: static replica set with a "
                         "constant rebuild pause (fixed, default) or "
                         "reconfiguration onto live nodes with a "
                         "data-sized catch-up (reconfig); downtime "
                         "metric only")
    ap.add_argument("--rebuild-ticks-per-gib", type=int, default=None,
                    help="reconfig catch-up cost per GiB of partition "
                         "data (--rebuild-model reconfig only; "
                         "default 100)")
    ap.add_argument("--size-dist", default=None, choices=SIZE_DISTS,
                    help="per-partition data-size distribution for the "
                         "reconfig catch-ups (default uniform [1, 2) "
                         "GiB; zipf/lognormal skew hot partitions while "
                         "pinning the same 1.5 GiB mean; "
                         "--rebuild-model reconfig only)")
    ap.add_argument("--size-skew", type=float, default=None,
                    help="skew shape of --size-dist zipf/lognormal "
                         "(Pareto exponent / log-sigma; 0 = constant "
                         "sizes; default 1)")
    ap.add_argument("--node-bandwidth-gibps", type=float, default=None,
                    help="per-node catch-up ingest bandwidth in "
                         "full-speed streams; concurrent rebuilds on one "
                         "node share it ('inf' disables sharing, the "
                         "default; applies to both rebuild models — "
                         "fixed-model rebuilds replay onto the lost "
                         "replica's own node)")
    ap.add_argument("--engines", default=None, metavar="LIST",
                    help="comma-separated protocol engines to report "
                         f"(subset of {','.join(ENGINES)}; default "
                         "lark,quorum; --metric downtime only)")
    ap.add_argument("--lease-ticks", type=int, default=None,
                    help="Hermes membership-lease expiry window: writes "
                         "block this many ticks after a replica is "
                         "suspected (--engines hermes; default 0)")
    ap.add_argument("--view-change-ticks", type=int, default=None,
                    help="Spinnaker log-reconciliation pause after a "
                         "leader loss (--engines spinnaker, "
                         "--rebuild-model reconfig; default 0)")
    ap.add_argument("--key-zipf", type=float, default=None,
                    help="zipf exponent of the key-popularity workload "
                         "(0 = exactly uniform traffic; --metric latency "
                         "only; default 1)")
    ap.add_argument("--read-frac", type=float, default=None,
                    help="fraction of requests that are reads (the rest "
                         "are writes; --metric latency only; default 0.8)")
    ap.add_argument("--requests-per-tick", type=float, default=None,
                    help="offered cluster-wide request rate "
                         "(--metric latency only; default 32)")
    ap.add_argument("--slo-ticks", type=int, default=None,
                    help="SLO threshold: rows report the fraction of "
                         "requests whose added commit latency STRICTLY "
                         "exceeds this (0 counts any added latency; "
                         "--metric latency only; default 8)")
    ap.add_argument("--write-skew", type=float, default=None,
                    help="skew the per-partition write fraction around "
                         "1 - read_frac (mean-pinned Pareto shape, own "
                         "RNG salt, independent of key popularity; 0 = "
                         "exactly uniform mix; --metric latency only; "
                         "default 0)")
    ap.add_argument("--slo-curve-bins", type=int, default=None,
                    help="report the SLO-violation curve over the "
                         "power-of-two thresholds 2^j - 1, j < BINS, "
                         "next to the --slo-ticks scalar (0 = scalar "
                         "only; --metric latency only; default 0)")
    ap.add_argument("--trials", type=int, default=None,
                    help="the batch of trials (seeds under backend event)")
    ap.add_argument("--devices", type=int, default=None,
                    help="trial shards: split over the ranks of a "
                         "torchrun world (which must divide it), else run "
                         "as one batch")
    ap.add_argument("--seed", type=int, default=None,
                    help="base RNG seed (default 0)")
    ap.add_argument("--scenario", action="append", metavar="NAME",
                    help="append a registered scenario's grid (repeatable, "
                         "comma-separated, or 'all')")
    ap.add_argument("--scenarios", action="store_true",
                    help="alias for --scenario all")
    ap.add_argument("--scenarios-only", action="store_true",
                    help="skip the i.i.d. grid (scenario rows only)")
    ap.add_argument("--packed", action="store_true",
                    help="carry holder masks as bit-packed words "
                         "(fused_pac_eval; bit-identical to unpacked)")
    ap.add_argument("--autotune", action="store_true",
                    help="race the kernel's tile candidates before the "
                         "sweep (the row tile; with --packed the fused "
                         "kernel's block_t x block_p race); backend "
                         "pallas")
    ap.add_argument("--json", metavar="PATH",
                    help="write rows + provenance-stamped meta as JSON")
    ap.add_argument("--events", metavar="PATH",
                    help="append one JSONL progress record per row")
    return ap


def cli_options() -> tuple:
    """Every option string the parser accepts: the suite runner's
    contract for telling a typo from another suite's flag."""
    return option_strings(build_parser())


def _provided_spec_flags(args: argparse.Namespace) -> dict:
    """The spec keys the command line set: a store_true flag when true,
    any other when not None, so the spec's metric and engine gating
    fires on what was typed and never on a filled default."""
    provided = {}
    for dest, key in SPEC_FLAGS.items():
        v = getattr(args, dest)
        if v is None or v is False:
            continue
        if dest == "scenario":
            provided["scenarios"] = tuple(v)
        elif dest == "scenarios":
            provided.setdefault("scenarios", ("all",))
        else:
            provided[key] = v
    return provided


def build_spec(argv=None, *, strict: bool = True):
    """Parse flags into (spec, args); --config excludes the spec flags.
    With strict False, flags the parser does not know are passed over."""
    ap = build_parser()
    args = parse(ap, argv, strict)
    provided = _provided_spec_flags(args)
    try:
        if args.config:
            if provided:
                flags = ", ".join("--" + k.replace("_", "-")
                                  for k in sorted(provided))
                ap.error(f"--config is mutually exclusive with sweep "
                         f"flags (got {flags}); edit the config or drop "
                         "--config")
            spec = ExperimentSpec.from_file(args.config)
        else:
            spec = ExperimentSpec.create(**provided)
    except SpecError as e:
        ap.error(str(e))
    return spec, args


def main(argv=None, *, strict: bool = True) -> int:
    spec, args = build_spec(argv, strict=strict)
    ranked = "WORLD_SIZE" in os.environ
    if ranked:
        rdist.init()
    try:
        runner = ExperimentRunner(spec, config_path=args.config,
                                  events_path=args.events,
                                  device=rdist.local_device(args.device))
        runner.run()
        if args.json:
            runner.write_summary(args.json)
    finally:
        if ranked:
            rdist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
