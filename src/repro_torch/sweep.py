"""§5.1 availability sweep on the PyTorch/CUDA port.

The port's counterpart of ``benchmarks/availability_sweep.py``'s config
mode: it runs an experiment spec through ``repro_torch.experiments``
and writes the same provenance-stamped summary, whose rows are
byte-identical to the reference's for the same spec.

    PYTHONPATH=src python -m repro_torch.sweep \\
        --config benchmarks/configs/sweep.toml --json OUT.json \\
        [--events OUT.jsonl] [--device cuda|cpu]
    python benchmarks/check_regression.py OUT.json \\
        benchmarks/BENCH_sweep.json --identical

``--config`` is mutually exclusive with the spec flags (--backend,
--trials, ...), which build a spec directly as the reference sweep's
flags do.  Only the availability metric is ported; the runner raises
``NotImplementedError`` for the rest.  ``--device`` defaults to cuda.
"""
from __future__ import annotations

import argparse
import sys

from .experiments.runner import ExperimentRunner
from .experiments.spec import ExperimentSpec, SpecError

#: argparse dest -> ExperimentSpec field for the availability flags
SPEC_FLAGS = {
    "full": "full", "smoke": "smoke", "backend": "backend",
    "metric": "metric", "trials": "trials", "devices": "devices",
    "seed": "seed", "scenario": "scenarios", "scenarios": "scenarios",
    "scenarios_only": "scenarios_only", "packed": "packed",
}


def build_parser() -> argparse.ArgumentParser:
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
                    choices=("availability", "downtime", "latency"))
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None,
                    help="requested trial shards; all trials run as one "
                         "batch on one card")
    ap.add_argument("--seed", type=int, default=None)
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
    ap.add_argument("--json", metavar="PATH",
                    help="write rows + provenance-stamped meta as JSON")
    ap.add_argument("--events", metavar="PATH",
                    help="append one JSONL progress record per row")
    return ap


def build_spec(argv=None):
    """Parse flags into (spec, args); --config excludes the spec flags."""
    ap = build_parser()
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
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
    try:
        if args.config:
            if provided:
                flags = ", ".join("--" + k.replace("_", "-")
                                  for k in sorted(provided))
                ap.error(f"--config is mutually exclusive with spec flags "
                         f"(got {flags}); edit the config or drop --config")
            spec = ExperimentSpec.from_file(args.config)
        else:
            spec = ExperimentSpec.create(**provided)
    except SpecError as e:
        ap.error(str(e))
    return spec, args


def main(argv=None) -> int:
    spec, args = build_spec(argv)
    runner = ExperimentRunner(spec, config_path=args.config,
                              events_path=args.events, device=args.device)
    runner.run()
    if args.json:
        runner.write_summary(args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
