"""Regenerate committed baselines on the port and gate them byte for byte.

    PYTHONPATH=src python -m repro_torch.bench_gate \\
        --config benchmarks/configs/latency.toml \\
        --config benchmarks/configs/shootout.toml [--config ...] \\
        [--packed-too] [--autotune] [--device cuda] --out DIR

Every committed config runs: ``sweep.toml``, the three
``downtime*.toml``, ``latency.toml`` and ``shootout.toml``.

For each config (and, with ``--packed-too``, a copy of it with
``packed = true``) this starts ``python -m repro_torch.sweep --config
... --json ... --events ...`` in its own process, all at once, waits for
them, then runs ``benchmarks/check_regression.py OUT BASELINE
--identical`` on each result, the baseline being the config's
``BENCH_<name>.json`` beside ``benchmarks/configs``.  ``--autotune``
runs each config as a copy with ``backend = "pallas"`` and ``autotune =
true``: the sweep races the kernel's tiles first and runs the grid at
the chosen one.  Its ``autotune`` row has no row key (``row_key`` is
None): the gate never holds it.  ``check_regression.py --identical``
compares every row of a dump in order, so the gate runs on
``<label>.gated.json``, the summary without its rows that have no key,
and every other row must still equal the baseline's.  It prints one JSON
line per run (the gate's verdict, its last output line, and the sweep's
own ``run_end.wall_s`` and rows per second from its events file) and
exits non-zero if any run or gate failed.  The runs share the machine,
so each wall-clock is the time of that sweep beside the others.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from .experiments.schema import row_key

ROOT = Path(__file__).resolve().parents[2]


def gated_copy(path: Path) -> Path:
    """The summary at `path` without its rows that have no row key (the
    autotune row), written beside it as ``<stem>.gated.json``; `path`
    itself when every row has a key."""
    doc = json.loads(Path(path).read_text())
    rows = [r for r in doc["rows"] if row_key(r) is not None]
    if len(rows) == len(doc["rows"]):
        return Path(path)
    out = Path(path).with_suffix(".gated.json")
    out.write_text(json.dumps(dict(doc, rows=rows), indent=1,
                              sort_keys=True, allow_nan=False))
    return out


def tuned_text(text: str) -> str:
    """A config's text with backend "pallas" and autotune on."""
    lines = [line for line in text.splitlines()
             if not line.replace(" ", "").startswith("backend=")]
    return "\n".join(lines) + '\nbackend = "pallas"\nautotune = true\n'


def _runs(configs, packed_too: bool, out: Path, autotune: bool = False):
    """(label, config path, baseline path) for every run."""
    for cfg in map(Path, configs):
        base = cfg.resolve().parents[1] / f"BENCH_{cfg.stem}.json"
        label, text = cfg.stem, cfg.read_text()
        if autotune:
            label, text = f"{cfg.stem}_autotune", tuned_text(text)
            cfg = out / f"{label}.toml"
            cfg.write_text(text)
        yield label, cfg, base
        if packed_too:
            packed = out / f"{label}_packed.toml"
            packed.write_text(text + "packed = true\n")
            yield f"{label}_packed", packed, base


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", action="append", required=True)
    ap.add_argument("--packed-too", action="store_true")
    ap.add_argument("--autotune", action="store_true",
                    help="run each config with backend pallas and "
                         "autotune on (the autotune row is not gated)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for label, cfg, base in _runs(args.config, args.packed_too, out,
                                  args.autotune):
        log = open(out / f"{label}.log", "w")
        cmd = [sys.executable, "-m", "repro_torch.sweep", "--config",
               str(cfg), "--device", args.device, "--json",
               str(out / f"{label}.json"), "--events",
               str(out / f"{label}.events.jsonl")]
        procs.append((label, base, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT, env=env)))
    ok = True
    for label, base, log, proc in procs:
        rc = proc.wait()
        log.close()
        gate = subprocess.run(
            [sys.executable, str(ROOT / "benchmarks" / "check_regression.py"),
             str(gated_copy(out / f"{label}.json")), str(base),
             "--identical"], capture_output=True, text=True) \
            if rc == 0 else None
        end = {}
        events = out / f"{label}.events.jsonl"
        if events.exists():
            for line in events.read_text().splitlines():
                rec = json.loads(line)
                if rec.get("event") == "run_end":
                    end = rec
        passed = gate is not None and gate.returncode == 0
        ok = ok and passed
        said = (gate.stdout + gate.stderr).strip().splitlines() \
            if gate is not None else []
        print(json.dumps({"run": label, "sweep_rc": rc,
                          "identical": passed,
                          "gate": said[-1] if said else None,
                          "rows": end.get("rows"),
                          "wall_s": end.get("wall_s"),
                          "rows_per_s": end.get("rows_per_s")}),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
