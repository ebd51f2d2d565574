"""Committed client-latency and protocol-zoo rows, rebuilt by the port on
the CPU: rows of ``benchmarks/BENCH_latency.json`` and
``benchmarks/BENCH_shootout.json``, at their full committed spec (8
trials, smoke scale), must serialize byte for byte as committed, and
print the reference runner's CSV progress lines."""
import json
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro.experiments import runner as ref_runner
from repro_torch.experiments import runner
from repro_torch.experiments.spec import ExperimentSpec

# one intra-op thread per test process keeps parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _dumps(row):
    return json.dumps(runner._json_safe(row), sort_keys=True)


@pytest.mark.parametrize("config,scenario,count", [
    ("latency", None, 1),                  # i.i.d. rf 2, p 3e-3
    ("latency", "independent", 1),
    ("shootout", "rolling-restart", 3),    # downtime + hermes + spinnaker
])
def test_committed_rows_rebuild_byte_identical(config, scenario, count):
    spec = ExperimentSpec.from_file(str(BENCH / "configs" / f"{config}.toml"))
    base = json.loads((BENCH / f"BENCH_{config}.json").read_text())["rows"]
    if scenario is not None:
        spec = replace(spec, scenarios=(scenario,), scenarios_only=True)
        base = [r for r in base if r.get("scenario") == scenario]
    rows = runner.iter_rows(spec, device="cpu")
    for want in base[:count]:
        got = next(rows)
        assert _dumps(got) == json.dumps(want, sort_keys=True)
        assert runner.row_csv_line(got) == ref_runner.row_csv_line(want)
