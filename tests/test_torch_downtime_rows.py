"""The port's §6 downtime rows against the reference runner: the
committed downtime configs, cut to one trial, give rows that serialize
byte for byte like the reference's (reference backend numpy, which the
reference proves row-identical to its jax and pallas backends)."""
import json
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from repro.experiments import runner as ref_runner
from repro.experiments.spec import ExperimentSpec as RefSpec
from repro_torch.experiments import runner
from repro_torch.experiments.spec import ExperimentSpec

# the tensors here are tiny: one intra-op thread per test process keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

CONFIG_DIR = Path(__file__).resolve().parents[1] / "benchmarks" / "configs"

DOWNTIME_CONFIGS = {"downtime": "rack-pairs",
                    "downtime_reconfig": "flapping",
                    "downtime_skew": "hetero-mttf"}


@pytest.mark.parametrize("name", list(DOWNTIME_CONFIGS))
def test_downtime_smoke_rows_match_reference_runner(name):
    """The first i.i.d. row and one scenario row of each committed §6
    config, at one trial, serialize byte for byte as the reference's."""
    path = str(CONFIG_DIR / f"{name}.toml")
    cut = dict(trials=1, devices=1, backend="numpy")
    scen = dict(cut, scenarios=(DOWNTIME_CONFIGS[name],), scenarios_only=True)
    for kw in (cut, scen):
        want = next(ref_runner.iter_rows(replace(RefSpec.from_file(path),
                                                 **kw)))
        got = next(runner.iter_rows(replace(ExperimentSpec.from_file(path),
                                            **kw), device="cpu"))
        assert got["kind"] == ("downtime_scenario" if "scenarios" in kw
                               else "downtime")
        assert _dumps(got) == _dumps(want)
        assert runner.row_csv_line(got) == ref_runner.row_csv_line(want)


def _dumps(row):
    return json.dumps(runner._json_safe(row), sort_keys=True)
