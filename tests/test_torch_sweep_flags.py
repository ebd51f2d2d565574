"""The port's sweep CLI against the reference's: every spec flag of
``benchmarks/availability_sweep.py`` builds, through
``repro_torch.sweep.build_spec``, the spec the reference's
``build_spec`` builds (the same ``canonical()`` and ``content_hash()``),
or both exit through ``argparse`` with the same message; every
committed config's documented flag line gives its ``from_file`` spec;
and the rows of ``chip_smoke.py``'s two flag lines, pinned there as
``FLAG_ROWS_DOWNTIME`` and ``FLAG_ROWS_LATENCY``, are the reference
runner's (backend numpy) and the port's on the CPU."""
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

from repro.experiments import runner as ref_runner
from repro_torch import sweep
from repro_torch.experiments import runner
from repro_torch.experiments.spec import ExperimentSpec

# the engine's tensors are tiny: one intra-op thread keeps parallel test
# workers from oversubscribing the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIGS = REPO / "benchmarks" / "configs"
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_sweep = _load("ref_availability_sweep",
                  REPO / "benchmarks" / "availability_sweep.py")
ref_experiments = _load("ref_test_experiments",
                        REPO / "tests" / "test_experiments.py")

#: argvs over the 16 §6, zoo and latency flags: lines the spec takes and
#: lines it (or argparse) refuses
CASES = {
    "dupres": "--metric downtime --dupres-ticks 3",
    "dupres_needs_downtime": "--dupres-ticks 3",
    "dupres_not_int": "--metric downtime --dupres-ticks x",
    "rebuild_steps": "--metric downtime --rebuild-steps 50",
    "rebuild_steps_fixed_only":
        "--metric downtime --rebuild-model reconfig --rebuild-steps 7",
    "reconfig": "--metric downtime --rebuild-model reconfig",
    "rebuild_model_choice": "--metric downtime --rebuild-model refit",
    "ticks_per_gib": "--metric downtime --rebuild-model reconfig "
                     "--rebuild-ticks-per-gib 120",
    "ticks_per_gib_reconfig_only":
        "--metric downtime --rebuild-ticks-per-gib 5",
    "size_dist": "--metric downtime --rebuild-model reconfig "
                 "--size-dist lognormal --size-skew 0.5",
    "size_dist_reconfig_only": "--metric downtime --size-dist zipf",
    "size_dist_choice": "--metric downtime --rebuild-model reconfig "
                        "--size-dist pareto",
    "size_skew_needs_skewed_dist":
        "--metric downtime --rebuild-model reconfig --size-skew 2",
    "bandwidth": "--metric downtime --node-bandwidth-gibps 2.5",
    "bandwidth_inf": "--metric downtime --node-bandwidth-gibps inf",
    "bandwidth_positive": "--metric downtime --node-bandwidth-gibps 0",
    "hermes": "--metric downtime --engines lark,quorum,hermes "
              "--lease-ticks 40",
    "engines_unknown": "--metric downtime --engines lark,quorum,raft",
    "engines_downtime_only": "--metric latency --engines lark,quorum,hermes",
    "lease_needs_hermes": "--metric downtime --lease-ticks 40",
    "spinnaker": "--metric downtime --rebuild-model reconfig "
                 "--engines lark,quorum,spinnaker --view-change-ticks 200",
    "spinnaker_reconfig_only":
        "--metric downtime --engines lark,quorum,spinnaker "
        "--view-change-ticks 200",
    "view_change_needs_spinnaker":
        "--metric downtime --rebuild-model reconfig "
        "--view-change-ticks 200",
    "latency_workload": "--metric latency --key-zipf 0 --read-frac 0.9 "
                        "--requests-per-tick 8 --slo-ticks 0 "
                        "--write-skew 1 --slo-curve-bins 4",
    "latency_downtime_knobs": "--metric latency --rebuild-model reconfig "
                              "--size-dist zipf --node-bandwidth-gibps 1 "
                              "--dupres-ticks 2",
    "key_zipf_latency_only": "--key-zipf 2",
    "read_frac_range": "--metric latency --read-frac 1.5",
    "rate_positive": "--metric latency --requests-per-tick -1",
    "slo_ticks_latency_only": "--metric downtime --slo-ticks 4",
    "write_skew_range": "--metric latency --write-skew -1",
    "curve_bins_range": "--metric latency --slo-curve-bins -1",
    "curve_bins_latency_only": "--slo-curve-bins 4",
    "config_excludes_flags":
        f"--config {CONFIGS / 'downtime.toml'} --lease-ticks 4",
    "no_abbreviations": "--metric downtime --rebuild-mod reconfig",
    "downtime_line": " ".join(chip_smoke.SUITES_DOWNTIME_FLAGS),
    "latency_line": " ".join(chip_smoke.SUITES_LATENCY_FLAGS),
}


def _build(build_spec, argv, capsys):
    """(canonical spec, hash) or ("exit", code, the message after
    argparse's "error: ")."""
    capsys.readouterr()
    try:
        spec, _ = build_spec(argv)
    except SystemExit as e:
        err = capsys.readouterr().err
        return "exit", e.code, err.split(" error: ", 1)[1].strip()
    return spec.canonical(), spec.content_hash()


@pytest.mark.parametrize("argv", CASES.values(), ids=CASES.keys())
def test_flag_builds_reference_spec_or_same_error(argv, capsys):
    argv = argv.split()
    want = _build(ref_sweep.build_spec, argv, capsys)
    got = _build(sweep.build_spec, argv, capsys)
    assert got == want


def test_cases_cover_every_reference_flag():
    ref_flags = {o for o in ref_sweep.cli_options() if o.startswith("--")}
    port_flags = {o for o in sweep.cli_options() if o.startswith("--")}
    assert ref_flags <= port_flags
    assert port_flags - ref_flags == {"--device"}
    assert {k: v for k, v in sweep.SPEC_FLAGS.items()} == \
        ref_sweep.SPEC_FLAGS
    typed = {tok for argv in CASES.values() for tok in argv.split()
             if tok.startswith("--")}
    knobs = {"--" + d.replace("_", "-") for d in sweep.SPEC_FLAGS
             if d not in ("full", "smoke", "backend", "metric", "trials",
                          "devices", "seed", "scenario", "scenarios",
                          "scenarios_only", "packed", "autotune")}
    assert len(knobs) == 16 and knobs <= typed


@pytest.mark.parametrize("name", sorted(ref_experiments.FLAG_LINES))
def test_committed_flag_line_builds_its_config(name):
    line = ref_experiments.FLAG_LINES[name]
    got, _ = sweep.build_spec(line)
    cfg = ExperimentSpec.from_file(str(CONFIGS / name))
    ref, _ = ref_sweep.build_spec(line)
    assert got == cfg and got.content_hash() == cfg.content_hash()
    assert got.canonical() == ref.canonical()
    assert got.content_hash() == ref.content_hash()


def test_chip_smoke_flag_lines_are_the_pinned_ones():
    assert chip_smoke.FLAG_LINES == ref_experiments.FLAG_LINES


def test_loose_parsing_passes_unknown_flags():
    spec, _ = sweep.build_spec(["--backend", "numpy", "--smoke",
                                "--some-other-suites-flag", "--ticks",
                                "5"], strict=False)
    assert spec.backend == "numpy" and spec.smoke
    with pytest.raises(SystemExit):
        sweep.build_spec(["--smoke", "--some-other-suites-flag"])


def _dumps(rows):
    return [json.dumps(runner._json_safe(r), sort_keys=True) for r in rows]


LINES = {"downtime": (chip_smoke.SUITES_DOWNTIME_FLAGS,
                      chip_smoke.FLAG_ROWS_DOWNTIME),
         "latency": (chip_smoke.SUITES_LATENCY_FLAGS,
                     chip_smoke.FLAG_ROWS_LATENCY)}


@pytest.fixture(scope="module")
def reference_rows():
    """The reference runner's rows of each flag line, backend numpy (every
    batched backend gives these bits)."""
    out = {}
    for name, (argv, _) in LINES.items():
        spec, _ = ref_sweep.build_spec(list(argv))
        out[name] = _dumps(ref_runner.iter_rows(
            dataclasses.replace(spec, backend="numpy")))
    return out


@pytest.fixture(scope="module")
def port_rows(tmp_path_factory):
    """The port's rows of each flag line through its CLI on the CPU."""
    out = {}
    for name, (argv, _) in LINES.items():
        path = tmp_path_factory.mktemp("rows") / f"{name}.json"
        assert sweep.main(list(argv) + ["--device", "cpu", "--json",
                                        str(path)]) == 0
        out[name] = _dumps(json.loads(path.read_text())["rows"])
    return out


@pytest.mark.parametrize("name", LINES)
def test_pinned_flag_rows_are_the_reference_runners(name, reference_rows):
    assert LINES[name][1] == reference_rows[name]


@pytest.mark.parametrize("name", LINES)
def test_port_cpu_flag_rows_equal_pinned(name, port_rows):
    want = LINES[name][1]
    assert len(want) == {"downtime": 6, "latency": 2}[name]
    assert port_rows[name] == want
