"""The port's suite runner (``repro_torch.tools.run``) and perf probe
(``repro_torch.tools.perf_probe``) on the CPU: the reference runner's
unknown-flag contract (the nearest flag named, exit 2 under ``$CI`` or
``--config`` before any suite runs), every suite's ``cli_options()`` and
``strict`` seam, every tool module a suite or a standalone tool, one real
run of all five suites on the CPU, and the probe's variants traced on
smollm-360m ``train_4k`` over a fake group of 512 ranks."""
import importlib
import pkgutil
from pathlib import Path

import pytest
import torch

from repro_torch import tools
from repro_torch.launch import dryrun
from repro_torch.tools import perf_probe
from repro_torch.tools import run as R

torch.set_num_threads(1)

SUITES = dict(zip(R.SUITE_NAMES, R.suites()))


def test_unknown_flag_names_the_nearest():
    assert R._unknown_flags(["--trails=8"], SUITES.values()) == \
        [("--trails", "--trials")]
    assert R._unknown_flags(["--trials", "8", "--device", "cpu", "--ticks",
                             "9", "--partitions", "4", "--rebuild-model",
                             "reconfig", "-h", "-"], SUITES.values()) == []


@pytest.fixture
def calls(monkeypatch):
    """The suites' main calls, made into no-ops that record their argv."""
    seen = []
    for name, mod in SUITES.items():
        monkeypatch.setattr(mod, "main", lambda argv=None, *, strict=True,
                            _n=name: seen.append((_n, strict)) or 0)
    return seen


@pytest.mark.parametrize("argv,env,rc", [
    (["--trails", "8"], {}, 0),
    (["--trails", "8"], {"CI": "1"}, 2),
    (["--config", "x.toml", "--trails", "8"], {}, 2),
    (["--config=x.toml", "--backnd", "numpy"], {}, 2),
], ids=["warns", "ci", "config", "config_eq"])
def test_unknown_flag_warns_or_refuses(argv, env, rc, calls, monkeypatch,
                                       capsys):
    monkeypatch.delenv("CI", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert R.main(argv) == rc
    cap = capsys.readouterr()
    assert "warning: no suite recognizes" in cap.err
    assert ("did you mean '--trials'?" in cap.err) or \
        ("did you mean '--backend'?" in cap.err)
    if rc == 2:
        assert calls == [] and cap.out == ""
    else:
        assert calls == [(n, False) for n in R.SUITE_NAMES]
        assert cap.out.startswith("benchmarks_total,all,")


@pytest.mark.parametrize("name", R.SUITE_NAMES)
def test_suite_publishes_options_and_strict_seam(name):
    mod = SUITES[name]
    opts = mod.cli_options()
    assert isinstance(opts, tuple)
    assert ("--help" in opts) == (name != "heartbeat_crossover")
    with pytest.raises(SystemExit) as e:
        mod.main(["--not-a-flag-of-any-suite"])
    assert e.value.code == 2


def test_shared_flags_mean_the_same():
    """A flag two suites take parses the same in both: --device to the
    same choices and default, --trials to an int, --autotune a switch."""
    by_flag = {}
    for name, mod in SUITES.items():
        if name == "heartbeat_crossover":         # no flags of its own
            continue
        for action in mod.build_parser()._actions:
            for opt in action.option_strings:
                by_flag.setdefault(opt, []).append(
                    (name, action.type, action.choices, action.default,
                     action.nargs))
    shared = {f: v for f, v in by_flag.items()
              if len(v) > 1 and f not in ("-h", "--help")}
    assert set(shared) == {"--device", "--trials", "--autotune"}
    for flag, owners in shared.items():
        assert len({o[1:] for o in owners if flag != "--trials"}
                   | {o[1:2] for o in owners if flag == "--trials"}) == 1, \
            (flag, owners)
    assert {o[0] for o in shared["--device"]} == \
        {"kernel_bench", "availability_sweep", "microsim_tables"}
    assert {o[3] for o in shared["--device"]} == {"cuda"}


def test_every_tool_module_is_suite_or_standalone():
    pkg = Path(tools.__file__).parent
    modules = {f"repro_torch.tools.{m.name}"
               for m in pkgutil.iter_modules([str(pkg)]) if m.name != "run"}
    modules |= {"repro_torch.sweep", "repro_torch.microsim_tables"}
    suites = set(R.SUITE_MODULES.values())
    standalone = {f"repro_torch.tools.{t}" for t in R.STANDALONE_TOOLS}
    assert suites | standalone == modules, (suites | standalone) ^ modules
    assert not suites & standalone
    assert tuple(R.SUITE_MODULES) == R.SUITE_NAMES
    for mod in standalone:
        assert not hasattr(importlib.import_module(mod), "cli_options")


def test_runner_runs_every_suite_on_the_cpu(capsys):
    argv = ["--device", "cpu", "--smoke", "--backend", "numpy", "--trials",
            "1", "--devices", "1", "--partitions", "128", "--nodes", "31",
            "--iters", "1", "--ticks", "2600"]
    assert R.main(argv) == 0
    cap = capsys.readouterr()
    assert "warning" not in cap.err
    names = [ln.split(",", 1)[0] for ln in cap.out.splitlines()]
    assert names[0] == "heartbeat_crossover"
    assert names[-1] == "benchmarks_total"
    got = set(names)
    for want in ("kernel_bench_device", "kernel_step_pac_unpacked",
                 "kernel_step_downtime_reconfig_packed", "availability",
                 "microsim_t3", "microsim_t4", "roofline_card",
                 "roofline_mc_step"):
        assert want in got, want
    assert names.count("availability") == 2
    assert names.count("microsim_t3") == names.count("microsim_t4") == 12
    assert "kernel_bench_device,cpu,0," in cap.out


def test_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        R.main(["--smoke", "--backend", "numpy", "--trials", "1"])


# -- the perf probe --------------------------------------------------------

@pytest.fixture(scope="module")
def probes():
    """smollm-360m train_4k's record under three variants and without
    any, on one fake group of 512 ranks."""
    dryrun.fake_world(512)
    try:
        out = {v: perf_probe.probe("smollm_360m", "train_4k", v)
               for v in ("baseline", "no_zero_grads", "nmb2")}
        out["run_cell"] = dryrun.run_cell("smollm_360m", "train_4k", False)
    finally:
        torch.distributed.destroy_process_group()
    return out


def _ops(rec):
    op = dict(rec["op_analysis"])
    assert op.pop("status") == "ok"
    op.pop("trace_s")
    return op


def test_probe_baseline_is_the_plain_cell(probes):
    base, plain = probes["baseline"], probes["run_cell"]
    assert _ops(base) == _ops(plain)
    for k in ("batch_axes", "param_count", "per_device_bytes",
              "microbatches"):
        assert base[k] == plain[k]
    assert "_reduce_scatter_base_" in base["op_analysis"]["collectives"]


def test_probe_no_zero_grads_all_reduces(probes):
    """Without grad_shardings the gradients keep the parameters' placement
    (replicated for smollm) and are all-reduced: no reduce-scatter is
    left, and the gradient bytes a rank holds are the whole float32
    gradient."""
    base, rec = probes["baseline"], probes["no_zero_grads"]
    coll = rec["op_analysis"]["collectives"]
    assert not any("reduce_scatter" in k for k in coll)
    grads = 4 * rec["param_count"]
    assert coll["allreduce_"]["bytes"] >= grads
    assert coll["allreduce_"]["bytes"] > \
        base["op_analysis"]["collectives"]["allreduce_"]["bytes"]
    assert rec["per_device_bytes"]["grads"] == grads
    assert base["per_device_bytes"]["grads"] < grads
    assert rec["op_analysis"]["flops"] == base["op_analysis"]["flops"]


def test_probe_nmb2_splits_as_the_step_does(probes):
    """nmb2 asks for 2 microbatches.  train_4k's 256 rows over smollm's
    256 batch ranks leave one row a rank, which the port's step cannot
    split (``sharded.microbatches``: the gcd of rows and count), so the
    traced step is the baseline's."""
    base, rec = probes["baseline"], probes["nmb2"]
    assert base["microbatches"] == {"configured": 1, "rank_rows": 1,
                                    "traced": 1, "traced_rows": 1}
    assert rec["microbatches"] == {"configured": 2, "rank_rows": 1,
                                   "traced": 1, "traced_rows": 1}
    assert _ops(rec) == _ops(base)


def test_probe_variants_restore_dryrun_and_override_config():
    saved = dryrun.param_shardings, dryrun.grad_shardings
    for name, want in [("baseline", {}), ("no_fsdp", {}),
                       ("no_zero_grads", {}),
                       ("nmb4", {"microbatches_train": 4}),
                       ("rg3", {"remat_group": 3}),
                       ("no_remat", {"remat": False})]:
        with perf_probe.variant(name) as overrides:
            assert overrides == want
            assert (dryrun.grad_shardings is saved[1]) == \
                (name != "no_zero_grads")
            if name == "no_zero_grads":
                assert dryrun.grad_shardings(None, None, None) is None
            assert (dryrun.param_shardings is saved[0]) == \
                (name != "no_fsdp")
        assert (dryrun.param_shardings, dryrun.grad_shardings) == saved
    with pytest.raises(ValueError, match="unknown variant"):
        perf_probe._overrides("fsdp_off")


def test_probe_no_fsdp_reaches_the_cell():
    """no_fsdp takes the data axis off qwen3-moe's parameters (an FSDP
    arch), so a rank holds more of them (built without the trace)."""
    dryrun.fake_world(512)
    try:
        with perf_probe.variant("no_fsdp") as ov:
            rec = dryrun.run_cell("qwen3_moe_235b_a22b", "train_4k", False,
                                  trace=False, overrides=ov)
        base = dryrun.run_cell("qwen3_moe_235b_a22b", "train_4k", False,
                               trace=False)
    finally:
        torch.distributed.destroy_process_group()
    assert rec["per_device_bytes"]["params"] > \
        base["per_device_bytes"]["params"]


def test_probe_cli_prints_a_line_per_variant(capsys):
    assert perf_probe.main(["--arch", "smollm_360m", "--shape", "long_500k",
                            "--variant", "baseline", "--variant",
                            "no_remat"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "PROBE smollm_360m long_500k baseline",
        "PROBE smollm_360m long_500k no_remat"]
    assert all("skipped" in ln for ln in lines)
    with pytest.raises(ValueError, match="unknown variant"):
        perf_probe.main(["--arch", "smollm_360m", "--shape", "train_4k",
                         "--variant", "fsdp_off"])


def test_probe_line_reads_the_record(probes):
    ln = perf_probe.line("smollm_360m", "train_4k", "nmb2", probes["nmb2"],
                         7.0)
    assert ln.startswith("PROBE smollm_360m train_4k nmb2: peak=not measured "
                         "flops=")
    assert "microbatches=1x1" in ln and "coll=" in ln and "bytes=" in ln
