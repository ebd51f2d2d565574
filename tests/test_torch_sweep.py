"""The port's experiments layer against the reference: smoke-spec rows
serialize byte for byte like the reference runner's (reference backend
jax), spec identities and RNG salts match, and the paths still to be
ported raise ``NotImplementedError``."""
import json
from dataclasses import asdict
from pathlib import Path

import pytest

from repro.core import client_latency as ref_latency
from repro.core import downtime_batched as ref_downtime
from repro.experiments import provenance as ref_prov
from repro.experiments import runner as ref_runner
from repro.experiments.spec import ExperimentSpec as RefSpec
from repro_torch import sweep
from repro_torch.core import downtime_batched as port_downtime
from repro_torch.experiments import provenance, runner
from repro_torch.experiments.spec import ExperimentSpec

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "benchmarks" /
                  "configs").glob("*.toml"))


def _dumps(rows):
    return [json.dumps(runner._json_safe(r), sort_keys=True) for r in rows]


def test_smoke_spec_rows_match_reference_runner():
    kw = dict(backend="jax", smoke=True, trials=2)
    want = list(ref_runner.iter_rows(RefSpec.create(**kw)))
    got = list(runner.iter_rows(ExperimentSpec.create(**kw), device="cpu"))
    assert [r["kind"] for r in got] == ["iid", "iid"]
    assert _dumps(got) == _dumps(want)


def test_smoke_scenario_rows_match_reference_runner():
    kw = dict(backend="jax", smoke=True, trials=1, seed=4,
              scenarios=["rack-pairs"], scenarios_only=True)
    want = list(ref_runner.iter_rows(RefSpec.create(**kw)))
    got = list(runner.iter_rows(ExperimentSpec.create(**kw), device="cpu"))
    assert [r["scenario"] for r in got] == ["rack-pairs"] * 3
    assert _dumps(got) == _dumps(want)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_committed_config_hashes_match_reference(path):
    want = RefSpec.from_file(str(path))
    got = ExperimentSpec.from_file(str(path))
    assert got.canonical() == want.canonical()
    assert got.content_hash() == want.content_hash()
    assert got.legacy_meta() == want.legacy_meta()


def test_rng_salts_and_constants_match_reference():
    assert provenance.rng_salts() == ref_prov.rng_salts()
    assert provenance._KEY_SALT == ref_latency._KEY_SALT
    for name in ("_SIZE_SALT", "REBUILD_MODELS", "ENGINES", "SIZE_DISTS",
                 "_SIZE_SKEW_MAX", "_KEY_ZIPF_MAX", "_WRITE_SKEW_MAX",
                 "_REB_SCALE"):
        assert getattr(port_downtime, name) == getattr(ref_downtime, name)
    assert asdict(port_downtime.DowntimeParams()) == \
        asdict(ref_downtime.DowntimeParams())


@pytest.mark.parametrize("kw,item", [
    (dict(metric="downtime", smoke=True, backend="numpy"), "item 5"),
    (dict(metric="latency", smoke=True, backend="numpy"), "item 8"),
    (dict(smoke=True), "item 11"),                       # backend event
    (dict(smoke=True, backend="pallas", autotune=True), "item 10"),
])
def test_unported_paths_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        next(runner.iter_rows(ExperimentSpec.create(**kw), device="cpu"))


def test_sweep_cli_writes_provenance_stamped_summary(tmp_path, capsys):
    out, events = tmp_path / "rows.json", tmp_path / "events.jsonl"
    assert sweep.main(["--smoke", "--backend", "numpy", "--trials", "1",
                       "--devices", "1", "--device", "cpu", "--json",
                       str(out), "--events", str(events)]) == 0
    doc = json.loads(out.read_text())
    spec = ExperimentSpec.create(smoke=True, backend="numpy", trials=1)
    assert doc["meta"]["spec"] == {"name": "", **spec.canonical()}
    prov = doc["meta"]["provenance"]
    assert prov["spec_sha256"] == spec.content_hash()
    assert prov["observed"]["platform"] == "cpu"
    assert prov["requested"] == {"backend": "numpy", "devices": 1,
                                 "trials": 1}
    assert [r["kind"] for r in doc["rows"]] == ["iid", "iid"]
    kinds = [json.loads(line)["event"]
             for line in events.read_text().splitlines()]
    assert kinds == ["run_start", "row", "row", "run_end"]
    assert capsys.readouterr().out.startswith("availability,rf2_p0.003,0,")


def test_sweep_config_excludes_spec_flags():
    with pytest.raises(SystemExit):
        sweep.build_spec(["--config", str(CONFIGS[0]), "--trials", "2"])
