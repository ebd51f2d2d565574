"""``python -m repro_torch.launch.train --device cpu --reduced
--fail-worker-at 3``: the run reaches its end, writes its metrics and
disk shards, and its per-step records carry the same checkpoint steps
and LARK and baseline commit flags as the reference CLI's run with the
same flags (the weights differ: each side draws its own seed-0
weights)."""
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro.launch.train import main as ref_main
from repro_torch.launch.train import main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--reduced", "--fail-worker-at", "3", "--steps", "16"]


def _flags(log):
    return [(r["step"], r.get("lark_commit"), r.get("baseline_commit"))
            for r in log]


def test_cli_commit_flags_match_reference(tmp_path):
    got = main(["--device", "cpu", *FLAGS, "--out", str(tmp_path / "t")])
    want = ref_main([*FLAGS, "--out", str(tmp_path / "j")])
    assert _flags(got) == _flags(want)
    assert all(r["lark_commit"] for r in got if "lark_commit" in r)
    assert not all(r["baseline_commit"] for r in got
                   if "baseline_commit" in r)    # the hydration window
    out = tmp_path / "t" / "smollm_360m"
    assert json.loads((out / "metrics.json").read_text()) == got
    manifest = json.loads((out / "ckpt" / "manifest_00000015.json")
                          .read_text())
    assert manifest["step"] == 15 and manifest["regime"] == 2
    assert (out / "ckpt" / "latest").read_text() == "15"
    assert len(manifest["paths"]) == len(manifest["dtypes"]) > 0


def test_cli_runs_as_a_module(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--fail-worker-at", "3", "--out", str(tmp_path)],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    assert [r["step"] for r in lines] == list(range(20))
    assert "worker 3 failed" in out.stdout and "done in" in out.stdout
