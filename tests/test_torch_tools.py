"""The port's benchmark tools (``repro_torch.tools``) on the CPU: the
heartbeat crossover's line equals the reference's, the roofline reads
dry-run records and asserts the Monte Carlo step's traffic, the
EXPERIMENTS document goes where the command line says and names the
H100, and ``kernel_bench --device cpu`` prints its rows at a tiny tile."""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro_torch.configs import ARCH_IDS, SHAPES_BY_NAME, get_config
from repro_torch.kernels import ops
from repro_torch.tools import (heartbeat_crossover, kernel_bench,
                               make_experiments_md, roofline)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_heartbeat_crossover_line_equals_the_reference(capsys):
    assert heartbeat_crossover.main([]) == 0
    got = capsys.readouterr().out
    _reference_tool("heartbeat_crossover").main()
    assert got == capsys.readouterr().out
    assert got.strip() == heartbeat_crossover.line()


def test_heartbeat_crossover_imports_nothing_but_the_stdlib():
    text = Path(heartbeat_crossover.__file__).read_text()
    imports = {line.split()[1] for line in text.splitlines()
               if line.startswith(("import ", "from "))}
    assert imports <= {"__future__", "math", "sys"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_equal_the_reference_roofline(arch):
    ref = _reference_tool("roofline")
    assert roofline.active_params(get_config(arch)) == \
        ref.active_params(ref_get_config(arch))
    shape = SHAPES_BY_NAME["train_4k"]
    assert roofline.model_flops(get_config(arch), shape) == \
        6.0 * roofline.active_params(get_config(arch)) * shape.tokens


def _records(tmp_path):
    ok = {"arch": "smollm_360m", "shape": "train_4k", "mesh": "pod16x16",
          "kind": "train", "status": "ok",
          "op_analysis": {"status": "ok", "flops": 989e12 * 2,
                          "bytes": 3.35e12 * 3,
                          "collectives": {"allreduce_": {"bytes": 450e9,
                                                         "count": 1}},
                          "collective_bytes_total": 450e9 * 5},
          "per_device_bytes": {"params": 2e9, "grads": 1e9,
                               "opt_state": 2e9, "batch": 0}}
    skipped = {"arch": "smollm_360m", "shape": "long_500k",
               "mesh": "pod16x16", "kind": "decode", "status": "skipped",
               "reason": "full attention"}
    for rec in (ok, skipped):
        (tmp_path / f"{rec['arch']}__{rec['shape']}__pod16x16.json") \
            .write_text(json.dumps(rec))
    return ok


def test_roofline_reads_dry_run_records(tmp_path, capsys):
    _records(tmp_path)
    rows = roofline.load_cells(tmp_path)
    assert [(r["shape"], r["status"]) for r in rows] == \
        [("train_4k", "ok"), ("long_500k", "skipped")]
    r = rows[0]
    assert (r["compute_s"], r["memory_s"], r["collective_s"]) == \
        pytest.approx((2.0, 3.0, 5.0))
    assert r["dominant"] == "collective"
    assert r["roofline_fraction"] == pytest.approx(2.0 / 5.0)
    assert r["args_gb"] == pytest.approx(5.0)
    mf = roofline.model_flops(get_config("smollm_360m"),
                              SHAPES_BY_NAME["train_4k"])
    assert r["useful_ratio"] == pytest.approx(mf / (989e12 * 2 * 256))
    assert roofline.main(["--results", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("roofline_card,pod16x16,0,card=NVIDIA H100")
    assert "peak_flops=9.89e+14;hbm_bw=3.35e+12;link_bw=4.5e+11" in out[0]
    assert out[1].startswith("roofline,smollm_360m__train_4k,0,"
                             "compute_s=2.0000;memory_s=3.0000;"
                             "collective_s=5.0000;dominant=collective")
    assert out[2] == "roofline,smollm_360m__long_500k,0,status=skipped"
    assert len([o for o in out if o.startswith("roofline_mc_step")]) == \
        len(roofline.MC_STEP_GRID)


def test_mc_step_rows_hold_the_packed_step_under_the_unpacked(monkeypatch):
    rows = roofline.mc_step_rows()
    assert all(r["fused_bytes"] <= r["unfused_bytes"] for r in rows)
    full = next(r for r in rows if r["label"] == "full_avail")
    want = ops.step_hbm_bytes(ops.StepSpec(metric="availability", rf=3,
                                           n_real=155), 8, 4096, 155)
    assert (full["unfused_bytes"], full["fused_bytes"]) == \
        (want["unfused_bytes"], want["fused_bytes"])
    monkeypatch.setattr(ops, "step_hbm_bytes", lambda *a: {
        "unfused_bytes": 1, "fused_bytes": 2, "ratio": 0.5})
    with pytest.raises(AssertionError, match="more bytes"):
        roofline.mc_step_rows()


def test_make_experiments_md_writes_where_it_is_told(tmp_path, capsys):
    _records(tmp_path)
    out = tmp_path / "sub" / "EXPERIMENTS.md"
    out.parent.mkdir()
    assert make_experiments_md.main([str(out), "--results",
                                     str(tmp_path)]) == 0
    text = out.read_text()
    assert "NVIDIA H100" in text and "989 TFLOP/s" in text
    assert "3.35 TB/s" in text and "450 GB/s" in text
    assert "TPU" not in text and "v5e" not in text
    assert "| smollm_360m | train_4k | 2.000 | 3.000 | 5.0000 | " \
        "collective |" in text
    assert "| smollm_360m | long_500k | — | — | — | skipped |" in text
    assert "| full_reconfig | fused_downtime_roster |" in text
    assert not (REPO / "EXPERIMENTS.md").exists()


def test_kernel_bench_on_the_cpu_at_a_tiny_tile(capsys):
    assert kernel_bench.main(["--device", "cpu", "--trials", "2",
                              "--partitions", "64", "--nodes", "31",
                              "--iters", "2", "--autotune"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("kernel_bench_device,cpu,0,card=cpu;")
    names = [o.split(",")[0] for o in out]
    for name in ("pac", "downtime", "downtime_reconfig"):
        for layout in ("unpacked", "packed"):
            assert f"kernel_step_{name}_{layout}" in names
    hbm = ops.step_hbm_bytes(ops.StepSpec(metric="availability", rf=3,
                                          voters=5, n_real=31), 2, 64, 31)
    assert (f"kernel_step_hbm_pac,b2p64n31,0,unfused={hbm['unfused_bytes']};"
            f"fused={hbm['fused_bytes']};ratio={hbm['ratio']:.1f}") in out
    assert "kernel_pac_autotune,r128n31,0,choice=16;" \
        "source=heuristic-fallback" in out
    assert "kernel_fused_autotune,b2p64n31,0,choice=1x128;" \
        "source=heuristic-fallback" in out
    assert not any(o.startswith(("kernel_pac_block", "kernel_fused_block"))
                   for o in out)


def test_tools_import_neither_jax_nor_the_reference():
    for mod in (heartbeat_crossover, kernel_bench, make_experiments_md,
                roofline):
        text = Path(mod.__file__).read_text()
        for line in text.splitlines():
            if line.startswith(("import ", "from ")):
                assert "jax" not in line and "repro." not in line.replace(
                    "repro_torch", "")
