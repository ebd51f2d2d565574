"""The PyTorch port stands alone: with ``jax`` and ``repro`` blocked, every
module of ``repro_torch`` and ``chip_smoke`` still imports, and the port's
entry points refuse to fall back to the CPU when no card is present."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import downtime_batched
from repro_torch.core.availability_batched import \
    simulate_availability_batched
from repro_torch.device import resolve_device
from repro_torch.kernels import fused_step, pac_eval

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

_BLOCKED_IMPORT = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "repro")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(len(names))
"""


def test_port_and_chip_smoke_import_without_jax_or_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT, str(SRC), str(ROOT)],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    # every module of the slice was visited (packages + modules)
    assert int(out.stdout.strip()) >= 20


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_names_jax_or_repro(path):
    assert not {"jax", "jaxlib", "repro"} & set(_imported_roots(path))


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_availability_batched(n=7, partitions=8, trials=1,
                                      max_steps=2)
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrappers_dispatch_by_device_without_fallback():
    up = torch.ones((4, 9), dtype=torch.bool)
    before = pac_eval.pac_eval.launches
    lark, maj, creps = pac_eval.pac_eval(up, up, rf=2, voters=3, n_real=9)
    assert pac_eval.pac_eval.launches == before      # plain path: no launch
    assert lark.all() and maj.all()
    assert creps.sum(dim=1).tolist() == [2] * 4
    with pytest.raises(ValueError, match="cuda or cpu"):
        pac_eval.pac_eval(up.to("meta"), up.to("meta"), rf=2, voters=3,
                          n_real=9)
    words = torch.from_numpy(np.full((2, 1, 8), -1, dtype=np.int32))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_step.fused_pac_eval(words.to("meta"), words.to("meta"), rf=2,
                                  voters=3, n_real=9)
    with pytest.raises(TypeError):
        fused_step.fused_pac_eval(words.to(torch.int64), words, rf=2,
                                  voters=3, n_real=9)


def test_downtime_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        downtime_batched.simulate_downtime_batched(n=7, partitions=8,
                                                   trials=1, max_steps=2)
    with pytest.raises(RuntimeError, match="cuda"):
        downtime_batched.carry_from_numpy((np.zeros(2, np.int32),))
    cpu = downtime_batched.carry_from_numpy((np.zeros(2, np.int32),),
                                            device="cpu")
    assert cpu[0].device == torch.device("cpu")


def test_downtime_wrappers_dispatch_by_device_without_fallback():
    up = torch.ones((4, 9), dtype=torch.bool)
    # rank 9 lies outside the 9 real lanes and reads as down
    roster = torch.tensor([[0, 9]] * 4, dtype=torch.int32)
    def launched():
        return (pac_eval.downtime_eval.launches,
                pac_eval.downtime_eval.roster_launches,
                pac_eval.downtime_eval.counts_launches,
                pac_eval.downtime_eval.roster_counts_launches,
                pac_eval.node_count.launches,
                fused_step.fused_downtime_eval.launches)

    counts = launched()
    outs = pac_eval.downtime_eval(up, up, rf=2, n_real=9, roster=roster)
    assert outs[2].tolist() == [0] * 4 and outs[4].tolist() == [1] * 4
    rec = torch.zeros((2, 4), dtype=torch.int32)
    assert pac_eval.node_count(rec, rec == 0, n_real=9)[:, 0].tolist() == \
        [4, 4]
    for ro in (None, roster):
        outs = pac_eval.downtime_eval(up.repeat(2, 1), up.repeat(2, 1), rf=2,
                                      n_real=9, roster=None if ro is None
                                      else ro.repeat(2, 1),
                                      recruit=rec, active=rec == 0)
        assert outs[-1][:, 0].tolist() == [4, 4]
    words = torch.from_numpy(np.full((2, 1, 4), -1, dtype=np.int32))
    fused_step.fused_downtime_eval(words, words, rf=2, n_real=9,
                                   recruit=rec, active=rec == 0)
    assert counts == launched()                         # plain: no launch
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pac_eval.downtime_eval(up.to(meta), up.to(meta), rf=2, n_real=9)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pac_eval.node_count(rec.to(meta), (rec == 0).to(meta), n_real=9)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_step.fused_downtime_eval(words.to(meta), words.to(meta), rf=2,
                                       n_real=9)
    with pytest.raises(TypeError):
        pac_eval.node_count(rec.to(torch.int64), rec == 0, n_real=9)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pac_eval.downtime_eval(up.repeat(2, 1).to(meta),
                               up.repeat(2, 1).to(meta), rf=2, n_real=9,
                               recruit=rec.to(meta),
                               active=(rec == 0).to(meta))
    with pytest.raises(ValueError, match="roster"):
        pac_eval.downtime_eval(up, up, rf=2, n_real=9,
                               roster=roster.to(torch.int64))


def test_counts_arguments_are_checked_before_any_launch():
    """recruit and active come together, as (B, P) with B·P the tiles'
    rows, on their device; B·n_real must stay inside int32 (a row's key
    and the counts' index), whatever n_real."""
    up = torch.ones((8, 9), dtype=torch.bool)
    rec = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        pac_eval.downtime_eval(up, up, rf=2, n_real=9, recruit=rec)
    with pytest.raises(ValueError, match="B·P"):
        pac_eval.downtime_eval(up, up, rf=2, n_real=9, recruit=rec[:1],
                               active=rec[:1] == 0)
    with pytest.raises(ValueError, match="2\\^31"):
        pac_eval.node_count(rec, rec == 0, n_real=2 ** 30)
    with pytest.raises(ValueError, match=">= 1"):
        pac_eval.node_count(rec, rec == 0, n_real=0)
    # past the old shared-histogram limit of 8192 nodes
    big = pac_eval.node_count(rec + 9000, rec == 0, n_real=9001)
    assert big.shape == (2, 9001) and big[:, 9000].tolist() == [4, 4]


def test_latency_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.core.client_latency import simulate_client_latency
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_client_latency(n=7, partitions=8, trials=1, max_steps=2)


def test_serve_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.serving import ServeLoop
    with pytest.raises(RuntimeError, match="cuda"):
        ServeLoop(reduced_config("xlstm_350m"), {})
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main([])


def test_model_kernel_wrappers_dispatch_by_device_without_fallback():
    """rglru_scan and flash_attention_fwd run their plain versions on CPU
    tensors and take their shapes on meta tensors (no launch); nothing
    falls back from a CUDA tensor."""
    from repro_torch.kernels import flash_attention, rglru_scan
    x = torch.zeros((1, 5, 3))
    before = rglru_scan.rglru_scan.launches
    assert torch.equal(rglru_scan.rglru_scan(x, x - 1.0),
                       rglru_scan.rglru_scan_plain(x, x - 1.0))
    assert rglru_scan.rglru_scan.launches == before
    assert rglru_scan.rglru_scan(x.to("meta"), x.to("meta")).shape == \
        x.shape
    assert rglru_scan.rglru_scan.launches == before
    q = torch.ones((1, 2, 5, 4))
    before = flash_attention.flash_attention_fwd.launches
    out = flash_attention.flash_attention_fwd(q, q, q, window=2)
    assert flash_attention.flash_attention_fwd.launches == before
    assert torch.equal(out, q)                  # equal values average to 1
    assert flash_attention.flash_attention_fwd(
        q.to("meta"), q.to("meta"), q.to("meta")).shape == q.shape
    assert flash_attention.flash_attention_fwd.launches == before


def test_recurrentgemma_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import reduced_config
    from repro_torch.launch import serve
    from repro_torch.serving import ServeLoop
    with pytest.raises(RuntimeError, match="cuda"):
        ServeLoop(reduced_config("recurrentgemma_9b"), {})
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "recurrentgemma_9b"])


def test_microsim_entry_points_default_to_the_card():
    """run_table and the tables CLI default to the card and raise without
    one; with device="cpu" they run the plain tick loop."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch import microsim_tables
    from repro_torch.core import microsim
    configs = microsim.table_configs(0.5, 0.5)[:1]
    with pytest.raises(RuntimeError, match="cuda"):
        microsim.run_table(configs, ticks=10)
    with pytest.raises(RuntimeError, match="cuda"):
        microsim_tables.main(["--ticks", "10"])
    rows = microsim.run_table(configs, ticks=10, device="cpu")
    assert len(rows) == 1 and rows[0]["window_s"] == 0.01


def test_microsim_wrapper_dispatches_by_device_without_fallback():
    """microsim_scan runs the plain tick loop on CPU tensors (no launch),
    refuses any other device, and has no path from a CUDA tensor back to
    the plain version."""
    import inspect
    from repro_torch.kernels import microsim_scan
    configs = microsim_scan.case_configs("t3", 1.0, "cpu")
    before = microsim_scan.microsim_scan.launches
    out = microsim_scan.microsim_scan(*configs, ticks=5)
    assert microsim_scan.microsim_scan.launches == before
    assert set(out) == {"lark", "base"}
    assert out["lark"]["per_tick_done"].shape == (12, 5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        microsim_scan.microsim_scan(*(c.to("meta") for c in configs),
                                    ticks=5)
    code = inspect.getsource(microsim_scan.microsim_scan).split('"""')[2]
    assert "except" not in code and code.count("_simulate_batch_plain") == 1
