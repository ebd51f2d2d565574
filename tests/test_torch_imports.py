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
