"""The port's examples (``repro_torch.examples``) against the reference's
``examples/*.py`` and library, on the CPU.

* ``rolling_restart``: its printed lines equal the reference script's
  (``runpy`` of ``examples/rolling_restart.py``), line for line, and so
  do the lines ``chip_smoke.py`` pins for the card.
* ``quickstart``: its protocol lines equal the reference script's first
  part (executed up to its training part) for the same calls; its five
  losses are finite.
* ``outage_timeseries.run(ticks=3000)``: Table 3 row 3 equal to the
  reference's ``run_table`` at 3,000 ticks field by field (its per-tick
  series bit for bit), the checkpoint commits equal the reference
  stores', and the Monte Carlo's u_lark, u_maj, trial 0's trajectory and
  per-bucket peaks equal the reference engine's numpy backend with the
  example's knobs, bit for bit.
* ``serve_kv`` resumes after the server failure; ``train_lm`` (16 steps)
  commits LARK checkpoints through the worker failure while the
  quorum-log baseline pauses.
* Without a card, each example's default device raises.
"""
import importlib
import io
import runpy
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.examples import outage_timeseries as OT
from repro_torch.examples import quickstart, rolling_restart, serve_kv, \
    train_lm

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("quickstart", "rolling_restart", "outage_timeseries", "serve_kv",
         "train_lm")

torch.set_num_threads(2)


def _lines(fn, *args, **kw):
    """(fn's printed lines, its result)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = fn(*args, **kw)
    return buf.getvalue().splitlines(), out


def test_rolling_restart_prints_the_reference_lines():
    want, _ = _lines(runpy.run_path, str(ROOT / "examples" /
                                         "rolling_restart.py"))
    got, out = _lines(rolling_restart.run, device="cpu")
    assert got == want
    assert out["writes"] == 40 and out["reads_ok"] == 8
    assert out["unavailable"] == 0 and out["linearizable"]


def test_chip_smoke_pins_the_rolling_restart_lines():
    """chip_smoke.py holds the example's lines on the card machine, which
    has no JAX, against pinned strings: the reference script's."""
    import sys
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    want, _ = _lines(runpy.run_path, str(ROOT / "examples" /
                                         "rolling_restart.py"))
    assert chip_smoke.ROLLING_RESTART_LINES == want


def test_quickstart_protocol_lines_equal_the_reference():
    src = (ROOT / "examples" / "quickstart.py").read_text()
    head = src.split("# --- 2.")[0]
    want, _ = _lines(exec, compile(head, "quickstart_head", "exec"), {})
    got, out = _lines(quickstart.run, device="cpu")
    assert len(want) == 4
    assert got[:4] == want
    assert len(out["losses"]) == 5
    assert all(np.isfinite(out["losses"]))
    assert got[4:] == [f"step {i}: loss {x:.4f}"
                       for i, x in enumerate(out["losses"])]


@pytest.fixture(scope="module")
def outage():
    return _lines(OT.run, ticks=3000, device="cpu")


def test_outage_microsim_row_equals_the_reference(outage):
    from repro.core.microsim import MicroConfig, run_table
    _, out = outage
    want = run_table([MicroConfig(rs=1e3, ps=1e9, bw=5e6, u=0.5, lf=0.5)],
                     ticks=3000)[0]
    got = out["row"]
    for k in ("window_s", "throughput_ratio", "lark_backfill_s",
              "base_down_s"):
        assert got[k] == want[k], k
    for mode in ("lark", "base"):
        assert got[mode] == want[mode], mode
    for k in ("lark_ts", "base_ts"):
        assert np.array_equal(got[k], want[k]), k


def test_outage_store_commits_equal_the_reference(outage):
    from repro.checkpoint import LarkStore, QuorumLogStore
    _, out = outage
    lark = LarkStore(num_nodes=4, rf=2, num_partitions=32)
    base = QuorumLogStore(num_nodes=4, rf=2, num_partitions=32,
                          partition_bytes=1e9, bandwidth=5e6)
    lark_ok = base_ok = 0
    for step in range(OT.N_STEPS):
        if step == 10:
            lark.fail_node(3)
            base.fail_node(3)
        if step == 40:
            lark.recover_node(3)
            base.recover_node(3)
        base.advance(10.0)
        lark_ok += lark.put(f"ckpt/step{step}", step)
        base_ok += base.put(f"ckpt/step{step}", step)
    assert (out["lark_ok"], out["base_ok"]) == (lark_ok, base_ok)
    assert lark_ok == OT.N_STEPS > base_ok         # the baseline paused


def test_outage_monte_carlo_equals_the_reference(outage):
    from repro.core.availability_batched import \
        simulate_availability_batched
    lines, out = outage
    ref = simulate_availability_batched(**OT.MC, backend="numpy")
    assert (out["u_lark"], out["u_maj"]) == (ref.u_lark, ref.u_maj)
    for k, got in out["trajectory"].items():
        want = ref.trajectory[k][:, 0]
        assert got.dtype == want.dtype and np.array_equal(got, want), k
    t = ref.trajectory["times"][:, 0]
    for name, key in (("LARK", "unavail_lark"), ("MAJ", "unavail_maj")):
        want = OT.bucket_peaks(t, ref.trajectory[key][:, 0])
        assert np.array_equal(out["peaks"][name], want), name
    # the rolling restart takes partitions down under the majority
    # baseline more than under LARK
    assert out["peaks"]["MAJ"].max() > out["peaks"]["LARK"].max()
    assert lines[-1].startswith("MAJ  |") and \
        f"(peak {int(out['peaks']['MAJ'].max())} partitions down)" in \
        lines[-1]


def test_serve_kv_resumes_after_the_failure():
    lines, out = _lines(serve_kv.run, device="cpu")
    assert out["resumed"] is not None
    assert out["resumed"].shape[0] == out["generated"].shape[0]
    assert any(line.startswith("server 0 failed") for line in lines)


def test_train_lm_commits_through_the_worker_failure(tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    lines, out = _lines(train_lm.run, steps=16, device="cpu")
    recs = {r["step"]: r for r in out["metrics"]}
    assert len(recs) == 16
    # worker 3 fails at step 8: LARK commits before and after, the
    # baseline pauses for its hydration window (ckpt/15 has worker 3 as
    # a replica)
    assert recs[0]["lark_commit"] and recs[0]["baseline_commit"]
    assert recs[15]["lark_commit"] and not recs[15]["baseline_commit"]
    assert lines[-1] == (f"loss {out['first']:.3f} -> {out['last']:.3f} "
                         f"({'OK' if out['last'] < out['first'] else 'WARN'})")
    assert (tmp_path / "results" / "train" / "smollm_360m" /
            "metrics.json").exists()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the default device is a card here")
@pytest.mark.parametrize("name", NAMES)
def test_the_default_device_raises_without_a_card(name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.run()
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main([])
