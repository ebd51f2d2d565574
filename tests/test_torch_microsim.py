"""The port's §5.2 micro-simulator (``core/microsim.py``,
``kernels/microsim_scan.py``, ``microsim_tables.py``) against the
reference's ``_sim_jit`` as XLA compiles it for the CPU: every output
equal bit for bit for the 12 grid rows of both tables, LARK and
baseline, at the paper's constants and with a short outage; the table
rows and printed lines equal; the fused multiply-adds correctly rounded;
the integer-count invariant the kernel's reductions rely on; and the
kernel's planted faults and C interface."""
import ctypes
import importlib.util
import re
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import microsim as ref
from repro_torch import microsim_tables
from repro_torch.core import microsim as port
from repro_torch.kernels import microsim_scan as ms

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / \
    "microsim_scan.cu"
CASES = {name: (ticks, fail_t, recover_t, scale)
         for name, ticks, fail_t, recover_t, scale in ms.CASES}


def _ref_outputs(configs, is_lark, ticks):
    arrs = [jnp.asarray(c.numpy()) for c in configs]
    return {k: np.asarray(v)
            for k, v in ref._sim_jit(*arrs, is_lark, ticks, 0).items()}


def _bitwise_equal(got, want):
    for k in want:
        g = got[k].numpy() if torch.is_tensor(got[k]) else got[k]
        assert g.dtype == np.float32 and g.shape == want[k].shape, k
        assert np.array_equal(g.view(np.uint32), want[k].view(np.uint32)), \
            (k, np.argwhere(g != want[k])[:3])


@pytest.fixture
def short_outage(monkeypatch):
    """Both modules' outage constants shortened to the short_outage
    case's.  The reference reads them when _sim_jit traces, so its
    compiled loops are dropped before and after."""
    _, fail_t, recover_t, _ = CASES["short_outage"]
    jax.clear_caches()
    for mod in (ref, port):
        monkeypatch.setattr(mod, "FAIL_T", fail_t)
        monkeypatch.setattr(mod, "RECOVER_T", recover_t)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("mode", ms.MODES)
@pytest.mark.parametrize("table", sorted(port.TABLES))
def test_plain_equals_reference_paper_constants(table, mode):
    ticks, _, _, scale = CASES["paper_constants"]
    configs = ms.case_configs(table, scale, "cpu")
    want = _ref_outputs(configs, mode == "lark", ticks)
    counts = []
    got = port._simulate_batch_plain(*configs, mode == "lark", ticks, 0,
                                     check_counts=counts)
    _bitwise_equal(got, want)
    # arrivals, the failure at 2 s and (baseline) the pause all happen
    assert want["per_tick_done"].sum() > 0
    if mode == "base":
        assert (want["per_tick_done"][:, 2500:] == 0).any()
    assert len(counts) == ticks and all(counts)


@pytest.mark.parametrize("mode,scale", [("lark", 1e-3), ("base", 1e-3),
                                        ("lark", 1.0)])
@pytest.mark.parametrize("table", sorted(port.TABLES))
def test_plain_equals_reference_short_outage(table, mode, scale,
                                             short_outage):
    ticks, _, recover_t, _ = CASES["short_outage"]
    configs = ms.case_configs(table, scale, "cpu")
    want = _ref_outputs(configs, mode == "lark", ticks)
    counts = []
    got = port._simulate_batch_plain(*configs, mode == "lark", ticks, 0,
                                     check_counts=counts)
    _bitwise_equal(got, want)
    assert all(counts)
    if mode == "lark":
        pend = want["pending_ts"]
        assert (pend[:, recover_t] > 0.5).all()          # backfill starts
        if scale < 1.0:
            assert (pend[:, -1] < 0.5).all()             # and ends


def test_cohort_counts_are_exact_integers():
    """The invariant behind the kernel's reductions, on the heaviest row
    (t4 at 50 MB/s and 1 KB records, 33 arrivals a tick) and on every
    row: cohort counts integer in [0, MAX_ARR], sums integer and below
    2^24, so float32 adds them exactly in any order."""
    assert port.AGES * 2 * port.MAX_ARR < 2 ** 24
    configs = ms.case_configs("t4", 1.0, "cpu")
    counts = []
    out = port._simulate_batch_plain(*configs, True, 600, 0,
                                     check_counts=counts)
    assert all(counts) and len(counts) == 600
    assert out["per_tick_done"][1].max() >= 30
    assert not port._counts_exact(torch.tensor([[0.5]]), torch.tensor([1.]),
                                  torch.tensor([1.]))
    assert not port._counts_exact(torch.tensor([[65.]]), torch.tensor([1.]),
                                  torch.tensor([1.]))


def test_wrapper_on_cpu_runs_plain_both_modes():
    configs = ms.case_configs("t3", 1.0, "cpu")
    before = ms.microsim_scan.launches
    got = ms.microsim_scan(*configs, ticks=300)
    assert ms.microsim_scan.launches == before
    for mode in ms.MODES:
        _bitwise_equal(got[mode],
                       _ref_outputs(configs, mode == "lark", 300))


@pytest.fixture(scope="module")
def ref_tables_module():
    spec = importlib.util.spec_from_file_location(
        "ref_microsim_tables", ROOT / "benchmarks" / "microsim_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tables_lines_equal_reference_at_3000_ticks(ref_tables_module,
                                                    monkeypatch, capsys):
    """The reference's main() prints its own 3,000-tick run; the port's
    lines of its own run are the same strings."""
    run = ref_tables_module.run
    monkeypatch.setattr(ref_tables_module, "run",
                        lambda ticks: run(ticks=3000))
    ref_tables_module.main()
    want = capsys.readouterr().out.splitlines()
    got = microsim_tables.lines(microsim_tables.run(ticks=3000,
                                                    device="cpu"))
    assert len(got) == 24 and got == want
    assert microsim_tables.PAPER_T3 == ref_tables_module.PAPER_T3
    assert microsim_tables.PAPER_T4 == ref_tables_module.PAPER_T4
    assert port.TABLES == ref_tables_module.TABLES


def test_run_table_rows_equal_reference():
    configs = port.table_configs(0.8, 1.0)[:4]
    want = ref.run_table(configs, ticks=2100)
    got = port.run_table(configs, ticks=2100, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


def test_committed_reference_lines():
    lines = microsim_tables.reference_lines()
    header = microsim_tables.REF_LINES.read_text().splitlines()[0]
    assert header.startswith("# ") and "benchmarks/microsim_tables.py" in \
        header and "jax 0.9.0" in header
    assert len(lines) == 24
    assert [ln.split(",")[:2] for ln in lines] == \
        [[f"microsim_{t}", f"row{i}"] for t in ("t3", "t4")
         for i in range(1, 13)]


def test_constants_and_grid_match_reference():
    for name in ("TICKS_PER_S", "FAIL_T", "RECOVER_T", "AGES", "MAX_ARR",
                 "TABLE_GRID"):
        assert getattr(port, name) == getattr(ref, name)
    c = port.MicroConfig(rs=1e3, ps=1e9, bw=5e6, u=0.5, lf=0.5)
    r = ref.MicroConfig(rs=1e3, ps=1e9, bw=5e6, u=0.5, lf=0.5)
    assert (c.avg_req_bytes, c.arrival_rate) == \
        (r.avg_req_bytes, r.arrival_rate)
    assert [vars(x) for x in port.table_configs(0.8, 1.0)] == \
        [vars(x) for x in ref.table_configs(0.8, 1.0)]


def _round_f32(x: Fraction) -> np.float32:
    """`x` rounded to nearest float32, ties to even."""
    f = np.float32(float(x))
    lo, hi = sorted((f, np.nextafter(f, np.float32(np.inf) if Fraction(
        float(f)) < x else np.float32(-np.inf))))
    dl, dh = x - Fraction(float(lo)), Fraction(float(hi)) - x
    if dl != dh:
        return lo if dl < dh else hi
    return lo if lo.view(np.uint32) % 2 == 0 else hi


def test_fma_f32_is_correctly_rounded():
    """Against exact rational arithmetic on random triples, products near
    the addend's scale (where one rounding and two differ) included."""
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)) \
        .astype(np.float32)
    b = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)) \
        .astype(np.float32)
    c = np.where(rng.random(n) < 0.5, -(a * b),
                 rng.standard_normal(n) * 10.0 ** rng.integers(-3, 4, n)) \
        .astype(np.float32)
    got = port.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    differs = 0
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        want = _round_f32(exact)
        assert g.view(np.uint32) == want.view(np.uint32), (x, y, z)
        differs += want != np.float32(x * y) + z
    assert differs > 100


def test_fma_f32_matches_xla_contraction():
    """XLA on the CPU contracts the outage update's shape okeys + w *
    (1 - okeys / n) into one fused multiply-add, as the port writes it."""
    rng = np.random.default_rng(1)
    okeys = (rng.random(20000) * 10).astype(np.float32)
    w = (rng.random(20000) * 10).astype(np.float32)
    n = (rng.random(20000) * 20 + 1).astype(np.float32)
    want = np.asarray(jax.jit(lambda o, w, n: o + w * (1.0 - o / n))(
        okeys, w, n))
    o_t, w_t, n_t = (torch.from_numpy(x) for x in (okeys, w, n))
    got = port.fma_f32(w_t, 1.0 - o_t / n_t, o_t).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    unfused = (o_t + w_t * (1.0 - o_t / n_t)).numpy()
    assert (unfused != want).sum() > 1000


def test_planted_faults_each_found_once():
    src = SOURCE.read_text()
    for name, (old, new) in ms.FAULTS.items():
        assert src.count(old) == 1, name
        assert old != new


def test_source_uses_fma_exactly_where_xla_does():
    src = SOURCE.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert code.count("__fmaf_rn(") == 3
    assert "--use_fast_math" not in ms._build.NVCC_FLAGS
    assert "microsim_scan" in ms._build.SOURCES


def test_launcher_signature_matches_argtypes():
    src = SOURCE.read_text()
    sig = re.search(r'extern "C" int microsim_scan_launch\(([^)]*)\)', src)
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == len(ms._ARGTYPES)
    for p, t in zip(params, ms._ARGTYPES):
        if "*" in p or p.startswith("cudaStream_t"):
            assert t is ctypes.c_void_p, p
        elif p.startswith("uint32_t"):
            assert t is ctypes.c_uint32, p
        else:
            assert p.startswith("int ") and t is ctypes.c_int, p


def test_work_counts():
    nbytes, flops, iops = ms.work(12, 520_000)
    assert nbytes == 4 * (6 * 12 + 4 * 12 * 520_000 + 2 * 12 * 512 + 24)
    # the arrivals' hashes once per row (both modes share them), and the
    # key chain's two a tick once per launch
    assert (flops, iops) == (24 * 520_000 * 4 * 1024,
                             (12 * 64 + 2) * 520_000 * 80)
    with pytest.raises(ValueError, match="2\\^31"):
        ms.launch_args(*ms.case_configs("t3", 1.0, "cpu"), ticks=2 ** 30)


def test_wrapper_checks_and_refuses_other_devices():
    configs = ms.case_configs("t3", 1.0, "cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ms.microsim_scan(*(c.to("meta") for c in configs), ticks=10)
    with pytest.raises(TypeError, match="float32"):
        ms.microsim_scan(*(c.double() for c in configs), ticks=10)
    with pytest.raises(ValueError, match="one device"):
        ms.microsim_scan(configs[0][:3], *configs[1:], ticks=10)
