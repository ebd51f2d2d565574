"""The port's RG-LRU recurrence against the reference.

``rglru_scan_plain`` (the CPU path of the CUDA kernel) against the oracle
``repro.kernels.ref.rglru_scan_ref`` and the Pallas ``rglru_scan`` in
interpret mode on ``tests/test_kernels.py``'s shapes, against the oracle
on a ragged S (which the Pallas wrapper rejects) and on bfloat16 input,
and against the one-step recurrence; ``rglru_step_plain`` against
``ref.rglru_step``; the wrapper's dispatch on the CPU; and the check the
card holds the kernel to (``rglru_check``): the float32 plain version
passes it against float64, each planted fault's arithmetic fails it.

Inputs come from numpy with a seed.  Tolerance: atol 1e-5 / rtol 1e-4,
``test_kernels.py``'s for this kernel (float32 sums in another order)."""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.rglru_scan import rglru_scan as pallas_rglru
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import rglru_check as RC
from repro_torch.kernels import rglru_scan as T

torch.set_num_threads(1)

ATOL, RTOL = 1e-5, 1e-4


def _inputs(seed, B, S, W, lo=0.01, hi=2.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    la = -rng.uniform(lo, hi, (B, S, W)).astype(np.float32)
    return x, la


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,S,W,bs,bw", [(1, 256, 128, 64, 128),
                                         (2, 512, 256, 128, 128)])
def test_plain_matches_oracle_and_pallas_interpret(B, S, W, bs, bw):
    x, la = _inputs(B * 1000 + S, B, S, W)
    h = T.rglru_scan_plain(torch.from_numpy(x), torch.from_numpy(la))
    assert h.dtype == torch.float32 and h.shape == (B, S, W)
    _close(h, R.rglru_scan_ref(jnp.asarray(x), jnp.asarray(la)))
    _close(h, pallas_rglru(jnp.asarray(x), jnp.asarray(la), block_s=bs,
                           block_w=bw, interpret=True))


def test_ragged_length_and_bfloat16_input_match_oracle():
    """Any S (the Pallas wrapper asserts S % block_s == 0 after clamping
    the block, so S = 300 fails there) and any float input type."""
    x, la = _inputs(7, 2, 300, 100)
    _close(T.rglru_scan_plain(torch.from_numpy(x), torch.from_numpy(la)),
           R.rglru_scan_ref(jnp.asarray(x), jnp.asarray(la)))
    with pytest.raises(AssertionError):
        pallas_rglru(jnp.asarray(x), jnp.asarray(la), interpret=True)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    got = T.rglru_scan_plain(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(la))
    assert got.dtype == torch.float32
    _close(got, R.rglru_scan_ref(jnp.asarray(x, jnp.bfloat16),
                                 jnp.asarray(la)))
    _close(got, R.rglru_scan_ref(jnp.asarray(xb), jnp.asarray(la)))


def test_step_matches_reference_and_scan():
    x, la = _inputs(3, 2, 64, 8, hi=1.0)
    xt, lat = torch.from_numpy(x), torch.from_numpy(la)
    h = torch.zeros((2, 8))
    hj = jnp.zeros((2, 8))
    for t in range(64):
        h = T.rglru_step_plain(xt[:, t], lat[:, t], h)
        hj = R.rglru_step(jnp.asarray(x[:, t]), jnp.asarray(la[:, t]), hj)
        _close(h, hj)
    _close(T.rglru_scan_plain(xt, lat)[:, -1], h)


def test_ops_dispatch_by_device_without_fallback():
    x, la = (torch.from_numpy(a) for a in _inputs(5, 1, 40, 16))
    calls, launches = T.rglru_scan_plain.calls, T.rglru_scan.launches
    h = TOPS.rglru_scan(x, la)
    assert T.rglru_scan_plain.calls == calls + 1
    assert T.rglru_scan.launches == launches          # plain path: no launch
    assert torch.equal(h, T.rglru_scan_plain(x, la))
    assert TOPS.rglru_step is T.rglru_step_plain
    # meta tensors (the dry run's traced step) take the plain version's
    # shapes, and launch nothing
    hm = TOPS.rglru_scan(x.to("meta"), la.to("meta"))
    assert hm.device.type == "meta" and hm.shape == h.shape
    assert T.rglru_scan.launches == launches
    with pytest.raises(ValueError, match="one shape"):
        TOPS.rglru_scan(x, la[:, :-1])
    with pytest.raises(TypeError):
        TOPS.rglru_scan(x.to(torch.int32), la)


def _chain(a, b, late):
    """h of the chunk chain where chunk c starts from the carry chunk
    c - 1 published (c - 2 with `late`), 0 before chunk 0."""
    carries, out = [], []
    for c, t0 in enumerate(range(0, a.shape[1], T.CHUNK)):
        p = c - (2 if late else 1)
        h = carries[p] if p >= 0 else torch.zeros_like(a[:, 0])
        for t in range(t0, min(a.shape[1], t0 + T.CHUNK)):
            h = a[:, t] * h + b[:, t]
            out.append(h)
        carries.append(h)
    return torch.stack(out, 1)


@pytest.mark.parametrize("kind", ["uniform", "model", "long", "short"])
def test_rounding_check_passes_float32_and_catches_the_faults(kind):
    """The float32 plain version lies within ``rglru_allowance`` of the
    float64 reference, with room for the kernel's other order; the
    arithmetic of the planted faults (the chain's carry across 64-position
    chunks read as 0 or one chunk late, the ragged last chunk left
    unwritten, the decay 1 % high, 1 - a for sqrt(1 - a^2)) does not.
    S = 300 leaves a last chunk of 44 positions."""
    S = 300
    gen = torch.Generator()
    gen.manual_seed(15)
    x, la = RC.rglru_inputs(gen, 2, S, 48, kind)
    want, allowed = RC.reference(x, la)
    assert RC.rglru_error(T.rglru_scan_plain(x, la), want, allowed) < 0.25
    dropped = torch.cat([T.rglru_scan_plain(x[:, c:c + 64], la[:, c:c + 64])
                         for c in range(0, S, 64)], dim=1)
    a = torch.exp(la)
    b = torch.sqrt(torch.clamp(1 - a * a, min=0)) * x
    unwritten = T.rglru_scan_plain(x, la)
    unwritten[:, S - S % 64:] = float("nan")
    h = torch.zeros_like(x[:, 0])
    h1 = torch.zeros_like(h)
    decay, one_minus = [], []
    for t in range(S):
        h = 1.01 * a[:, t] * h + b[:, t]
        h1 = a[:, t] * h1 + (1 - a[:, t]) * x[:, t]
        decay.append(h)
        one_minus.append(h1)
    faults = {"carry_dropped": dropped,
              "carry_one_chunk_late": _chain(a, b, late=True),
              "ragged_chunk_dropped": unwritten,
              "decay_1pct": torch.stack(decay, 1),
              "one_minus_a": torch.stack(one_minus, 1)}
    assert set(faults) == set(RC.FAULTS)
    assert RC.rglru_error(_chain(a, b, late=False), want, allowed) < 1.0
    failed = {name: RC.rglru_error(h, want, allowed) > 1.0
              for name, h in faults.items()}
    # a -> 0 forgets the carry within a chunk and makes 1 - a equal to
    # sqrt(1 - a^2); a -> 1 makes the carry error small against what
    # float32 allows there; each fault fails elsewhere
    chain = {"carry_dropped", "carry_one_chunk_late", "one_minus_a"}
    expect = {"uniform": chain, "model": chain, "long": set(),
              "short": set()}[kind] | {"decay_1pct", "ragged_chunk_dropped"}
    assert {n for n, f in failed.items() if f} >= expect, failed


@pytest.mark.parametrize("fault", sorted(RC.FAULTS))
def test_each_fault_text_occurs_once_in_the_source(fault):
    old, new = RC.FAULTS[fault]
    assert old != new
    assert (_build.CSRC / "rglru_scan.cu").read_text().count(old) == 1


@pytest.mark.parametrize("variant", sorted(RC.ABLATIONS))
def test_each_ablation_text_occurs_once_in_the_source(variant):
    text = (_build.CSRC / "rglru_scan.cu").read_text()
    for old, new in RC.ABLATIONS[variant]:
        assert old != new
        assert text.count(old) == 1


@pytest.mark.parametrize("argtypes,symbol,text", [
    (T._ARGTYPES, "rglru_scan_launch", None),
    (RC.PARENT_ARGTYPES, "rglru_scan_launch",
     "int rglru_scan_launch(const float* x, const float* log_a, float* h,\n"
     "                      float* Ac, float* Bc, float* Hin, int B, int S,"
     " int W,\n                      void* stream)")])
def test_argtypes_name_the_c_parameters(argtypes, symbol, text):
    """The launcher's argtypes, and the earlier three-launch interface's
    that ``rglru_check --parent`` uses, are their C parameters one for
    one (pointers and the stream c_void_p, ints c_int)."""
    if text is None:
        text = (_build.CSRC / "rglru_scan.cu").read_text()
    m = re.search(r"int " + symbol + r"\((.*?)\)", text, re.S)
    want = tuple(ctypes.c_void_p if "*" in prm else ctypes.c_int
                 for prm in m.group(1).split(","))
    assert tuple(argtypes) == want


def test_launch_args_lay_out_one_launch_and_its_scratch():
    """``launch_args`` (what the wrapper, ``rglru_check`` and
    ``chip_smoke.py`` launch) gives the pointers of a float32 h, x and
    log_a made contiguous float32, and one carry word per (b, chunk,
    channel) plus the ticket; ``parent_args`` the three-launch scratch."""
    x, la = (torch.from_numpy(v) for v in _inputs(2, 3, 130, 200))
    la_strided = la.transpose(1, 2).contiguous().transpose(1, 2)
    h, args, keep = T.launch_args(x.to(torch.bfloat16), la_strided,
                                  fill=7.0)
    assert len(args) + 1 == len(T._ARGTYPES)
    assert args[4:] == (3, 130, 200)
    assert h.shape == (3, 130, 200) and (h == 7.0).all()
    xk, lak, carry = keep
    assert [t.data_ptr() for t in (xk, lak, h, carry)] == list(args[:4])
    assert xk.dtype == lak.dtype == torch.float32
    assert xk.is_contiguous() and lak.is_contiguous()
    assert torch.equal(lak, la)
    assert carry.dtype == torch.int64 and carry.numel() == 3 * 3 * 200 + 1
    with pytest.raises(ValueError, match="2\\^31"):
        T.launch_args(x[:, :0], la[:, :0])
    hp, pargs, pkeep = RC.parent_args(x, la)
    assert len(pargs) + 1 == len(RC.PARENT_ARGTYPES)
    assert [t.shape for t in pkeep[2:]] == [(3, 3, 200)] * 3
    assert pargs[2] == hp.data_ptr() and pargs[6:] == (3, 130, 200)


def test_first_difference_names_the_first_differing_bits():
    a = torch.zeros((2, 3, 4))
    assert RC.first_difference(a, a.clone()) is None
    b = a.clone()
    b[1, 2, 0] = -0.0                 # equal as floats, not as bits
    b[1, 2, 3] = 5.0
    diff = RC.first_difference(a, b)
    assert diff["index"] == [1, 2, 0] and diff["count"] == 2
    assert RC.rglru_error(torch.full((1, 2, 1), float("nan")),
                          torch.zeros((1, 2, 1), dtype=torch.float64),
                          torch.ones((1, 2, 1), dtype=torch.float64)) \
        == float("inf")
