"""The RG-LRU backward: ``rglru_scan_bwd_plain`` (the CPU path of the
CUDA kernel csrc/rglru_scan_bwd.cu) against ``jax.vjp`` of the oracle
``repro.kernels.ref.rglru_scan_ref`` and torch autograd through the plain
forward; the clamp region, where the reference's gradient is not finite
and the port's is pinned; the ``torch.autograd.Function`` (gradcheck in
float64, dispatch); and the card-side check's plumbing: each planted
fault's text once in the source, the launcher's argtypes, and the
allowance the card holds the kernel to.

Inputs come from numpy with a seed.  Tolerance: atol 5e-5 / rtol 5e-4,
``tests/test_kernels.py``'s for the kernels (float32 sums in another
order)."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import rglru_check as RC
from repro_torch.kernels import rglru_scan as T

torch.set_num_threads(1)

ATOL, RTOL = 5e-5, 5e-4


def _inputs(seed, B, S, W, lo=0.01, hi=2.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, W)).astype(np.float32)
    la = -rng.uniform(lo, hi, (B, S, W)).astype(np.float32)
    dh = rng.standard_normal((B, S, W)).astype(np.float32)
    return x, la, dh


@jax.jit
def _vjp(x, la, dh):
    return jax.vjp(R.rglru_scan_ref, x, la)[1](dh)


def _jax_vjp(x, la, dh):
    return [np.asarray(g) for g in _vjp(*map(jnp.asarray, (x, la, dh)))]


def _port(x, la, dh):
    xt, lat, dht = (torch.from_numpy(a) for a in (x, la, dh))
    h = T.rglru_scan_plain(xt, lat)
    return T.rglru_scan_bwd_plain(xt, lat, h, dht)


@pytest.mark.parametrize("B,S,W,lo,hi", [(1, 256, 128, 0.01, 2.0),
                                         (2, 300, 100, 0.01, 2.0),
                                         (2, 65, 3, 1e-4, 0.05),
                                         (1, 1, 7, 0.01, 2.0)])
def test_bwd_plain_matches_jax_vjp_of_the_oracle(B, S, W, lo, hi):
    x, la, dh = _inputs(B * 100 + S, B, S, W, lo, hi)
    got = _port(x, la, dh)
    for g, w in zip(got, _jax_vjp(x, la, dh)):
        assert g.dtype == torch.float32 and g.shape == (B, S, W)
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=RTOL)


def test_bwd_plain_matches_autograd_through_the_plain_forward():
    x, la, dh = (torch.from_numpy(a).double()
                 for a in _inputs(4, 2, 130, 9))
    xi, lai = x.clone().requires_grad_(), la.clone().requires_grad_()
    h = T.rglru_scan_plain(xi, lai)
    want = torch.autograd.grad(h, (xi, lai), dh)
    got = T.rglru_scan_bwd_plain(x, la, h.detach(), dh)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        torch.testing.assert_close(g, w, atol=1e-12, rtol=1e-12)


def test_clamp_region_pins_the_port_and_records_the_reference():
    """Where 1 - exp(2 log_a) rounds to 0 in float32 (log_a 0, -1e-9,
    -1e-8), the port takes dlog_a = g h_{t-1} a (the clamped branch's
    derivative) and dx = 0; the reference's autodiff meets the
    derivative of sqrt at 0 and gives a value that is not finite there,
    while it agrees with the port everywhere else."""
    x, la, dh = _inputs(9, 1, 40, 6)
    la[0, 5:20, 2] = 0.0
    la[0, 20:30, 2] = -1e-9
    la[0, 30:40, 2] = -1e-8
    clamped = np.zeros(la.shape, bool)
    clamped[0, 5:40, 2] = True
    assert np.all(1.0 - np.exp(2.0 * la[clamped]) <= 0)   # float32
    dx, dla = _port(x, la, dh)
    jdx, jdla = _jax_vjp(x, la, dh)
    assert not np.isfinite(jdla[clamped]).any()
    assert np.all(dx.numpy()[clamped] == 0.0)
    # dla there is its first term alone: g h_{t-1} a, with g the reverse
    # recurrence (a = 1 here, so g_t is the suffix sum of dh)
    xt, lat, dht = (torch.from_numpy(a) for a in (x, la, dh))
    h = T.rglru_scan_plain(xt, lat)
    g = torch.zeros(40)
    gs = torch.empty(40)
    a = torch.exp(lat[0, :, 2])
    for t in range(39, -1, -1):
        g = dht[0, t, 2] + (a[t + 1] * g if t < 39 else 0.0)
        gs[t] = g
    want = gs[5:] * h[0, 4:39, 2] * a[5:]
    torch.testing.assert_close(dla[0, 5:, 2], want, atol=1e-6, rtol=1e-6)
    # elsewhere the two agree as in the test above
    ok = ~clamped
    ok[0, :, 2] = False      # the column's gradient flows through g
    np.testing.assert_allclose(dla.numpy()[ok], jdla[ok], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(dx.numpy()[ok], jdx[ok], atol=ATOL,
                               rtol=RTOL)


def test_function_gradcheck_in_float64():
    x, la, _ = (torch.from_numpy(a).double() for a in _inputs(5, 2, 9, 3))
    assert torch.autograd.gradcheck(
        T.rglru_scan, (x.requires_grad_(), la.requires_grad_()))
    assert torch.autograd.gradcheck(
        T.rglru_scan_reference, (x, la))


def test_function_backward_dispatches_by_device():
    """On CPU tensors the Function's forward and backward run the plain
    versions, once each, and nothing launches; the gradient is in the
    inputs' dtypes."""
    x, la, dh = (torch.from_numpy(a) for a in _inputs(6, 2, 70, 5))
    x = x.to(torch.bfloat16).requires_grad_()
    la = la.requires_grad_()
    counts = (T.rglru_scan_plain.calls, T.rglru_scan_bwd_plain.calls,
              T.rglru_scan.launches, T.rglru_scan_bwd.launches)
    h = TOPS.rglru_scan(x, la)
    assert h.grad_fn is not None
    h.backward(dh)
    assert (T.rglru_scan_plain.calls, T.rglru_scan_bwd_plain.calls) == \
        (counts[0] + 1, counts[1] + 1)
    assert (T.rglru_scan.launches, T.rglru_scan_bwd.launches) == counts[2:]
    assert x.grad.dtype == torch.bfloat16 and la.grad.dtype == torch.float32
    with torch.no_grad():
        assert TOPS.rglru_scan(x, la).grad_fn is None
    # meta tensors take the plain version's shapes (the dry run)
    got = T.rglru_scan_bwd(x.to("meta"), la.to("meta"), h.to("meta"),
                           dh.to("meta"))
    assert [g.shape for g in got] == [x.shape, la.shape]
    assert all(g.device.type == "meta" for g in got)
    with pytest.raises(ValueError, match="shape"):
        T.rglru_scan_bwd(x, la, h[:, 1:], dh)


@pytest.mark.parametrize("fault", sorted(RC.BWD_FAULTS))
def test_each_backward_fault_text_occurs_once_in_the_source(fault):
    text = (_build.CSRC / "rglru_scan_bwd.cu").read_text()
    edits = RC.BWD_FAULTS[fault]
    for old, new in [edits] if isinstance(edits[0], str) else edits:
        assert old != new and text.count(old) == 1


@pytest.mark.parametrize("variant", sorted(RC.BWD_ABLATIONS))
def test_each_backward_ablation_text_occurs_once_in_the_source(variant):
    text = (_build.CSRC / "rglru_scan_bwd.cu").read_text()
    for old, new in RC.BWD_ABLATIONS[variant]:
        assert old != new and text.count(old) == 1


def test_backward_is_timed_at_the_train_paths_microbatch():
    """chip_smoke.py's train_rg cell cuts its batch into microbatches, so
    each rglru_scan_bwd launch of its main path has B = batch /
    microbatches rows of S positions and lru_width channels: that shape
    is among the timed ones."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import get_config
    arch, _, batch, S, _, nmb, _ = chip_smoke.TRAIN_CELLS["train_rg"]
    assert batch % nmb == 0
    shape = (batch // nmb, S, get_config(arch).lru_width)
    assert shape == (1, 2048, 4096)
    assert shape in RC.BWD_TIMED_SHAPES


@pytest.mark.parametrize("name,n_args", [("rglru_scan", 8),
                                         ("rglru_scan_bwd", 11)])
def test_signature_parser_binds_each_source(name, n_args):
    """``rglru_check --parent`` binds a parent's sources by the launcher
    signature their own text declares: today's one-launch forward (8
    parameters) and the backward (11), each the wrapper's argtypes; the
    forward's earlier three-launch interface (10) maps to
    ``PARENT_ARGTYPES`` and its own argument layout."""
    text = (_build.CSRC / f"{name}.cu").read_text()
    got = RC.launcher_argtypes(text, f"{name}_launch")
    assert len(got) == n_args
    assert got == tuple({"rglru_scan": T._ARGTYPES,
                         "rglru_scan_bwd": T.BWD_ARGTYPES}[name])
    if name == "rglru_scan":
        assert RC.FORWARD_ARGS[got] is T.launch_args
        old = ("int rglru_scan_launch(const float* x, const float* log_a, "
               "float* h,\n    float* Ac, float* Bc, float* Hin, int B, int "
               "S, int W,\n    void* stream) {")
        three = RC.launcher_argtypes(old, "rglru_scan_launch")
        assert three == tuple(RC.PARENT_ARGTYPES)
        assert RC.FORWARD_ARGS[three] is RC.parent_args


def test_backward_argtypes_name_the_c_parameters():
    assert "rglru_scan_bwd" in _build.SOURCES
    text = (_build.CSRC / "rglru_scan_bwd.cu").read_text()
    m = re.search(r"int rglru_scan_bwd_launch\((.*?)\)", text, re.S)
    want = tuple(ctypes.c_void_p if "*" in prm else ctypes.c_int
                 for prm in m.group(1).split(","))
    assert tuple(T.BWD_ARGTYPES) == want


def test_bwd_launch_args_lay_out_one_launch():
    x, la, dh = (torch.from_numpy(a) for a in _inputs(2, 3, 130, 200))
    h = T.rglru_scan_plain(x, la)
    (dx, dla), args, keep = T.bwd_launch_args(x.to(torch.bfloat16), la, h,
                                              dh, fill=float("nan"))
    assert dx.shape == dla.shape == x.shape
    assert dx.dtype == dla.dtype == torch.float32 and dx.isnan().all()
    assert args[-3:] == (3, 130, 200)
    assert args[4:6] == (dx.data_ptr(), dla.data_ptr())
    assert keep[0].dtype == torch.float32 and keep[0].is_contiguous()
    # one carry word per (b, chunk of BWD_CHUNK positions, channel) and
    # the ticket; BWD_CHUNK is the source's kChunk
    text = (_build.CSRC / "rglru_scan_bwd.cu").read_text()
    assert f"constexpr int kChunk = {T.BWD_CHUNK};" in text
    assert keep[-1].numel() == 3 * -(-130 // T.BWD_CHUNK) * 200 + 1


@pytest.mark.parametrize("kind", ["uniform", "model", "long", "zero"])
def test_allowance_covers_float32_and_rejects_a_one_percent_error(kind):
    """The float32 plain backward against float64 stays within half of
    what the card's check allows on each gate kind of ``BWD_CASES`` (near
    log_a = 0 within all of it: there float32 may take the clamp's 0 for
    a large float64 term, which the allowance admits whole); dx 1 % high,
    or h_t read for h_{t-1}, fails it."""
    gen = torch.Generator()
    gen.manual_seed(8)
    x, la, h, dh = RC.rglru_bwd_inputs(gen, 2, 150, 40, kind)
    want, allowed = RC.bwd_reference(x, la, h, dh)
    dx, dla = T.rglru_scan_bwd_plain(x, la, h, dh)
    assert RC.rglru_bwd_error((dx, dla), want, allowed) <= 0.5 or \
        kind == "zero"
    assert RC.rglru_bwd_error((dx, dla), want, allowed) <= 1.0
    if kind == "zero":
        return      # h is near 0 there: the faults show on the other kinds
    assert RC.rglru_bwd_error((dx * 1.01, dla), want, allowed) > 1.0
    shifted = torch.cat([h[:, 1:], h[:, -1:]], dim=1)
    assert RC.rglru_bwd_error(T.rglru_scan_bwd_plain(x, la, shifted, dh),
                              want, allowed) > 1.0
