"""The mLSTM backward: ``mlstm_chunkwise_bwd_plain`` (the CPU path of the
CUDA kernel csrc/mlstm_chunk_bwd.cu) against ``jax.vjp`` of the oracle
``repro.kernels.ref.mlstm_chunkwise`` and torch autograd through the
plain forward, on ragged S, S below the chunk, S = 1, a stabilizer
stress and rows where the clamp max(|den|, e^{-m}) holds; the
``torch.autograd.Function`` (gradcheck in float64, dispatch); and the
card-side check's plumbing: each planted fault's text once in the
source, the launcher's argtypes and scratch, and the allowance the card
holds the kernel to.

Inputs come from numpy with a seed.  Tolerance: atol 5e-5 / rtol 5e-4,
``tests/test_kernels.py``'s for the kernels, float32 on both sides, with
the atol taken of the output's largest magnitude (at least 1): the
gradient's sums cancel (den near 0, the pairs behind dlog_f), and on
these inputs the reference's own float32 gradient lies up to 2e-3 of
that magnitude from the float64 one, as the port's does."""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro_torch.kernels import _build
from repro_torch.kernels import mlstm_check as MC
from repro_torch.kernels import mlstm_chunk as T
from repro_torch.kernels import ops as TOPS

torch.set_num_threads(1)

ATOL, RTOL = 5e-5, 5e-4


def _inputs(seed, B, H, S, D, Dv=None, kind="gates"):
    rng = np.random.default_rng(seed)
    Dv = Dv or D
    q, k = (rng.standard_normal((B, H, S, D)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, S, Dv)).astype(np.float32)
    raw = rng.standard_normal((B, H, S))
    if kind == "stress":
        lf = -np.log1p(np.exp(-(raw + 8.0)))
        li = rng.uniform(-10, 10, (B, H, S))
    elif kind == "clamp":
        lf = -np.log1p(np.exp(-(raw * 2 + 2)))
        li = rng.standard_normal((B, H, S)) * 3 - 6
    else:
        lf = -np.log1p(np.exp(-(raw * 2 + 2)))
        li = rng.standard_normal((B, H, S)) * 3
    dh = rng.standard_normal((B, H, S, Dv)).astype(np.float32)
    return q, k, v, lf.astype(np.float32), li.astype(np.float32), dh


def _jax_vjp(q, k, v, lf, li, dh, chunk):
    f = jax.jit(lambda *a: jax.vjp(
        lambda *x: R.mlstm_chunkwise(*x, chunk=chunk)[0], *a[:5])[1](a[5]))
    return [np.asarray(g) for g in f(*map(jnp.asarray,
                                          (q, k, v, lf, li, dh)))]


CASES = [(1, 2, 64, 16, None, 16, "gates"),      # whole chunks
         (2, 2, 37, 8, 12, 16, "gates"),         # ragged S, Dq != Dv
         (1, 2, 10, 8, None, 16, "gates"),       # S below the chunk
         (1, 3, 1, 8, None, 16, "gates"),        # S = 1
         (1, 2, 48, 8, None, 16, "stress"),      # stabilizer spread
         (1, 2, 48, 8, None, 16, "clamp")]       # the clamp holds


@pytest.mark.parametrize("B,H,S,D,Dv,chunk,kind", CASES)
def test_bwd_plain_matches_jax_vjp_of_the_oracle(B, H, S, D, Dv, chunk,
                                                 kind):
    args = _inputs(B * 100 + S, B, H, S, D, Dv, kind)
    got = T.mlstm_chunkwise_bwd_plain(*map(torch.from_numpy, args),
                                      chunk=chunk)
    for g, w in zip(got, _jax_vjp(*args, chunk)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = max(1.0, np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL * scale,
                                   rtol=RTOL)


@pytest.mark.parametrize("kind", ["gates", "stress", "clamp"])
def test_bwd_plain_matches_autograd_through_the_plain_forward(monkeypatch,
                                                              kind):
    """In float64 (the plain forward's float32 casts made float64) the
    reverse loop equals autograd through the forward's cummax, max and
    clamp to rounding: the stabilizer's gradients sum to zero."""
    monkeypatch.setattr(T, "_f32", lambda *xs: tuple(a.double() for a in xs))
    args = [torch.from_numpy(a).double()
            for a in _inputs(3, 2, 2, 40, 8, 6, kind)]
    ins = [a.clone().requires_grad_() for a in args[:5]]
    h, _ = T.mlstm_chunkwise_plain(*ins, chunk=16)
    want = torch.autograd.grad(h, ins, args[5])
    got = T.mlstm_chunkwise_bwd_plain(*args, chunk=16)
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        torch.testing.assert_close(g, w, atol=1e-12 * scale, rtol=1e-10)


def test_function_gradcheck_in_float64(monkeypatch):
    monkeypatch.setattr(T, "_f32", lambda *xs: tuple(a.double() for a in xs))
    for kind in ("gates", "clamp"):
        args = [torch.from_numpy(a).double().requires_grad_()
                for a in _inputs(5, 1, 2, 11, 4, 3, kind)[:5]]
        assert torch.autograd.gradcheck(
            lambda *a: T.mlstm_chunkwise(*a, chunk=4)[0], args)
        assert torch.autograd.gradcheck(
            lambda *a: T.mlstm_chunkwise_reference(*a, chunk=4)[0], args)


def test_function_dispatches_by_device_and_marks_the_state():
    """On CPU tensors forward and backward run the plain versions once
    each and nothing launches; the final state has no gradient; an
    initial state with grad enabled raises."""
    q, k, v, lf, li, dh = map(torch.from_numpy, _inputs(6, 1, 2, 40, 8))
    ins = [a.clone().requires_grad_() for a in (q, k, v, lf, li)]
    counts = (T.mlstm_chunkwise_plain.calls, T.mlstm_chunkwise_bwd_plain.calls,
              T.mlstm_chunkwise.launches, T.mlstm_chunkwise_bwd.launches)
    h, (C, n, m) = TOPS.mlstm_chunkwise(*ins, chunk=16)
    assert h.grad_fn is not None
    assert not (C.requires_grad or n.requires_grad or m.requires_grad)
    h.backward(dh)
    assert (T.mlstm_chunkwise_plain.calls,
            T.mlstm_chunkwise_bwd_plain.calls) == (counts[0] + 1,
                                                   counts[1] + 1)
    assert (T.mlstm_chunkwise.launches,
            T.mlstm_chunkwise_bwd.launches) == counts[2:]
    want = T.mlstm_chunkwise_bwd_plain(q, k, v, lf, li, dh, chunk=16)
    for a, w in zip(ins, want):
        assert torch.equal(a.grad, w)
    with pytest.raises(NotImplementedError):
        T.mlstm_chunkwise(*ins, chunk=16, initial=(C, n, m))
    with torch.no_grad():
        h2, _ = T.mlstm_chunkwise(*ins, chunk=16, initial=(C, n, m))
        assert h2.grad_fn is None
    # meta tensors take the plain version's shapes (the dry run)
    got = T.mlstm_chunkwise_bwd(*(a.to("meta") for a in (q, k, v, lf, li,
                                                          dh)))
    assert [g.shape for g in got] == [w.shape for w in want]
    assert all(g.device.type == "meta" for g in got)


@pytest.mark.parametrize("fault", sorted(MC.BWD_FAULTS))
def test_each_backward_fault_text_occurs_once_in_the_source(fault):
    old, new = MC.BWD_FAULTS[fault]
    text = (_build.CSRC / "mlstm_chunk_bwd.cu").read_text()
    assert old != new and text.count(old) == 1


def test_backward_argtypes_and_scratch(monkeypatch):
    class Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    assert "mlstm_chunk_bwd" in _build.SOURCES
    text = (_build.CSRC / "mlstm_chunk_bwd.cu").read_text()
    m = re.search(r"int mlstm_chunk_bwd_launch\((.*?)\)", text, re.S)
    want = tuple(ctypes.c_void_p if "*" in prm else ctypes.c_int
                 for prm in m.group(1).split(","))
    assert tuple(T.BWD_ARGTYPES) == want
    q, k, v, lf, li, dh = map(torch.from_numpy, _inputs(2, 2, 3, 300, 40,
                                                        72))
    args, outs, tensors = T.bwd_launch_args(
        q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
        lf, li, dh, 128, fill=float("nan"))
    assert len(args) == len(T.BWD_ARGTYPES)
    assert args[-7:-1] == (6, 300, 40, 72, 128, 1)
    assert [o.dtype for o in outs] == [torch.bfloat16] * 3 + \
        [torch.float32] * 2
    assert all(o.isnan().all() for o in outs)
    assert tensors[5].dtype == torch.bfloat16         # dh in q's type
    # chunk-start states and their gradients: (BH, nC, Dq, Dv) float32
    assert tensors[15].shape == tensors[17].shape == (6, 3, 40, 72)
    assert tensors[15].dtype == tensors[17].dtype == torch.float32
    # C_c dh per position; a ticket per (b, h), int32
    assert tensors[19].shape == (6, 384, 40)
    assert tensors[23].shape == (6,) and tensors[23].dtype == torch.int32
    # the columns kernel holds every chunk up to 1152; at chunk 256 two of
    # its blocks fit an SM's 228 KB, 1 KB each aside
    assert T.bwd_smem_bytes(1152) <= T.SMEM_LIMIT < T.bwd_smem_bytes(1184)
    assert 2 * (T.bwd_smem_bytes(256) + 1024) <= 233472
    T.bwd_launch_args(q, k, v, lf, li, dh, 1024)
    with pytest.raises(ValueError, match="shared memory"):
        T.bwd_launch_args(q, k, v, lf, li, dh, 1280)


@pytest.mark.parametrize("kind", ["gates", "stress", "clamp"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_allowance_covers_float32_and_rejects_planted_errors(kind, dtype):
    """The float32 plain backward against float64 stays within an eighth
    of what the card's check allows in float32 (half, with bf16 outputs
    rounded); den's gradient dropped, or the inter-chunk decay of dC
    dropped, fails it.  The clamp kind holds the clamp on most rows, the
    others on few."""
    gen = torch.Generator()
    gen.manual_seed(9)
    args = MC.mlstm_bwd_inputs(gen, 1, 2, 200, 32, 24, dtype, kind)
    want, scales = MC.bwd_reference((*args, 64))
    errs = MC.mlstm_bwd_errors(
        T.mlstm_chunkwise_bwd_plain(*args, chunk=64), want, scales)
    assert max(errs.values()) <= (1 / 8 if dtype == torch.float32 else
                                  0.55), errs
    share = MC.clamp_rows(*args, 64)
    assert (share > 0.5) if kind == "clamp" else (share < 0.25), share
    chunks = T._bwd_chunks(*args, 64)
    scale = 1.0 / 32 ** 0.5
    rows = [T._bwd_rows(ch, scale) for ch in chunks]

    def outputs(parts):
        dq, dk, dv, R, Li = (torch.cat([p[i] for p in parts],
                                       dim=2)[:, :, :200] for i in range(5))
        return (dq.to(dtype), dk.to(dtype), dv.to(dtype),
                *T._bwd_gates(R, Li))

    no_dd = T._bwd_apply(chunks, [(i, d * 0) for i, d in rows], scale)
    assert max(MC.mlstm_bwd_errors(outputs(no_dd), want,
                                   scales).values()) > 1.0
    flat = [dict(ch, decay=torch.ones_like(ch["decay"])) for ch in chunks]
    no_decay = T._bwd_apply(flat, rows, scale)
    if kind != "stress":       # there the decay is within 1e-3 of 1
        assert max(MC.mlstm_bwd_errors(outputs(no_decay), want,
                                       scales).values()) > 1.0


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest on
    the low 13 mantissa bits of its float32 pattern, ties away from
    zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_einsum(split):
    """torch.einsum as csrc/mlstm_chunk_bwd.cu takes each product of two
    float32 matrices on the tensor cores: one TF32 product (split False),
    or a_hi b_hi + a_hi b_lo + a_lo b_hi, hi = tf32(x) and lo = tf32(x -
    hi), each product exact in float32, the sums in float32.  A product
    with a vector (q.n_c, dn's update) stays float32, as the kernel sums
    those on the CUDA cores."""
    einsum = torch.einsum

    def product(eq, a, b):
        if a.dim() < 4 or b.dim() < 4:
            return einsum(eq, a, b)
        ah, bh = _tf32(a), _tf32(b)
        if not split:
            return einsum(eq, ah, bh)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return einsum(eq, ah, bh) + (einsum(eq, ah, bl) +
                                     einsum(eq, al, bh))
    return product


@pytest.mark.parametrize("kind", ["gates", "stress", "clamp"])
@pytest.mark.parametrize("D,Dv,chunk", [(32, 32, 64), (64, 40, 48)])
def test_backward_check_rejects_one_tf32_product_and_accepts_the_split(
        monkeypatch, D, Dv, chunk, kind):
    """Why the backward splits each float32 operand in three TF32 terms:
    with ``mlstm_check``'s unchanged ``BWD_GAMMA``, the plain backward with
    every matrix product (the recomputed states, q k^T, dh v^T, C_c dh,
    dq, dk, dv and G's update) taken as one TF32 product fails on float32
    inputs, and taken through the three-term split passes every output;
    at the reduced xlstm's head dim and off the 32-wide pieces, several
    chunks and a ragged tail."""
    gen = torch.Generator()
    gen.manual_seed(33)
    args = MC.mlstm_bwd_inputs(gen, 1, 2, 200, D, Dv, torch.float32, kind)
    want, scales = MC.bwd_reference((*args, chunk))
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(False))
    one = T.mlstm_chunkwise_bwd_plain(*args, chunk=chunk)
    monkeypatch.setattr(torch, "einsum", _tf32_einsum(True))
    split = T.mlstm_chunkwise_bwd_plain(*args, chunk=chunk)
    monkeypatch.undo()
    assert max(MC.mlstm_bwd_errors(one, want, scales).values()) > 1.0
    errs = MC.mlstm_bwd_errors(split, want, scales)
    assert all(e <= 1.0 for e in errs.values()), errs
