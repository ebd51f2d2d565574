"""The port's flash-attention forward against the reference.

``flash_attention_plain`` (the CPU path of the CUDA kernel) against the
Pallas ``flash_attention`` in interpret mode and the oracle
``repro.kernels.ref.attention_ref`` on transposed inputs, on
``tests/test_kernels.py``'s shapes, types and masks with its tolerances
(2e-5 float32, 2e-2 bfloat16); where the kernel and the oracle differ
(Sq != Sk: the kernel's causal mask is left-aligned, the oracle's right-
aligned; rows no key may attend: 0 against an average) the port follows
the kernel; a ragged S, which the Pallas wrapper rejects; the wrapper's
dispatch on the CPU and its choice of CUDA source (``_route``); and the
check the card holds the kernel to (``flash_check``): the plain version
passes it against float64, a window one key too wide fails it, p rounded
to bf16 before p v fails it and the sm90 kernel's hi/lo split of p passes
it, one TF32 product for q k^T and p v fails it and the simt kernel's
three-term TF32 split passes it (TF32 rounding emulated on the float32
bits); every planted fault's text occurs once in its source.

Inputs come from numpy with a seed."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as T
from repro_torch.kernels import flash_check as FC
from repro_torch.kernels import ops as TOPS

torch.set_num_threads(1)


def _qkv(seed, shapes, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    return tuple(np.array(jnp.asarray(rng.standard_normal(s), dtype)
                           .astype(jnp.float32)) for s in shapes)


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _t(x):
    """(B, H, S, D) <-> (B, S, H, D)."""
    return jnp.swapaxes(jnp.asarray(x), 1, 2)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,H,S,D", [(1, 1, 128, 32), (2, 3, 256, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
def test_plain_matches_pallas_interpret_and_oracle(B, H, S, D, dtype, causal,
                                                   window):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    q, k, v = _qkv(S + D, [(B, H, S, D)] * 3, jdt)
    out = T.flash_attention_plain(_torch(q, tdt), _torch(k, tdt),
                                  _torch(v, tdt), causal=causal,
                                  window=window)
    assert out.dtype == tdt and out.shape == (B, H, S, D)
    got = out.to(torch.float32).numpy()
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    _close(got, pallas_flash(jq, jk, jv, causal=causal, window=window,
                             interpret=True, block_q=64, block_k=64), tol)
    _close(got, _t(R.attention_ref(_t(jq), _t(jk), _t(jv), causal=causal,
                                   window=window)), tol)


@pytest.mark.parametrize("Sq,Sk,window", [(64, 192, 0), (192, 64, 0),
                                          (192, 64, 32)])
def test_unequal_lengths_follow_the_kernel(Sq, Sk, window):
    """Causal with Sq != Sk: the Pallas kernel (and the port) keep k <= q,
    the oracle k <= q + (Sk - Sq); with Sq > Sk + window the last rows see
    no key and give 0."""
    q, = _qkv(1, [(1, 2, Sq, 32)])
    k, v = _qkv(2, [(1, 2, Sk, 32)] * 2)
    got = T.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, window=window).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, pallas_flash(jq, jk, jv, causal=True, window=window,
                             interpret=True, block_q=64, block_k=64), 2e-5)
    oracle = np.asarray(_t(R.attention_ref(_t(jq), _t(jk), _t(jv),
                                           causal=True, window=window)))
    assert not np.allclose(got, oracle, atol=1e-3)
    if window and Sq > Sk + window:
        assert np.all(got[:, :, Sk + window:] == 0)


def test_ragged_length_matches_oracle():
    """S = 200 is no multiple of the Pallas wrapper's 128-row blocks (it
    asserts); the port takes any S."""
    q, k, v = _qkv(3, [(1, 2, 200, 32)] * 3)
    got = T.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=True, window=48)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, _t(R.attention_ref(_t(jq), _t(jk), _t(jv), causal=True,
                                   window=48)), 2e-5)
    with pytest.raises(AssertionError):
        pallas_flash(jq, jk, jv, interpret=True)


def test_ops_dispatch_by_device_without_fallback():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, [(1, 2, 40, 16)] * 3))
    launches = T.flash_attention_fwd.launches
    out = TOPS.flash_attention(q, k, v, causal=True, window=8)
    assert T.flash_attention_fwd.launches == launches  # plain: no launch
    assert torch.equal(out, T.flash_attention_plain(q, k, v, causal=True,
                                                    window=8))
    # meta tensors (the dry run's traced step) take the plain version's
    # shapes, and launch nothing
    got = TOPS.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert got.device.type == "meta" and got.shape == out.shape
    assert T.flash_attention_fwd.launches == launches
    with pytest.raises(ValueError, match=r"\(B, H, Sq, D\)"):
        TOPS.flash_attention(q, k[:, :1], v)
    with pytest.raises(TypeError):
        TOPS.flash_attention(q, k.to(torch.bfloat16), v)


@pytest.mark.parametrize("case", FC.CASES, ids=[c[0] for c in FC.CASES])
def test_rounding_check_passes_plain_and_catches_a_wide_window(case):
    """At a small size with the cases' masks: the plain version in bf16
    lies within ``flash_check``'s allowance of the float64 reference (up
    to the bf16 rounding it allows twice); a window one key too wide does
    not, where there is a window."""
    _, S, window, q_scale = case
    S, window = S // 16, window // 16
    gen = torch.Generator()
    gen.manual_seed(15)
    q, k, v = FC.flash_inputs(gen, 1, 2, S, 64, torch.bfloat16, q_scale)
    want, allowed = FC.reference(q, k, v, causal=True, window=window)
    got = T.flash_attention_plain(q, k, v, causal=True, window=window)
    assert FC.flash_error(got, want, allowed) <= 0.5
    f32 = T.flash_attention_plain(q.float(), k.float(), v.float(),
                                  causal=True, window=window)
    allowed32 = allowed - FC.OUT_STEP[torch.bfloat16] * want.abs()
    assert FC.flash_error(f32, want, allowed32) < 0.05
    if window:
        wide = T.flash_attention_plain(q, k, v, causal=True,
                                       window=window + 1)
        assert FC.flash_error(wide, want, allowed) > 1.0


@pytest.mark.parametrize("dtype,D,Dv,route", [
    (torch.bfloat16, 64, 64, "sm90"), (torch.bfloat16, 128, 128, "sm90"),
    (torch.bfloat16, 256, 256, "sm90"), (torch.float32, 256, 256, "simt"),
    (torch.float32, 64, 64, "simt"), (torch.bfloat16, 32, 32, "simt"),
    (torch.bfloat16, 96, 96, "simt"), (torch.bfloat16, 256, 128, "simt"),
    (torch.bfloat16, 64, 32, "simt"), (torch.float16, 128, 128, "simt"),
])
def test_route_is_fixed_by_dtype_and_head_dims(dtype, D, Dv, route):
    """bf16 with D == Dv in {64, 128, 256} goes to the sm90 source, every
    other case to the simt one; each route names a source of csrc/."""
    assert T._route(dtype, D, Dv) == route
    source, symbol, _ = T.ROUTES[route]
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert f"int {symbol}(" in text


@pytest.mark.parametrize("source,fault", [
    (src, name) for src, faults in FC.FAULTS.items() for name in faults])
def test_each_planted_fault_occurs_once_in_its_source(source, fault):
    """``_build.start_variants`` plants a fault by replacing its text,
    which must occur exactly once in the source (and not be a no-op)."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    old, new = FC.FAULTS[source][fault]
    assert text.count(old) == 1 and old != new
    assert FC.SOURCE_ROUTE[source] in T.ROUTES


def _p_into_bf16(q, k, v, *, window, split):
    """The sm90 kernel's arithmetic in plain torch over one tile: scores of
    the bf16 q and k in float32 (each product exact), p = exp(s - m) and l
    in float32, and p v with p entering as bf16: rounded (split False), or
    p_hi + p_lo, two products into one float32 sum (split True)."""
    mask = T.attention_mask(q.shape[2], k.shape[2], causal=True,
                            window=window)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / \
        math.sqrt(q.shape[-1])
    s = torch.where(mask, s, T.NEG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    hi = p.bfloat16().float()
    parts = [hi, (p - hi).bfloat16().float()] if split else [hi]
    o = sum(torch.einsum("bhqk,bhkd->bhqd", t, v.float()) for t in parts)
    return (o / l).bfloat16()


@pytest.mark.parametrize("D", T.SM90_HEAD_DIMS)
@pytest.mark.parametrize("case", [c for c in FC.CASES if c[3] == 1.0],
                         ids=[c[0] for c in FC.CASES if c[3] == 1.0])
def test_check_rejects_bf16_p_and_accepts_the_hi_lo_split(case, D):
    """Why the sm90 kernel splits p: with the unchanged allowance, p
    rounded to bf16 before p v fails (by about 10x), p_hi + p_lo passes,
    at 512 positions (S / 6) and the cases' windows / 8."""
    _, S, window, q_scale = case
    gen = torch.Generator()
    gen.manual_seed(15)
    q, k, v = FC.flash_inputs(gen, 1, 2, S // 6, D, torch.bfloat16, q_scale)
    want, allowed = FC.reference(q, k, v, causal=True, window=window // 8)
    rounded = _p_into_bf16(q, k, v, window=window // 8, split=False)
    split = _p_into_bf16(q, k, v, window=window // 8, split=True)
    assert FC.flash_error(rounded, want, allowed) > 1.0
    assert FC.flash_error(split, want, allowed) <= 1.0


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest on
    the low 13 mantissa bits of its float32 pattern, ties away from zero
    (the bits are sign and magnitude, so adding half a step to the
    pattern rounds the magnitude)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, split):
    """einsum(eq, a, b) as the tensor cores take two float32 operands:
    one TF32 product (split False), or the three-term split a_hi b_hi +
    a_hi b_lo + a_lo b_hi, hi = tf32(x) and lo = tf32(x - hi); each
    product exact in float32, the sums in float32."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, ah, bh) + (torch.einsum(eq, ah, bl) +
                                       torch.einsum(eq, al, bh))


def _f32_into_tf32(q, k, v, *, window, split):
    """The simt kernel's float32 arithmetic in plain torch over one tile:
    q k^T and p v through TF32 products (one, or the three-term split),
    p = exp(s - m) and l in float32."""
    mask = T.attention_mask(q.shape[2], k.shape[2], causal=True,
                            window=window)
    s = _tf32_product("bhqd,bhkd->bhqk", q, k, split) / \
        math.sqrt(q.shape[-1])
    s = torch.where(mask, s, T.NEG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    return _tf32_product("bhqk,bhkd->bhqd", p, v, split) / l


def test_tf32_rounding_is_round_to_nearest_away():
    """The emulation keeps 10 mantissa bits, rounds to nearest with ties
    away from zero (cvt.rna), both signs alike, and leaves a float32 that
    is already TF32 as it is."""
    step = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + step, 1.0 + step / 2, 1.0 + step / 4,
                      1.0 + 3 * step / 4, 3.0, 2.0 ** -20])
    want = torch.tensor([1.0, 1.0 + step, 1.0 + step, 1.0, 1.0 + step,
                         3.0, 2.0 ** -20])
    assert torch.equal(_tf32(x), want)
    assert torch.equal(_tf32(-x), -want)
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32))
    hi = _tf32(y)
    assert torch.equal(_tf32(hi), hi)
    assert ((y - hi).abs() <= hi.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("D", [32, 256])
@pytest.mark.parametrize(
    "case", [c for c in FC.SIMT_CASES if c[1] == torch.float32],
    ids=[c[0] for c in FC.SIMT_CASES if c[1] == torch.float32])
def test_check_rejects_one_tf32_product_and_accepts_the_three_term_split(
        case, D):
    """Why the simt kernel splits each float32 operand in three TF32
    terms: with ``flash_check``'s unchanged allowance, one TF32 product
    for q k^T and p v fails, the three-term split passes, at 512
    positions (S / 6) and the case's window / 8; so does the oracle's
    float32 (``repro.kernels.ref.attention_ref``) on the same inputs."""
    _, _, _, S, window, q_scale = case
    rng = np.random.default_rng(32)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, S // 6, D))
                                .astype(np.float32)) for _ in range(3))
    q = q * q_scale
    want, allowed = FC.reference(q, k, v, causal=True, window=window // 8)
    one = _f32_into_tf32(q, k, v, window=window // 8, split=False)
    split = _f32_into_tf32(q, k, v, window=window // 8, split=True)
    assert FC.flash_error(one, want, allowed) > 1.0
    assert FC.flash_error(split, want, allowed) <= 1.0
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    oracle = _t(R.attention_ref(_t(jq), _t(jk), _t(jv), causal=True,
                                window=window // 8))
    assert FC.flash_error(torch.from_numpy(np.array(oracle)), want,
                          allowed) <= 1.0


def test_library_name_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edited csrc/ header, or one it includes, renames the library, so
    a stale build is never loaded; a header nobody includes does not."""
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    assert _build.local_headers((tmp_path / "k.cu").read_bytes()) == [
        tmp_path / "a.cuh", tmp_path / "b.cuh"]
    first = _build.library_path("k")
    (tmp_path / "c.cuh").write_text("// c, edited\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.library_path("k") != first


def test_nvcc_finds_csrc_headers_from_any_directory(monkeypatch):
    """Every compile, the planted-fault copies written under build/
    included, passes -I csrc/; the sm90 source includes sm90.cuh."""
    seen = []

    class Proc:
        def __init__(self, cmd, **kw):
            seen.append(cmd)

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", Proc)
    _build._nvcc("/elsewhere/lib.so", "/elsewhere/copy.cu")
    cmd = seen[0]
    assert cmd[cmd.index("-I") + 1] == str(_build.CSRC)
    assert cmd[-1] == "/elsewhere/copy.cu"
    sm90 = (_build.CSRC / "flash_attention_sm90.cu").read_bytes()
    assert _build.local_headers(sm90) == [_build.CSRC / "sm90.cuh"]
