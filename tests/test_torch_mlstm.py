"""The port's mLSTM math against the reference.

``mlstm_chunkwise_plain`` (the CPU path of the CUDA kernel) against the
oracle ``repro.kernels.ref.mlstm_chunkwise`` and the Pallas
``mlstm_chunkwise`` in interpret mode, on ``tests/test_kernels.py``'s
three shapes, with that file's tolerance; against the oracle for the
final state, a ragged S, an ``initial`` state and large gate spreads;
``mlstm_step_plain`` against ``ref.mlstm_step``; chunkwise against
stepwise; the wrapper's dispatch on the CPU and its choice of CUDA
source (``_route``); the shared-memory budgets of both sources; each
planted fault's text once in its source; and the rounding-scale check
the card holds the kernel to (``mlstm_check``): the oracle passes it, a
wrong carry fails it, and of the sm90 kernel's three float32 operands
that enter the tensor cores as bf16 (the gated scores W, the chunk-start
state C, the gated keys wv k) each rounded to bf16 fails it while its
hi/lo split passes.

Inputs come from numpy with a seed and go through both sides in float32.
Tolerances: atol 5e-5 / rtol 5e-4 wherever ``test_kernels.py`` uses
them (float32 sums in another order); the chunkwise-vs-stepwise bound
2e-4 / 2e-3 is that file's too."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.kernels.mlstm_chunk import mlstm_chunkwise as pallas_mlstm
from repro_torch.configs import reduced_config
from repro_torch.kernels import _build
from repro_torch.kernels import mlstm_ablate as MA
from repro_torch.kernels import mlstm_check as MC
from repro_torch.kernels import mlstm_chunk as T
from repro_torch.kernels import ops as TOPS

torch.set_num_threads(1)

ATOL, RTOL = 5e-5, 5e-4


def _inputs(seed, B, H, S, Dq, Dv=None, *, li_scale=1.0, lf_shift=2.0):
    rng = np.random.default_rng(seed)
    Dv = Dv or Dq
    q, k = (rng.standard_normal((B, H, S, Dq)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, S, Dv)).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        jnp.asarray(rng.standard_normal((B, H, S)), jnp.float32) * 2
        + lf_shift))
    li = (rng.standard_normal((B, H, S)) * li_scale).astype(np.float32)
    return q, k, v, lf, li


def _initial(seed, B, H, Dq, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Dq, Dv)).astype(np.float32),
            rng.standard_normal((B, H, Dq)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _jnp(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("B,H,S,D,chunk", [(1, 1, 128, 16, 32),
                                           (2, 2, 256, 32, 64),
                                           (1, 2, 256, 64, 128)])
def test_plain_matches_oracle_and_pallas_interpret(B, H, S, D, chunk):
    x = _inputs(B * 100 + S + D, B, H, S, D)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=chunk)
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk)
    hk, _ = pallas_mlstm(*_jnp(*x), chunk=chunk, interpret=True)
    _close(h, hr)
    _close(h, hk)
    # the final state the kernel emits from its own carry: the oracle's
    _close(C, Cr)
    _close(n, nr)
    _close(m, mr)


@pytest.mark.parametrize("S,chunk", [(100, 32), (37, 256), (257, 64)])
def test_ragged_sequence_matches_oracle(S, chunk):
    x = _inputs(S, 2, 2, S, 16, 24)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=chunk)
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk)
    assert h.shape == (2, 2, S, 24)
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


@pytest.mark.parametrize("S,chunk", [(64, 32), (50, 32)])
def test_initial_state_matches_oracle(S, chunk):
    x = _inputs(7 + S, 1, 2, S, 16)
    init = _initial(8 + S, 1, 2, 16, 16)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=chunk,
                                           initial=_torch(*init))
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk,
                                         initial=_jnp(*init))
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


def test_prefill_continuation_equals_one_pass():
    """Two calls carrying the state equal one call over the whole
    sequence (the use of `initial` in a continued prefill)."""
    S = 96
    q, k, v, lf, li = _torch(*_inputs(3, 1, 2, S, 16))
    h, st = T.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=32)
    cut = 64
    h1, st1 = T.mlstm_chunkwise_plain(q[:, :, :cut], k[:, :, :cut],
                                      v[:, :, :cut], lf[:, :, :cut],
                                      li[:, :, :cut], chunk=32)
    h2, st2 = T.mlstm_chunkwise_plain(q[:, :, cut:], k[:, :, cut:],
                                      v[:, :, cut:], lf[:, :, cut:],
                                      li[:, :, cut:], chunk=32, initial=st1)
    _close(torch.cat([h1, h2], dim=2), h)
    for got, want in zip(st2, st):
        _close(got, want)


def test_stabilizer_spread_matches_oracle():
    """log_f near 0 (f ~ 1, long memory) and log_i over +-10: the
    running max m, not the raw gates, keeps the exponentials finite."""
    x = _inputs(11, 1, 2, 160, 16, li_scale=10.0, lf_shift=8.0)
    h, (C, n, m) = T.mlstm_chunkwise_plain(*_torch(*x), chunk=64)
    hr, (Cr, nr, mr) = R.mlstm_chunkwise(*_jnp(*x), chunk=64)
    assert torch.isfinite(h).all() and torch.isfinite(C).all()
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


def test_step_matches_oracle():
    rng = np.random.default_rng(5)
    B, H, D = 2, 3, 16
    q, k, v = (rng.standard_normal((B, H, D)).astype(np.float32)
               for _ in range(3))
    lf = np.log(rng.uniform(0.1, 0.99, (B, H))).astype(np.float32)
    li = rng.standard_normal((B, H)).astype(np.float32)
    state = _initial(6, B, H, D, D)
    h, (C, n, m) = T.mlstm_step_plain(*_torch(q, k, v, lf, li),
                                      _torch(*state))
    hr, (Cr, nr, mr) = R.mlstm_step(*_jnp(q, k, v, lf, li), _jnp(*state))
    for got, want in ((h, hr), (C, Cr), (n, nr), (m, mr)):
        _close(got, want)


def test_chunkwise_matches_stepwise():
    B, H, S, D = 1, 2, 96, 16
    q, k, v, lf, li = _torch(*_inputs(9, B, H, S, D, lf_shift=1.0))
    hc, (C, n, m) = T.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=32)
    state = (torch.zeros((B, H, D, D)), torch.zeros((B, H, D)),
             torch.full((B, H), -1e30))
    hs = []
    for t in range(S):
        h1, state = T.mlstm_step_plain(q[:, :, t], k[:, :, t], v[:, :, t],
                                       lf[:, :, t], li[:, :, t], state)
        hs.append(h1)
    _close(hc, torch.stack(hs, 2), atol=2e-4, rtol=2e-3)
    _close(C, state[0], atol=2e-4, rtol=2e-3)


def test_wrapper_dispatches_by_device_without_fallback():
    q, k, v, lf, li = _torch(*_inputs(1, 1, 1, 40, 8))
    before = (T.mlstm_chunkwise.launches, T.mlstm_chunkwise_plain.calls)
    h, _ = TOPS.mlstm_chunkwise(q, k, v, lf, li, chunk=16)
    assert T.mlstm_chunkwise.launches == before[0]     # plain path: no launch
    assert T.mlstm_chunkwise_plain.calls == before[1] + 1
    want, _ = T.mlstm_chunkwise_plain(q, k, v, lf, li, chunk=16)
    assert torch.equal(h, want)
    # meta tensors (the dry run's traced step) take the plain version's
    # shapes, and launch nothing
    meta = torch.device("meta")
    hm, (Cm, _, _) = T.mlstm_chunkwise(q.to(meta), k.to(meta), v.to(meta),
                                       lf.to(meta), li.to(meta))
    assert hm.device == meta and hm.shape == h.shape
    assert T.mlstm_chunkwise.launches == before[0]
    with pytest.raises(TypeError):
        T.mlstm_chunkwise(q.double(), k, v, lf, li)
    with pytest.raises(ValueError, match="log_f"):
        T.mlstm_chunkwise(q, k, v, lf[:, :, :-1], li)
    with pytest.raises(ValueError, match="initial"):
        T.mlstm_chunkwise(q, k, v, lf, li, initial=(
            torch.zeros((1, 1, 8, 9)), torch.zeros((1, 1, 8)),
            torch.zeros((1, 1))))


def test_shared_memory_budget_covers_the_full_width():
    """xlstm-350m's head dim (2048 / 4 = 512) at chunk 256 fits one
    block's shared memory on both sources; a head dim past the simt
    budget is refused.  Each budget is its source's own: the simt output
    kernel's 64 q rows, 3-slot ring of 32-row pieces, the chunk's g and
    n_c; the sm90 output kernel's q rows, 3-slot ring of 32 KB and the
    chunk's g, its states kernel's 4 slots of a k and a v slab and two
    chunks' wv."""
    assert T.simt_smem_bytes(512, 512, 256) <= T.SMEM_LIMIT
    assert T.simt_smem_bytes(1024, 512, 256) > T.SMEM_LIMIT
    assert T.simt_smem_bytes(32, 32, 256) == \
        4 * (16 * (32 + 8) + 2 * 4 * 32 * (40 + 36) + 256 + 32)
    assert T.simt_smem_bytes(512, 512, 256) == \
        4 * (64 * (512 + 8) + 2 * 2 * 32 * (40 + 68) + 256 + 512)
    simt = (_build.CSRC / "mlstm_chunk.cu").read_text()
    for decl in ("constexpr int kRound = 4;", "constexpr int kRingMin = 2;",
                 "constexpr int kPiece = 32;",
                 "constexpr int kLdK = kPiece + 8;",
                 "static constexpr int kLdV = 8 * NV + 4;",
                 "static constexpr int kLd = TS + 4;",
                 "launch_output<T, 8, 4, 2>", "launch_output<T, 4, 1, 4>",
                 "const bool small_tiles = Dq <= 32 && Dv <= 32;"):
        assert decl in simt
    assert T.sm90_smem_bytes(512, 512, 256) + T.SM90_STATIC <= T.SMEM_LIMIT
    assert T.sm90_smem_bytes(512, 512, 256) == \
        128 * 512 * 2 + 3 * 32768 + 4 * 256 + 1024
    assert T.sm90_smem_bytes(64, 64, 64) == \
        128 * 64 * 2 + 3 * 32768 + 4 * 64 + 1024
    assert T.sm90_smem_bytes(64, 512, 1024) == \
        4 * (16384 + 32768) + 8 * 1024 + 1024
    assert T.sm90_smem_bytes(512, 512, 512) + T.SM90_STATIC > T.SMEM_LIMIT
    text = (_build.CSRC / "mlstm_chunk_sm90.cu").read_text()
    for decl in ("return (size_t)(Dq / 64) * kQPanel + kOutStages * kOutSlot"
                 " + 4 * L + 1024;",
                 "return kStStages * kSlot + 1024 + 8 * L;",
                 "constexpr int kOutStages = 3;",
                 "constexpr int kOutSlot = 4 * kPanel;",
                 "constexpr int kStStages = 4;",
                 "constexpr int kStK = 2 * kPanel;",
                 "constexpr int kPanel = 64 * 128;"):
        assert decl in text


@pytest.mark.parametrize("dtype,Dq,Dv,chunk,route", [
    (torch.bfloat16, 512, 512, 256, "sm90"),     # the serve shape
    (torch.bfloat16, 64, 64, 64, "sm90"),
    (torch.bfloat16, 192, 320, 128, "sm90"),
    (torch.bfloat16, 512, 128, 256, "sm90"),
    (torch.float32, 512, 512, 256, "simt"),
    (torch.bfloat16, 32, 32, 256, "simt"),
    (torch.bfloat16, 512, 48, 256, "simt"),
    (torch.bfloat16, 1024, 512, 256, "simt"),
    (torch.bfloat16, 512, 512, 100, "simt"),
    (torch.bfloat16, 512, 512, 512, "simt"),     # past shared memory
    (torch.bfloat16, 256, 512, 512, "sm90"),
    (torch.float16, 512, 512, 256, "simt"),
])
def test_route_is_fixed_by_dtype_head_dims_and_chunk(dtype, Dq, Dv, chunk,
                                                      route):
    """bf16 with Dq and Dv multiples of 64 up to 512 and chunk a multiple
    of 64 within the kernels' shared memory goes to the sm90 source, every
    other case to the simt one; each route names a source of csrc/ with
    its C symbol."""
    assert T._route(dtype, Dq, Dv, chunk) == route
    source, symbol, argtypes = T.ROUTES[route]
    text = (_build.CSRC / f"{source}.cu").read_text()
    assert f"int {symbol}(" in text
    # one argtype per parameter of the C launcher
    params = text[text.index(f"int {symbol}("):].split(")")[0]
    assert params.count(",") + 1 == len(argtypes)


@pytest.mark.parametrize("case", MC.CASES, ids=[c[0] for c in MC.CASES])
def test_card_cases_take_their_route(case):
    """Every bf16 case of ``mlstm_check.CASES`` (the serve shape, ragged
    S, an initial state, the stabilizer stress) is the sm90 route's, the
    float32 one the simt route's alone."""
    _, dtype, _, _, _ = case
    D, L = MC.SHAPE["D"], MC.SHAPE["chunk"]
    want = "sm90" if dtype == torch.bfloat16 else "simt"
    assert T._route(dtype, D, D, L) == want
    assert MC.takes("mlstm_chunk_sm90", dtype) == (want == "sm90")
    assert MC.takes("mlstm_chunk", dtype)


@pytest.mark.parametrize("case", MC.SIMT_CASES,
                         ids=[c[0] for c in MC.SIMT_CASES])
def test_simt_cases_take_the_simt_route(case):
    """``mlstm_check.SIMT_CASES`` go through the entry point on the simt
    route and fit its shared memory; the first is the reduced xlstm's own
    call (the simt route's main path: B = 2, 300 positions of its float32
    config's head dim at chunk 256)."""
    _, dtype, B, H, S, Dq, Dv, chunk, _ = case
    assert T._route(dtype, Dq, Dv, chunk) == "simt"
    assert T.simt_smem_bytes(Dq, Dv, chunk) <= T.SMEM_LIMIT
    cfg = reduced_config("xlstm_350m")
    head = int(cfg.d_model * cfg.proj_factor) // cfg.num_heads
    assert cfg.param_dtype == "float32"
    assert MC.SIMT_CASES[0][1:8] == (torch.float32, 2, cfg.num_heads, 300,
                                     head, head, 256)


@pytest.mark.parametrize("source,fault", [
    (src, name) for src, faults in MC.FAULTS.items() for name in faults])
def test_each_planted_fault_occurs_once_in_its_source(source, fault):
    """``_build.start_variants`` plants a fault by replacing its text,
    which must occur exactly once in the source (and not be a no-op)."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    old, new = MC.FAULTS[source][fault]
    assert text.count(old) == 1 and old != new
    assert MC.SOURCE_ROUTE[source] in T.ROUTES


@pytest.mark.parametrize("name", sorted(MA.ABLATIONS))
def test_each_ablation_applies_to_the_sm90_source(name):
    """``mlstm_ablate`` builds its copies by replacing texts that must each
    occur once in the sm90 source, in order."""
    text = (_build.CSRC / "mlstm_chunk_sm90.cu").read_text()
    for old, new in MA.ABLATIONS[name]:
        assert text.count(old) == 1 and old != new
        text = text.replace(old, new)


def _bf16_parts(x, split):
    """x rounded to bf16 (split False), or x_hi + x_lo, each bf16 (the sum
    of the two products the kernel takes is that of x_hi + x_lo, exact in
    float32)."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float() if split else hi


def _plain_with_bf16(q, k, v, log_f, log_i, chunk, operand, split):
    """``mlstm_chunkwise_plain`` (no initial state, S a multiple of the
    chunk) with one float32 operand entering its product as bf16, as the
    sm90 kernel's tensor cores take it: the gated scores W before W v,
    the chunk-start state C before q C, or the gated keys wv k before the
    carry's product; den and n sum the unrounded values, as the kernel
    does on the CUDA cores."""
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    C = torch.zeros((B, H, Dq, Dv))
    n = torch.zeros((B, H, Dq))
    m = torch.full((B, H), T.NEG)
    scale = 1.0 / math.sqrt(Dq)
    lpos = torch.arange(chunk)
    causal = lpos[:, None] >= lpos[None, :]

    def enter(x, name):
        return _bf16_parts(x, split) if name == operand else x

    hs = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        qi, ki, vi = T._f32(q[:, :, sl], k[:, :, sl], v[:, :, sl])
        F = torch.cumsum(log_f[:, :, sl], dim=-1)
        g = log_i[:, :, sl] - F
        Mt = torch.maximum(m[..., None], torch.cummax(g, dim=-1).values)
        w_carry = torch.exp(m[..., None] - Mt)
        qCf = torch.einsum("bhld,bhdv->bhlv", qi, enter(C, "C")) * scale
        qnf = torch.einsum("bhld,bhd->bhl", qi, n) * scale
        sc = torch.einsum("bhld,bhsd->bhls", qi, ki) * scale
        W = sc * torch.where(causal, torch.exp(g[:, :, None, :] -
                                              Mt[..., None]), 0.0)
        num = w_carry[..., None] * qCf + \
            torch.einsum("bhls,bhsv->bhlv", enter(W, "W"), vi)
        den = w_carry * qnf + W.sum(dim=-1)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-(F + Mt)))[..., None])
        ML = Mt[..., -1]
        wk = torch.exp(g - ML[..., None])[..., None] * ki
        decay = torch.exp(m - ML)
        C = decay[..., None, None] * C + \
            torch.einsum("bhld,bhlv->bhdv", enter(wk, "wk"), vi)
        n = decay[..., None] * n + wk.sum(dim=-2)
        m = F[..., -1] + ML
    return torch.cat(hs, dim=2).to(q.dtype), (C, n, m)


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest on
    the low 13 mantissa bits of its float32 pattern, ties away from
    zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(eq, a, b, split):
    """einsum(eq, a, b) as the simt kernel's tensor cores take two float32
    operands: one TF32 product (split False), or a_hi b_hi + a_hi b_lo +
    a_lo b_hi, hi = tf32(x) and lo = tf32(x - hi), each product exact in
    float32, the sums in float32."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return torch.einsum(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return torch.einsum(eq, ah, bh) + (torch.einsum(eq, ah, bl) +
                                       torch.einsum(eq, al, bh))


def _plain_with_tf32(q, k, v, log_f, log_i, chunk, split):
    """``mlstm_chunkwise_plain`` (no initial state, S a multiple of the
    chunk) with every product taken as the simt kernel takes it: q k^T,
    W v, q C and the carry's (wv k)^T v through TF32 products (one, or
    the three-term split); den and n sum the float32 values, as the
    kernel does on the CUDA cores."""
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    C = torch.zeros((B, H, Dq, Dv))
    n = torch.zeros((B, H, Dq))
    m = torch.full((B, H), T.NEG)
    scale = 1.0 / math.sqrt(Dq)
    lpos = torch.arange(chunk)
    causal = lpos[:, None] >= lpos[None, :]
    hs = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        qi, ki, vi = T._f32(q[:, :, sl], k[:, :, sl], v[:, :, sl])
        F = torch.cumsum(log_f[:, :, sl], dim=-1)
        g = log_i[:, :, sl] - F
        Mt = torch.maximum(m[..., None], torch.cummax(g, dim=-1).values)
        w_carry = torch.exp(m[..., None] - Mt)
        qCf = _tf32_product("bhld,bhdv->bhlv", qi, C, split) * scale
        qnf = torch.einsum("bhld,bhd->bhl", qi, n) * scale
        sc = _tf32_product("bhld,bhsd->bhls", qi, ki, split) * scale
        W = sc * torch.where(causal, torch.exp(g[:, :, None, :] -
                                              Mt[..., None]), 0.0)
        num = w_carry[..., None] * qCf + \
            _tf32_product("bhls,bhsv->bhlv", W, vi, split)
        den = w_carry * qnf + W.sum(dim=-1)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-(F + Mt)))[..., None])
        ML = Mt[..., -1]
        wk = torch.exp(g - ML[..., None])[..., None] * ki
        decay = torch.exp(m - ML)
        C = decay[..., None, None] * C + \
            _tf32_product("bhld,bhlv->bhdv", wk, vi, split)
        n = decay[..., None] * n + wk.sum(dim=-2)
        m = F[..., -1] + ML
    return torch.cat(hs, dim=2).to(q.dtype), (C, n, m)


@pytest.mark.parametrize("li_scale,lf_shift", [(1.0, 2.0), (10.0, 8.0)],
                         ids=["gates", "stabilizer"])
@pytest.mark.parametrize("D,chunk", [(32, 128), (64, 64)])
def test_check_rejects_one_tf32_product_and_accepts_the_three_term_split(
        D, chunk, li_scale, lf_shift):
    """Why the simt kernel splits each float32 operand in three TF32
    terms: with ``mlstm_check``'s unchanged allowances, every product
    taken as one TF32 product fails (h), the three-term split passes
    every output, and so does the oracle (``repro.kernels.ref``) on the
    same inputs; at the reduced xlstm's head dim and one more."""
    B, H, S = 1, 2, 256
    x = _inputs(13, B, H, S, D, li_scale=li_scale, lf_shift=lf_shift)
    args = _torch(*x)
    (want_h, want_state), scales = MC.reference(args, chunk, None)
    h, state = _plain_with_tf32(*args, chunk, split=False)
    assert MC.mlstm_errors(h, state, want_h, want_state,
                           scales)["h"] > 1.0
    h, state = _plain_with_tf32(*args, chunk, split=True)
    errs = MC.mlstm_errors(h, state, want_h, want_state, scales)
    assert all(e <= 1.0 for e in errs.values()), errs
    hr, sr = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk)
    errs = MC.mlstm_errors(*_torch(hr), _torch(*sr), want_h, want_state,
                           scales)
    assert all(e <= 1.0 for e in errs.values()), errs


@pytest.mark.parametrize("initial", [False, True])
@pytest.mark.parametrize("li_scale,lf_shift", [(1.0, 2.0), (10.0, 8.0)],
                         ids=["gates", "stabilizer"])
def test_rounding_check_passes_the_oracle(initial, li_scale, lf_shift):
    """The oracle (XLA's float32 sums, another order) passes
    ``mlstm_errors`` against the plain version: every output within what
    float32 rounding allows."""
    B, H, S, D, chunk = 2, 2, 200, 32, 64
    x = _inputs(7, B, H, S, D, li_scale=li_scale, lf_shift=lf_shift)
    init = _initial(8, B, H, D, D) if initial else None
    tinit = None if init is None else _torch(*init)
    hr, sr = R.mlstm_chunkwise(*_jnp(*x), chunk=chunk,
                               initial=None if init is None else
                               _jnp(*init))
    (want_h, want_state), scales = MC.reference(_torch(*x), chunk, tinit)
    errs = MC.mlstm_errors(*_torch(hr), _torch(*sr), want_h, want_state,
                           scales)
    assert all(e <= 1.0 for e in errs.values()), errs


@pytest.mark.parametrize("dtype,factor", [
    (torch.float32, 1.001), (torch.float32, 1.01),
    (torch.bfloat16, 1.01), (torch.bfloat16, 1.1)])
def test_rounding_check_catches_a_wrong_carry(dtype, factor):
    """A carried-in C off by 0.1 % fails the check in float32, and off
    by 1 % in bf16, whose h carries 8 bits (a tolerance set by the
    largest |h| let a 10 % carry error through in bf16)."""
    B, H, S, D, chunk = 1, 2, 128, 32, 64
    x = _inputs(9, B, H, S, D, li_scale=10.0, lf_shift=8.0)
    q, k, v, lf, li = _torch(*x)
    q, k, v = (a.to(dtype) for a in (q, k, v))
    C0, n0, m0 = _torch(*_initial(10, B, H, D, D))
    args = (q, k, v, lf, li)
    (want_h, want_state), scales = MC.reference(args, chunk, (C0, n0, m0))
    h, state = T.mlstm_chunkwise_plain(*args, chunk=chunk,
                                       initial=(C0, n0, m0))
    assert max(MC.mlstm_errors(h, state, want_h, want_state,
                               scales).values()) <= 1.0
    h, state = T.mlstm_chunkwise_plain(*args, chunk=chunk,
                                       initial=(C0 * factor, n0, m0))
    assert MC.mlstm_errors(h, state, want_h, want_state,
                           scales)["h"] > 1.0


@pytest.mark.parametrize("li_scale,lf_shift", [(1.0, 2.0), (10.0, 8.0)],
                         ids=["gates", "stabilizer"])
def test_rounding_scale_covers_float32_against_float64(monkeypatch,
                                                       li_scale, lf_shift):
    """The plain version in float32 against the same math in float64
    (the true sums, nearly) stays within an eighth of what the check
    allows: the margin GAMMA leaves for a kernel's other order."""
    B, H, S, D, chunk = 1, 2, 300, 128, 128
    x = _torch(*_inputs(11, B, H, S, D, li_scale=li_scale,
                        lf_shift=lf_shift))
    (h, state), scales = MC.reference(x, chunk, None)
    zero = (torch.zeros(B, H, D, D, dtype=torch.float64),
            torch.zeros(B, H, D, dtype=torch.float64),
            torch.full((B, H), T.NEG, dtype=torch.float64))
    monkeypatch.setattr(T, "_f32", lambda *xs: tuple(a.double() for a in xs))
    h64, state64 = T.mlstm_chunkwise_plain(*(a.double() for a in x),
                                           chunk=chunk, initial=zero)
    errs = MC.mlstm_errors(h, state, h64, state64, scales)
    assert max(errs.values()) <= 1 / 8, errs


@pytest.mark.parametrize("operand", ["W", "C", "wk"])
@pytest.mark.parametrize("stress", [False, True],
                         ids=["gates", "stabilizer"])
def test_check_rejects_bf16_operands_and_accepts_the_hi_lo_split(operand,
                                                                stress):
    """Why the sm90 kernel splits W, C and wv k: with the unchanged
    ``mlstm_errors`` allowance, each one rounded to bf16 before its
    product fails, and x_hi + x_lo passes, on ``CASES``' two kinds of
    gates at Dq = 128, chunk 64, S = 256 (q, k, v in bf16, as the cases
    make them)."""
    gen = torch.Generator()
    gen.manual_seed(14)
    args, _ = MC.mlstm_inputs(gen, 1, 2, 256, 128, 128, torch.bfloat16,
                              stress=stress)
    (want_h, want_state), scales = MC.reference(args, 64, None)
    errs = {}
    for split in (False, True):
        h, state = _plain_with_bf16(*args, 64, operand, split)
        errs[split] = MC.mlstm_errors(h, state, want_h, want_state, scales)
    assert max(errs[False].values()) > 1.0, errs
    assert max(errs[True].values()) <= 1.0, errs
