"""Holding ``mlstm_chunkwise`` against its plain version, and the faults
that holding must catch.

h is a ratio of two sums, num / max(|den|, e^{-m_t}), and on random
q, k, v the sum den can cancel: there h is large (|h| reaches 10^4 on
standard-normal inputs) and ill-conditioned, and a tolerance set by the
largest |h| is far above the typical value.  So each output is
held element by element against the scale of its own float32 rounding
(``mlstm_rounding_scale``): the same sums over absolute values.  Where
den does not cancel that scale is a small multiple of |h|, so a wrong
term stands out; where it cancels the scale grows with it.

    PYTHONPATH=src python -m repro_torch.kernels.mlstm_check

builds both CUDA sources of the kernel (``mlstm_chunk.ROUTES``) and
copies of each with one planted fault (``FAULTS``: a dropped or 1 % wrong
carry term, the diagonal masked out, one 64-column slice of v shifted;
for the sm90 source also the lo half of each hi/lo split dropped, and the
previous chunk's state read in place of the chunk's own) into a
temporary directory, runs every case of ``CASES`` through each by its
launcher (the float32 case on the simt source alone: the sm90 route
takes bf16 only), and prints per source, variant and case the largest
error over what rounding allows, beside the verdict of a tolerance scaled
by the largest |h|.  It exits 0 when each source passes every case it
takes and every fault fails at least one.  Then the same for the
backward's two sources on ``BWD_CASES`` against the plain backward in
float64, within ``mlstm_bwd_rounding_scale``: csrc/mlstm_chunk_bwd.cu
(SIMT) on every case, with each of ``BWD_FAULTS``, and
csrc/mlstm_chunk_bwd_sm90.cu on the cases its route takes
(``mlstm_chunk.bwd_route``), with each of ``BWD_FAULTS_SM90``.  Needs
nvcc and a card.
"""
from __future__ import annotations

import json
import math
import sys
import tempfile
from pathlib import Path

import torch

from . import _build
from . import mlstm_chunk as mk

#: the card-side cases: (name, input type, S, with an initial state,
#: stabilizer stress: log_f near 0 and log_i spread over +-10), at the
#: xlstm-350m serve width B = 4, H = 4, Dq = Dv = 512, chunk 256
CASES = (("serve_bf16", torch.bfloat16, 1024, False, False),
         ("serve_f32", torch.float32, 1024, False, False),
         ("ragged_1000", torch.bfloat16, 1000, False, False),
         ("initial", torch.bfloat16, 512, True, False),
         ("stabilizer", torch.bfloat16, 1024, False, True))
SHAPE = {"B": 4, "H": 4, "D": 512, "chunk": 256}


def mlstm_inputs(gen, B, H, S, Dq, Dv, dtype, *, stress=False,
                 initial=False):
    """Random q, k, v in `dtype`, gates in float32 and (with `initial`) a
    random carried-in (C, n, m), on `gen`'s device."""
    dev = gen.device
    q, k = (torch.randn((B, H, S, Dq), generator=gen, device=dev)
            .to(dtype) for _ in range(2))
    v = torch.randn((B, H, S, Dv), generator=gen, device=dev).to(dtype)
    raw = torch.randn((B, H, S), generator=gen, device=dev)
    if stress:
        log_f = torch.nn.functional.logsigmoid(raw + 8.0)
        log_i = torch.rand((B, H, S), generator=gen, device=dev) * 20 - 10
    else:
        log_f = torch.nn.functional.logsigmoid(raw * 2 + 2)
        log_i = torch.randn((B, H, S), generator=gen, device=dev) * 3
    init = None
    if initial:
        init = (torch.randn((B, H, Dq, Dv), generator=gen, device=dev),
                torch.randn((B, H, Dq), generator=gen, device=dev),
                torch.randn((B, H), generator=gen, device=dev))
    return (q, k, v, log_f, log_i), init


def mlstm_rounding_scale(q, k, v, log_f, log_i, *, chunk: int = 256,
                         initial=None):
    """The scale of float32 rounding in each output of the chunkwise
    forward: its sums taken over absolute values, the carry included.

    Two orders of the same float32 sums (the kernel's, the plain
    version's) differ by a small multiple of this, since h is a ratio of
    two sums: dh ~ (d num + |h| d den) / max(|den|, e^{-m_t}).  Where den
    cancels, h is ill-conditioned and the scale grows with it; where it
    does not, the scale is near |h|, so a wrong term stands out.
    Returns (eh (B, H, S, Dv), (eC, en, em)) float32: eh as above, eC and
    en the carry of C and n over absolute values, em the gate sums
    behind m."""
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    dev = q.device
    pad = (-S) % chunk
    real = torch.ones((B, H, S), dtype=torch.bool, device=dev)
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                   for a in (q, k, v))
        log_f = torch.nn.functional.pad(log_f, (0, pad))
        log_i = torch.nn.functional.pad(log_i, (0, pad), value=mk.NEG)
        real = torch.nn.functional.pad(real, (0, pad))
    nC = (S + pad) // chunk
    if initial is None:
        C = torch.zeros((B, H, Dq, Dv), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, Dq), dtype=torch.float32, device=dev)
        m = torch.full((B, H), mk.NEG, dtype=torch.float32, device=dev)
        eC, en, em = C.clone(), n.clone(), torch.zeros_like(m)
    else:
        C, n, m = mk._f32(*initial)
        eC, en, em = C.abs(), n.abs(), m.abs()
    scale = 1.0 / math.sqrt(Dq)
    lpos = torch.arange(chunk, device=dev)
    causal = lpos[:, None] >= lpos[None, :]
    ehs = []
    for c in range(nC):
        sl = slice(c * chunk, (c + 1) * chunk)
        qi, ki, vi = mk._f32(q[:, :, sl], k[:, :, sl], v[:, :, sl])
        aq, ak, av = qi.abs(), ki.abs(), vi.abs()
        lf, li = mk._f32(log_f[:, :, sl], log_i[:, :, sl])
        F = torch.cumsum(lf, dim=-1)
        g = li - F
        Mt = torch.maximum(m[..., None], torch.cummax(g, dim=-1).values)
        m_t = F + Mt
        w_carry = torch.exp(m[..., None] - Mt)
        D = torch.where(causal, torch.exp(g[:, :, None, :] - Mt[..., None]),
                        0.0)
        W = torch.einsum("bhld,bhsd->bhls", qi, ki) * scale * D
        aW = torch.einsum("bhld,bhsd->bhls", aq, ak) * scale * D
        num = w_carry[..., None] * scale * \
            torch.einsum("bhld,bhdv->bhlv", qi, C) + \
            torch.einsum("bhls,bhsv->bhlv", W, vi)
        den = w_carry * scale * torch.einsum("bhld,bhd->bhl", qi, n) + \
            W.sum(dim=-1)
        e_num = w_carry[..., None] * scale * \
            torch.einsum("bhld,bhdv->bhlv", aq, eC) + \
            torch.einsum("bhls,bhsv->bhlv", aW, av)
        e_den = w_carry * scale * torch.einsum("bhld,bhd->bhl", aq, en) + \
            aW.sum(dim=-1)
        div = torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
        ehs.append((e_num + (num / div).abs() * e_den[..., None]) / div)
        ML, FL = Mt[..., -1], F[..., -1]
        wv = torch.exp(g - ML[..., None])[..., None]
        decay = torch.exp(m - ML)
        C = decay[..., None, None] * C + \
            torch.einsum("bhld,bhlv->bhdv", wv * ki, vi)
        n = decay[..., None] * n + (wv * ki).sum(dim=-2)
        eC = decay[..., None, None] * eC + \
            torch.einsum("bhld,bhlv->bhdv", wv * ak, av)
        en = decay[..., None] * en + (wv * ak).sum(dim=-2)
        A = torch.cumsum(lf.abs(), dim=-1)
        gi = torch.where(real[:, :, sl], li.abs() + A, 0.0)
        em = A[..., -1] + torch.maximum(em, gi.max(dim=-1).values)
        m = FL + ML
    return torch.cat(ehs, dim=2)[:, :, :S], (eC, en, em)


#: float32 rounding allowed per unit of ``mlstm_rounding_scale``: 2^-16
#: for h, whose sums hold up to Dq + L terms; 2^-12 for C, n, m, whose
#: carry weights are exp of gate sums of magnitude ~10^2, a rounding the
#: scale does not carry.  The plain version in float32 against float64
#: uses a small part of it (tests/test_torch_mlstm.py), leaving the rest
#: for the kernel's other order of the same sums.
GAMMA = {"h": 2.0 ** -16, "C": 2.0 ** -12, "n": 2.0 ** -12, "m": 2.0 ** -12}
#: what rounding h to its type adds, relative to |h|, against a float32
#: reference: at most half a step of the last bit, 2^-8 for bfloat16,
#: allowed twice (f32's own rounding lies inside GAMMA)
OUT_STEP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def mlstm_errors(h, state, want_h, want_state, scales):
    """Each output's largest |got - want| over what rounding allows,
    GAMMA * scale + OUT_STEP * |want|, with `want` the plain version's in
    float32 (h unrounded: run it on float32 copies of q, k, v) and the
    scale from ``mlstm_rounding_scale`` on the same inputs:
    {"h", "C", "n", "m": x}, every x <= 1 when the two agree."""
    eh, estate = scales
    pairs = [("h", h, want_h, eh, OUT_STEP[h.dtype])] + \
        [(name, g, w, e, 0.0)
         for name, g, w, e in zip("Cnm", state, want_state, estate)]
    out = {}
    for name, got, want, e, step in pairs:
        want = want.float()
        allowed = GAMMA[name] * e + step * want.abs()
        d = (got.float() - want).abs()
        out[name] = (d / allowed.clamp_min(1e-30)).max().item()
    return out


def reference(args, chunk, initial):
    """The plain version's outputs in float32 (h unrounded: q, k, v go in
    as float32 copies, which the plain version casts to anyway) and the
    rounding scale, on the same inputs."""
    q, k, v, lf, li = args
    want = mk.mlstm_chunkwise_plain(q.float(), k.float(), v.float(), lf,
                                    li, chunk=chunk, initial=initial)
    return want, mlstm_rounding_scale(*args, chunk=chunk, initial=initial)


def max_scaled_ok(h, state, want_h, want_state) -> bool:
    """The tolerance this module replaces, for the record: h within
    atol 1e-4 (f32) or 1e-2 (bf16) of the largest |h| plus rtol 1e-3 /
    1e-2, the state within 1e-4 of its largest magnitude plus rtol
    1e-3."""
    def close(got, want, atol, rtol):
        want = want.to(got.dtype).float()
        scale = max(1.0, want.abs().max().item())
        return torch.allclose(got.float(), want, atol=atol * scale,
                              rtol=rtol)
    f32 = h.dtype == torch.float32
    return close(h, want_h, 1e-4 if f32 else 1e-2, 1e-3 if f32 else 1e-2) \
        and all(close(g, w, 1e-4, 1e-3) for g, w in zip(state, want_state))


#: planted faults per source (csrc/<source>.cu): {fault: (text, its
#: replacement)}, each text once in its source
FAULTS = {
    "mlstm_chunk": {
        "carry_dropped": ("acc[i][j] *= w;", "acc[i][j] *= 0.f;"),
        "carry_weight_1pct": ("expf(mprev - Mt[grow + t]) : 0.f;",
                              "expf(mprev - Mt[grow + t]) * 1.01f : 0.f;"),
        "den_carry_dropped": ("rden[tid] = wc * (qn * scale);",
                              "rden[tid] = 0.f * (qn * scale);"),
        "diagonal_masked": ("if (treal && s <= t)", "if (treal && s < t)"),
        "v_slice_shifted": (
            "p = cb + s, j = j0 + cc;",
            "p = cb + s, j = j0 + cc + (jt == 3 ? kTile : 0);"),
        "decay_1pct": ("const float decay = expf(mprev - ML);",
                       "const float decay = expf(mprev - ML) * 1.01f;"),
    },
    "mlstm_chunk_sm90": {
        "w_lo_dropped": ("wa - __low2float(whi), wb - __high2float(whi)",
                         "0.f, 0.f"),
        "c_lo_dropped": ("a - __low2float(chi), b - __high2float(chi)",
                         "0.f, 0.f"),
        "wk_lo_dropped": ("xa - __low2float(khi), xb - __high2float(khi)",
                          "0.f, 0.f"),
        "previous_chunk_state": ("64 * (i >> 1), cslot);",
                                 "64 * (i >> 1), cslot - (c > 1));"),
        "diagonal_masked": ("if (!diag || key <= row)",
                            "if (!diag || key < row)"),
        "decay_1pct": ("const float decay = expf(mprev - ML);",
                       "const float decay = expf(mprev - ML) * 1.01f;"),
        "carry_dropped": ("acc[jj] *= (jj & 2) ? f1 : f0;",
                          "acc[jj] *= 0.f;"),
    },
}
# ---------------------------------------------------------------------------
# the backward (csrc/mlstm_chunk_bwd.cu)
# ---------------------------------------------------------------------------

#: the backward's card-side cases: (name, input type, B, H, S, Dq, Dv,
#: chunk, gate kind).  Gate kinds: "gates" and "stress" as ``CASES``'
#: (stress: log_f near 0, log_i over +-10, a wide spread of stabilizers);
#: "clamp": log_i = -6 + 3 N(0, 1), where many rows have |den| below the
#: clamp e^{-m_t} and many above it.  The train shape first, then a
#: reduced float32 one (the reduced xlstm's head dim) and the reduced
#: xlstm's own call (chip_smoke.py train_cpu: B = 2, S = 300, the SIMT
#: source's main path), ragged S, S below the chunk, S = 1, head dims
#: that are not multiples of the 64-wide tile and a chunk that is not
#: either; then sm90 shapes off the 256 grid: Dq 128 and Dv 192 at chunk
#: 128 (64- and 256-wide column tiles, the 64-column walks), Dq 320 at
#: chunk 192 (64-row S and dP tiles), and chunk 1024 (32 positions a lane
#: in the gate scans; past the SIMT source's shared memory)
BWD_CASES = (("train_bf16", torch.bfloat16, 4, 4, 1024, 512, 512, 256,
              "gates"),
             ("train_f32", torch.float32, 4, 4, 1024, 512, 512, 256,
              "gates"),
             ("reduced_f32", torch.float32, 2, 4, 96, 32, 32, 256,
              "gates"),
             ("train_cpu_f32", torch.float32, 2, 4, 300, 32, 32, 256,
              "gates"),
             ("ragged_1000", torch.bfloat16, 4, 4, 1000, 512, 512, 256,
              "gates"),
             ("short_100", torch.bfloat16, 4, 4, 100, 512, 512, 256,
              "gates"),
             ("one_position", torch.bfloat16, 4, 4, 1, 512, 512, 256,
              "gates"),
             ("odd_dims", torch.float32, 2, 3, 300, 40, 72, 96, "gates"),
             ("stabilizer", torch.bfloat16, 4, 4, 1024, 512, 512, 256,
              "stress"),
             ("clamp", torch.bfloat16, 4, 4, 1024, 512, 512, 256, "clamp"),
             ("dims_128_192", torch.bfloat16, 1, 2, 300, 128, 192, 128,
              "gates"),
             ("chunk_192", torch.bfloat16, 2, 2, 500, 320, 64, 192,
              "stress"),
             ("chunk_1024", torch.bfloat16, 1, 2, 1100, 64, 64, 1024,
              "gates"))
#: float32 rounding allowed per unit of ``mlstm_bwd_rounding_scale``: the
#: sums hold up to Dq + Dv + L terms, as h's do (``GAMMA["h"]``)
BWD_GAMMA = 2.0 ** -16


def mlstm_bwd_inputs(gen, B, H, S, Dq, Dv, dtype, kind):
    """q, k, v, log_f, log_i as ``mlstm_inputs`` (kind "clamp" as
    ``BWD_CASES``) and dh standard normal in `dtype`."""
    (q, k, v, log_f, log_i), _ = mlstm_inputs(gen, B, H, S, Dq, Dv, dtype,
                                              stress=kind == "stress")
    if kind == "clamp":
        log_i = torch.randn((B, H, S), generator=gen, device=gen.device) \
            * 3 - 6
    dh = torch.randn((B, H, S, Dv), generator=gen, device=gen.device) \
        .to(dtype)
    return q, k, v, log_f, log_i, dh


def mlstm_bwd_rounding_scale(q, k, v, log_f, log_i, dh, *, chunk: int = 256):
    """The scale of float32 rounding in each output of the backward
    (float64, the outputs' shapes): the backward's linear part
    (``mlstm_chunk._bwd_apply``) run over |q|, |k|, |v|, |dh| and
    carried states of absolute values, with each row's scalars widened by
    their own sensitivity.  1 / N_t (N_t = max(|den_t|, e^{-m_t})) moves
    by e_den / N^2 per unit of den's rounding scale e_den, and dd_t =
    -sign(den) dh.num / N^2 by (e_num + 2 |dh.num| e_den / N) / N^2;
    where |den_t| lies within BWD_GAMMA (e_den + e^{-m_t}) of the clamp,
    float32 may take the other branch, so dd_t's whole |dh.num| / N^2
    counts.  Returns (edq, edk, edv, edlog_f, edlog_i); the gates' scales
    are k.dk's and its suffix sums with q.dq's."""
    B, H, S, Dq = q.shape
    scale = 1.0 / math.sqrt(Dq)
    args = [a.double() for a in (q, k, v, log_f, log_i, dh)]
    chunks = mk._bwd_chunks(*args, chunk)
    absd = [a.abs() for a in args[:3]] + args[3:5] + [args[5].abs()]
    achunks = mk._bwd_chunks(*absd, chunk)
    rows = []
    for ch, ach in zip(chunks, achunks):
        den, dhnum = mk._bwd_sums(ch, scale)
        e_den, e_num = mk._bwd_sums(ach, scale)
        clamp = torch.exp(-ch["m_t"])
        n_t = torch.maximum(den.abs(), clamp)
        inv = 1.0 / n_t
        near = (den.abs() - clamp).abs() <= BWD_GAMMA * (e_den + clamp)
        dd_w = (e_num + 2.0 * dhnum.abs() * e_den * inv) * inv * inv + \
            torch.where(near, dhnum.abs() * inv * inv / BWD_GAMMA, 0.0)
        dd = torch.where(den.abs() > clamp, dhnum.abs() * inv * inv, 0.0)
        rows.append((inv + e_den * inv * inv, dd + dd_w))
    parts = mk._bwd_apply(achunks, rows, scale)
    edq, edk, edv, eR, eLi = (torch.cat([p[i] for p in parts], dim=2)
                              [:, :, :S] for i in range(5))
    edlf = torch.flip(torch.cumsum(torch.flip(eR + eLi, [-1]), -1), [-1])
    return edq, edk, edv, edlf, eLi


def mlstm_bwd_errors(got, want, scales):
    """Each output's largest |got - want| over what rounding allows,
    BWD_GAMMA * scale + OUT_STEP * |want| (the step of dq, dk, dv's type;
    the gates are float32), with `want` the plain backward in float64:
    {"dq", "dk", "dv", "dlog_f", "dlog_i": x}, every x <= 1 when the two
    agree; infinite where got holds a NaN."""
    out = {}
    for name, g, w, e in zip(("dq", "dk", "dv", "dlog_f", "dlog_i"), got,
                             want, scales):
        allowed = BWD_GAMMA * e + OUT_STEP[g.dtype] * w.abs()
        err = ((g.double() - w).abs() / allowed.clamp_min(1e-300)).max() \
            .item()
        out[name] = math.inf if math.isnan(err) else err
    return out


def bwd_reference(args):
    """The plain backward in float64 on the same inputs, and the rounding
    scale; args = (q, k, v, log_f, log_i, dh), chunk last."""
    *ins, chunk = args
    return mk.mlstm_chunkwise_bwd_plain(*(a.double() for a in ins),
                                        chunk=chunk), \
        mlstm_bwd_rounding_scale(*ins, chunk=chunk)


def clamp_rows(q, k, v, log_f, log_i, dh, chunk) -> float:
    """The share of real rows where the clamp holds (|den_t| <=
    e^{-m_t}), from the float64 sums."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    chunks = mk._bwd_chunks(*(a.double() for a in (q, k, v, log_f, log_i,
                                                   dh)), chunk)
    held = []
    for ch in chunks:
        den, _ = mk._bwd_sums(ch, scale)
        held.append(den.abs() <= torch.exp(-ch["m_t"]))
    return torch.cat(held, dim=2)[:, :, :q.shape[2]].double().mean().item()


def run_bwd(fn, q, k, v, log_f, log_i, dh, chunk, route="simt"):
    """(dq, dk, dv, dlog_f, dlog_i) of one raw launch of a backward
    variant `fn` of `route`'s source, its outputs filled with NaN
    first."""
    args, out, _ = mk.bwd_launch_args(q, k, v, log_f, log_i, dh, chunk,
                                      route=route, fill=float("nan"))
    _build.check(fn(*args), "mlstm_chunkwise_bwd (raw)")
    return out


#: planted faults of csrc/mlstm_chunk_bwd.cu: (text, replacement)
BWD_FAULTS = {
    # dq without the chunk-start state's term (C_c delta + n_c dd)
    "state_carry_dropped": ("const bool carry = c > 0;",
                            "const bool carry = false;"),
    # dk, dv without the gradient carried back from later chunks
    "grad_carry_dropped": ("const bool carry_in = c + 1 < d.nC;",
                           "const bool carry_in = false;"),
    # G_c = G_{c+1} + ...: the inter-chunk decay of dC (and dn) dropped
    "dC_decay_dropped": ("const float decay = expf(mc - ML[bh * d.nC + c]);",
                         "const float decay = 1.f;"),
    # den's gradient dropped where the clamp does not hold
    "den_grad_dropped": (
        "ddv = active ? -copysignf(1.f, den) * rNum[tid] * inv * inv : 0.f;",
        "ddv = 0.f;"),
    # den's gradient taken where the clamp holds
    "clamp_ignored": ("const bool active = fabsf(den) > clamp;",
                      "const bool active = true;"),
    # dlog_f_r summed over the pairs s <= r, not s < r
    "dlf_off_by_one": ("dlf[out + t] = run;", "dlf[out + t] = run + li_t;"),
}


#: planted faults of csrc/mlstm_chunk_bwd_sm90.cu, the kinds of
#: ``BWD_FAULTS`` and one lo product left out: (text, replacement) or a
#: list of them
BWD_FAULTS_SM90 = {
    # dq, den and num without the chunk-start state's terms
    "state_carry_dropped": [("const bool carry = c > 0;",
                             "const bool carry = false;"),
                            ("const bool state_carry = c > 0;",
                             "const bool state_carry = false;")],
    # dk, dv without the gradient carried back from later chunks
    "grad_carry_dropped": ("const bool carry_in = c + 1 < d.nC;",
                           "const bool carry_in = false;"),
    # G_c = G_{c+1} + ...: the inter-chunk decay of dC (and dn) dropped in
    # the reverse walk
    "dC_decay_dropped": [
        ("for (int jj = 0; jj < NV / 2; ++jj) acc[jj] *= decay;",
         "for (int jj = 0; jj < NV / 2; ++jj) acc[jj] *= REV ? 1.f : decay;"),
        ("nreg0 *= decay;", "nreg0 *= REV ? 1.f : decay;"),
        ("nreg1 *= decay;", "nreg1 *= REV ? 1.f : decay;")],
    # den's gradient dropped where the clamp does not hold
    "den_grad_dropped": (
        "const float ddv = active ? -copysignf(1.f, den) * num * iv * iv : "
        "0.f;", "const float ddv = 0.f;"),
    # den's gradient taken where the clamp holds
    "clamp_ignored": ("const bool active = fabsf(den) > clamp;",
                      "const bool active = true;"),
    # dlog_f_r summed over the pairs s <= r, not s < r
    "dlf_off_by_one": ("dlf[out + t] = run;", "dlf[out + t] = run + li_t;"),
    # the weights' lo halves left out of dq, dk and dv
    "w_lo_dropped": (
        "sm90::wgmma_m64k16_ss_tb<NT>(acc, dal + 2 * kk, db + 128 * kk);",
        ""),
}
#: each backward source's route (``mlstm_chunk.BWD_ROUTES``) and faults
BWD_SOURCE_ROUTE = {"mlstm_chunk_bwd": "simt",
                    "mlstm_chunk_bwd_sm90": "sm90"}
BWD_SOURCE_FAULTS = {"mlstm_chunk_bwd": BWD_FAULTS,
                     "mlstm_chunk_bwd_sm90": BWD_FAULTS_SM90}


def bwd_takes(src: str, dtype, Dq: int, Dv: int, chunk: int) -> bool:
    """Whether backward source `src` runs a case: the SIMT source every
    one whose chunk fits its shared memory, the sm90 source those of its
    route."""
    if BWD_SOURCE_ROUTE[src] == "simt":
        return mk.bwd_smem_bytes(chunk) <= mk.SMEM_LIMIT
    return mk.bwd_route(dtype, Dq, Dv, chunk) == "sm90"


#: each source's route (``mlstm_chunk.ROUTES``)
SOURCE_ROUTE = {"mlstm_chunk": "simt", "mlstm_chunk_sm90": "sm90"}


def build_variants(out_dir: Path) -> dict:
    """Compile both sources and one copy per fault of each, all at once,
    into `out_dir`; returns {source: {variant: ctypes launcher}}
    ("source" unchanged)."""
    procs = {src: _build.start_variants(src, faults, out_dir)
             for src, faults in FAULTS.items()}
    return {src: _build.finish_variants(
        procs[src], *mk.ROUTES[SOURCE_ROUTE[src]][1:]) for src in FAULTS}


def takes(src: str, dtype) -> bool:
    """Whether `src`'s route takes q, k, v of `dtype` (at the cases'
    shape): the sm90 source bf16 only."""
    return SOURCE_ROUTE[src] == "simt" or dtype == torch.bfloat16


def main() -> int:
    if not torch.cuda.is_available():
        print("mlstm_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    B, H, D, L = SHAPE["B"], SHAPE["H"], SHAPE["D"], SHAPE["chunk"]
    caught = {src: {name: [] for name in faults}
              for src, faults in FAULTS.items()}
    old_caught = {src: {name: [] for name in faults}
                  for src, faults in FAULTS.items()}
    source_ok = True
    with tempfile.TemporaryDirectory() as tmp:
        bwd_procs = {src: _build.start_variants(src, faults, Path(tmp))
                     for src, faults in BWD_SOURCE_FAULTS.items()}
        fns = build_variants(Path(tmp))
        for case, dtype, S, initial, stress in CASES:
            args, init = mlstm_inputs(gen, B, H, S, D, D, dtype,
                                      stress=stress, initial=initial)
            (want_h, want_state), scales = reference(args, L, init)
            for src, variants in fns.items():
                if not takes(src, dtype):
                    continue
                for name, fn in variants.items():
                    h, state = mk.launch_with(fn, *args, L, init,
                                              route=SOURCE_ROUTE[src])
                    errs = mlstm_errors(h, state, want_h, want_state,
                                        scales)
                    ok = all(e <= 1.0 for e in errs.values())
                    old_ok = max_scaled_ok(h, state, want_h, want_state)
                    print(json.dumps({"source": src, "variant": name,
                                      "case": case,
                                      "errors_over_allowed": errs,
                                      "ok": ok, "max_scaled_ok": old_ok}),
                          flush=True)
                    if name == "source":
                        source_ok &= ok
                    else:
                        if not ok:
                            caught[src][name].append(case)
                        if not old_ok:
                            old_caught[src][name].append(case)
        bwd_fns = {src: _build.finish_variants(
            bwd_procs[src], *mk.BWD_ROUTES[route][1:])
            for src, route in BWD_SOURCE_ROUTE.items()}
        for src, faults in BWD_SOURCE_FAULTS.items():
            caught[src] = {name: [] for name in faults}
        for case, dtype, B, H, S, Dq, Dv, L, kind in BWD_CASES:
            args = mlstm_bwd_inputs(gen, B, H, S, Dq, Dv, dtype, kind)
            want, scales = bwd_reference((*args, L))
            for src, variants in bwd_fns.items():
                if not bwd_takes(src, dtype, Dq, Dv, L):
                    continue
                for name, fn in variants.items():
                    errs = mlstm_bwd_errors(
                        run_bwd(fn, *args, L, BWD_SOURCE_ROUTE[src]), want,
                        scales)
                    ok = all(e <= 1.0 for e in errs.values())
                    print(json.dumps({"source": src, "variant": name,
                                      "case": case,
                                      "errors_over_allowed": errs,
                                      "ok": ok}), flush=True)
                    if name == "source":
                        source_ok &= ok
                    elif not ok:
                        caught[src][name].append(case)
            del args, want, scales
    missed = [f"{src}:{name}" for src, faults in caught.items()
              for name, cases in faults.items() if not cases]
    print(json.dumps({"sources_pass": source_ok, "caught_in": caught,
                      "max_scaled_caught_in": old_caught,
                      "missed": missed,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if source_ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
