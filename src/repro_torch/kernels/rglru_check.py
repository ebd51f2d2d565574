"""Holding ``rglru_scan`` against its plain version, and the faults that
holding must catch.

h_t = a_t h_{t-1} + b_t sums terms whose weights are products of the a's,
so two float32 evaluations of it in different orders (the kernel's
chunks, the plain version's walk) differ by rounding that accumulates
along the recurrence and is largest where a -> 1 (long memory).  Each
element is held against the scale of its own rounding: the same
recurrence run over |b| (``e_t = a_t e_{t-1} + |b_t|``, a bound on |h_t|
and on every partial sum behind it).  ``rglru_allowance`` runs the
recurrence once more over what each step may add, ``GAMMA e_t`` for the
step's own roundings, b's sensitivity to the rounding of exp(2 log_a)
where 1 - exp(2 log_a) cancels, and ``ETA`` for underflow below float32's
subnormals.  The reference is the plain version in float64 on the same
inputs.

    PYTHONPATH=src python -m repro_torch.kernels.rglru_check [--parent DIR]
        [--ablate]

builds csrc/rglru_scan.cu and copies of it with one planted fault each
(``FAULTS``: the chain's incoming carry read as 0 or one chunk late, the
ragged last chunk not stored, the decay 1 % high, sqrt(1 - a^2) replaced
by 1 - a) under ``build/``, runs every case of ``CASES`` through each on
the card, on outputs filled with NaN first (so a value left unwritten
fails), and prints per variant and case the largest error over its
allowance.  The same for the backward, csrc/rglru_scan_bwd.cu, on
``BWD_CASES`` against ``rglru_bwd_allowance`` with ``BWD_FAULTS`` (the
reverse recurrence with a_t for a_{t+1}, h_t for h_{t-1}, the chunk carry
dropped, the sqrt term of dla dropped, the clamp's 0 not taken, a stage
row one position off).  With ``--parent DIR`` (a checkout of an earlier
commit, e.g. a ``git archive`` of it) it also builds that commit's
rglru_scan.cu and rglru_scan_bwd.cu, binds each by the launcher signature
its own text declares (``launcher_argtypes``: the one-launch forward, or
the three-launch one of ``PARENT_ARGTYPES``), runs both on every case and
prints whether the parent's h, dx and dla equal this source's bit for bit
(else the first element that differs), then times each pair in turns,
parent, change, change, parent (``mc_check.device_times``: device, graph
and L2-cold): the forward at the serve shape, the backward at each of
``BWD_TIMED_SHAPES``.  ``--ablate`` times copies with one part of the
work taken out (``ABLATIONS``, ``BWD_ABLATIONS``) beside the sources at
those shapes.  It exits 0 when the sources pass every case and every
fault fails at least one.  Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import sys
from pathlib import Path

import torch

from . import _build, mc_check
from . import rglru_scan as rk

#: the card-side cases at the recurrentgemma-9b serve width (B = 4):
#: (name, S, W, gate kind).  Gate kinds: "uniform" log_a ~ -U(0.01, 2),
#: the range of tests/test_kernels.py; "model" the RG-LRU block's own
#: gates, -8 softplus(lam) sigmoid(z) with lam from its initializer;
#: "long" log_a = -10^U(-7, -3) (a -> 1, where sqrt(1 - a^2) cancels);
#: "short" log_a = -10^U(1, 2.5) (a -> 0)
CASES = (("serve", 3072, 4096, "uniform"),
         ("ragged_3000", 3000, 4000, "uniform"),
         ("model_gates", 3072, 4096, "model"),
         ("long_memory", 3072, 4096, "long"),
         ("short_memory", 3072, 4096, "short"))
BATCH = 4

#: what one step of the recurrence may add to an element's error, per
#: unit of its rounding scale e_t: 2^-20 (16 float32 units), for the
#: rounding of a = exp(log_a) (2 ulp), of the multiply-add and of b's
#: sqrt and product
GAMMA = 2.0 ** -20
#: exp(2 log_a) is computed to 2 ulp (2^-23 near 1), so b = sqrt(y) x,
#: y = 1 - exp(2 log_a), may be off by |x| min(2^-11, 2^-23 / sqrt(y))
Y_ERR = 2.0 ** -23
#: what underflow may add per step whatever the scale: float32 rounds
#: below its subnormals (2^-149) with an absolute error up to 2^-150 per
#: operation (a h_{t-1} with a ~ e^-182 is 0 in float32); four of them
ETA = 2.0 ** -148


def rglru_inputs(gen, B, S, W, kind):
    """Random x (float32 standard normal) and log_a of `kind` (see
    ``CASES``) on `gen`'s device."""
    dev = gen.device

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    x = torch.randn((B, S, W), generator=gen, device=dev)
    if kind == "uniform":
        la = -(0.01 + 1.99 * uniform(B, S, W))
    elif kind == "model":
        u = 0.1 + 0.8 * uniform(W)
        lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
        r = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev))
        la = -8.0 * torch.nn.functional.softplus(lam) * r
    elif kind == "long":
        la = -torch.pow(10.0, -7.0 + 4.0 * uniform(B, S, W))
    elif kind == "short":
        la = -torch.pow(10.0, 1.0 + 1.5 * uniform(B, S, W))
    else:
        raise ValueError(f"unknown gate kind {kind!r}")
    return x, la


def rglru_allowance(x, log_a):
    """How far a float32 evaluation of the recurrence may lie from the
    exact one, per element (float64, (B, S, W)): the recurrence run over
    GAMMA e_t + |x_t| min(2^-11, Y_ERR / sqrt(y_t)) + ETA, with e_t the
    same recurrence over |b_t|."""
    x, la = x.double(), log_a.double()
    a, b = rk.rglru_coefficients(x, la)
    y = torch.clamp(1.0 - torch.exp(2.0 * la), min=0.0)
    db = x.abs() * torch.clamp(Y_ERR / torch.sqrt(y), max=2.0 ** -11)
    e = torch.zeros_like(b[:, 0])
    err = torch.zeros_like(e)
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        e = a[:, t] * e + b[:, t].abs()
        err = a[:, t] * err + GAMMA * e + db[:, t] + ETA
        out[:, t] = err
    return out


def reference(x, log_a):
    """The plain version in float64 on the same inputs, and the
    allowance."""
    return rk.rglru_scan_plain(x.double(), log_a.double()), \
        rglru_allowance(x, log_a)


def rglru_error(h, want, allowed) -> float:
    """The largest |h - want| over its allowance (<= 1 when they
    agree; infinite where h holds a NaN)."""
    d = (h.double() - want).abs()
    err = (d / allowed.clamp_min(1e-300)).max().item()
    return math.inf if math.isnan(err) else err


#: the backward's card-side cases at the recurrentgemma-9b train width
#: (B = 2): (name, S, W, gate kind), the kinds of ``CASES`` and "zero":
#: log_a = -10^U(-10, -5), where 1 - exp(2 log_a) rounds to 0 in float32
#: (|log_a| below about 3e-8) or keeps few bits, and the float64
#: derivative of sqrt(1 - exp(2 log_a)) is large
BWD_CASES = (("train", 2048, 4096, "model"),
             ("ragged_2000_w4000", 2000, 4000, "uniform"),
             ("short_50", 50, 4096, "uniform"),
             ("one_position", 1, 4096, "uniform"),
             ("reduced", 48, 64, "model"),
             ("long_memory", 2048, 4096, "long"),
             ("near_zero", 2048, 4096, "zero"))
BWD_BATCH = 2


def rglru_bwd_inputs(gen, B, S, W, kind):
    """x, log_a as ``rglru_inputs`` (kind "zero" as ``BWD_CASES``), h the
    forward in float64 rounded to float32, and dh standard normal."""
    if kind == "zero":
        x, _ = rglru_inputs(gen, B, S, W, "uniform")
        u = torch.rand((B, S, W), generator=gen, device=gen.device)
        la = -torch.pow(10.0, -10.0 + 5.0 * u)
    else:
        x, la = rglru_inputs(gen, B, S, W, kind)
    h = rk.rglru_scan_plain(x.double(), la.double()).float()
    dh = torch.randn((B, S, W), generator=gen, device=gen.device)
    return x, la, h, dh


def rglru_bwd_allowance(x, log_a, h, dh):
    """How far a float32 evaluation of the backward may lie from the exact
    one, per element of (dx, dla) (float64): the reverse recurrence over
    |dh| (e_t = |dh_t| + a_{t+1} e_{t+1}) is the rounding scale of g, whose
    error err_t = a_{t+1} err_{t+1} + GAMMA e_t + ETA runs backwards as the
    forward's does; then
      dx:  err s + |g| min(2^-10, Y_ERR / sqrt(y)) + GAMMA |g s|,
      dla: err (|h_{t-1}| a + |x e2 / s|) + GAMMA |g h_{t-1} a|
           + |g x e2 / s| (ill + GAMMA),
    with y = 1 - e2 and e2 = exp(2 log_a).  float32 knows y only to
    Y_ERR, and its smallest nonzero value is 2^-24, so the second term of
    dla, proportional to 1 / sqrt(y), may be off by ill = sqrt(y /
    max(y - Y_ERR, 2^-24)) - 1, and wholly (ill = 1: the kernel may take
    the clamp's 0) where y <= Y_ERR.  h is an input, exact on both
    sides."""
    x, la, h, dh = (t.double() for t in (x, log_a, h, dh))
    a = torch.exp(la)
    e2 = torch.exp(2.0 * la)
    y = torch.clamp(1.0 - e2, min=0.0)
    s = torch.sqrt(y)
    ds = torch.clamp(Y_ERR / s, max=2.0 ** -10)
    big = torch.where(s > 0, (x * e2 / torch.where(s > 0, s, 1.0)).abs(),
                      0.0)
    low = torch.clamp(y - Y_ERR, min=2.0 ** -24)
    ill = torch.where(y > Y_ERR, torch.sqrt(y / low) - 1.0, 1.0)
    adx, adla = torch.empty_like(x), torch.empty_like(x)
    g = torch.zeros_like(x[:, 0])
    e = torch.zeros_like(g)
    err = torch.zeros_like(g)
    a_next = torch.zeros_like(g)
    for t in range(x.shape[1] - 1, -1, -1):
        g = dh[:, t] + a_next * g
        e = dh[:, t].abs() + a_next * e
        err = a_next * err + GAMMA * e + ETA
        hp = h[:, t - 1].abs() if t else torch.zeros_like(g)
        adx[:, t] = err * s[:, t] + g.abs() * ds[:, t] + \
            GAMMA * (g * s[:, t]).abs() + ETA
        adla[:, t] = err * (hp * a[:, t] + big[:, t]) + \
            GAMMA * (g.abs() * hp * a[:, t]) + \
            (g.abs() * big[:, t]) * (ill[:, t] + GAMMA) + ETA
        a_next = a[:, t]
    return adx, adla


def bwd_reference(x, log_a, h, dh):
    """The plain backward in float64 on the same inputs, and the
    allowance."""
    return rk.rglru_scan_bwd_plain(x.double(), log_a.double(), h.double(),
                                   dh.double()), \
        rglru_bwd_allowance(x, log_a, h, dh)


def rglru_bwd_error(got, want, allowed) -> float:
    """The largest error over its allowance of dx and dla."""
    return max(rglru_error(g, w, a) for g, w, a in zip(got, want, allowed))


def run_bwd(fn, x, log_a, h, dh):
    """(dx, dla) of one raw launch of a backward variant `fn`, its outputs
    filled with NaN first."""
    out, args, _ = rk.bwd_launch_args(x, log_a, h, dh, fill=float("nan"))
    _build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                 "rglru_scan_bwd (raw)")
    return out


#: planted faults of csrc/rglru_scan_bwd.cu: (text, replacement) or a list
#: of them
BWD_FAULTS = {
    # g_t = dh_t + a_t g_{t+1}: the decay of the wrong position
    "a_t_for_a_next": [("const float g = __fadd_rn(in(kDh, j), G);",
                        "const float g = __fadd_rn(in(kDh, j), "
                        "__fmul_rn(a, G));"),
                       ("        G = __fmul_rn(a, g);", "        G = g;")],
    # h_t staged for h_{t-1}
    "h_t_for_h_prev": ("cp_async4(slot(col, kHPrev, j), h + i - W);",
                       "cp_async4(slot(col, kHPrev, j), h + i);"),
    # the chain's incoming carry from the next chunk read as 0
    "carry_dropped": ("gin = __uint_as_float(static_cast<uint32_t>(word));",
                      "gin = 0.f;"),
    # dla without -g x e2 / s
    "sqrt_term_dropped": (
        "s > 0.f ? __fdiv_rn(__fmul_rn(__fmul_rn(g, in(kX, j)), e), s)\n"
        "                    : 0.f;", "0.f;"),
    # the clamp branch's 0 not taken: inf or NaN where 1 - e2 rounds to 0
    "clamp_unguarded": (
        "s > 0.f ? __fdiv_rn(__fmul_rn(__fmul_rn(g, in(kX, j)), e), s)\n"
        "                    : 0.f;",
        "__fdiv_rn(__fmul_rn(__fmul_rn(g, in(kX, j)), e), s);"),
    # x read from the stage row one position on, one that the next unit's
    # copies may already fill
    "stage_row_off_by_one": ("__fmul_rn(g, in(kX, j))",
                             "__fmul_rn(g, in(kX, (j + 1) % kChunk))"),
}
#: the backward is timed at the train path's microbatch (recurrentgemma-9b
#: train_rg: a batch of 2 in 2 microbatches, so each launch has B = 1) and
#: at a batch of 2
BWD_TIMED_SHAPES = ((2, 2048, 4096), (1, 2048, 4096))
#: copies timed by --ablate, one part of the backward's work taken out, or
#: (``probe_``) another chunk, tile or blocks an SM: (text, replacement)
#: pairs; their outputs are not held to the allowance, only reported
BWD_ABLATIONS = {
    # the launch, the memset and one ticket a block, nothing else
    "empty": [("  if (mine >= units) return;                // block-uniform",
               "  if (mine < units + 1u) return;           // block-uniform")],
    # no chunk waits for its successor's carry
    "no_chain_wait": [("const int succ = u.c + 1;", "const int succ = NC;")],
    # dx and dla computed but not stored
    "no_stores": [("__stcs(dx + i, ", "if (g == 1234.5f) __stcs(dx + i, "),
                  ("__stcs(dla + i, ", "if (g == 1234.5f) __stcs(dla + i, ")],
    # a_t = e_t = log_a_t, s_t = e_t: no expf, no sqrtf
    "no_coefficients": [
        ("{ return expf(la); }", "{ return la; }"),
        ("{ return expf(2.f * la); }", "{ return la; }"),
        ("return sqrtf(fmaxf(__fsub_rn(1.f, e), 0.f));", "return e;")],
    # no stage: no copies, the walks read their inputs from global memory
    "no_stage": [
        ("  const size_t i = u.base + static_cast<size_t>(j) * W;   "
         "// position t0 + j\n",
         "  return;\n  const size_t i = u.base + static_cast<size_t>(j) * W;\n"),
        ("      return *slot(col, k, j);\n",
         "      const size_t i = u.base + static_cast<size_t>(j) * W;\n"
         "      return k == kLogA ? log_a[i] : k == kDh ? dh[i]\n"
         "           : k == kX ? x[i] : (u.c > 0 || j > 0) ? h[i - W] : 0.f;\n")],
    # the next ticket asked for before the first walk, not after the wait
    "probe_ticket_first": [
        ("    cp_async_wait_all();                    // this column's copies "
         "landed\n",
         "    unsigned asked = 0;\n"
         "    if (threadIdx.x == 0) asked = atomicAdd(ticket, 1u);\n"
         "    cp_async_wait_all();\n"),
        ("    if (threadIdx.x == 0) s_ticket[round & 1] = atomicAdd(ticket, 1u);\n",
         "    if (threadIdx.x == 0) s_ticket[round & 1] = asked;\n")],
    # no sleep between two polls of the chain
    "probe_poll_spin": [("          __nanosleep(64);\n", "")],
    # chunks of 32 positions (a 64 KB stage), three blocks an SM
    "probe_chunk32": [
        ("constexpr int kChunk = 16;", "constexpr int kChunk = 32;"),
        ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 3;")],
    # chunks of 24 positions (a 48 KB stage), four blocks an SM
    "probe_chunk24": [
        ("constexpr int kChunk = 16;", "constexpr int kChunk = 24;"),
        ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 4;")],
    # tiles of 64 channels (a 16 KB stage), twelve blocks an SM
    "probe_tile64": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 64;"),
        ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 12;")],
}

#: planted faults: (text of csrc/rglru_scan.cu, its replacement)
FAULTS = {
    # the chain's incoming carry H_{c-1} read as 0: every chunk from h = 0
    "carry_dropped": ("hin = __uint_as_float(static_cast<uint32_t>(word));",
                      "hin = 0.f;"),
    # H_{c-2} taken for H_{c-1}: the chain one chunk late
    "carry_one_chunk_late": ("const int p = c - 1;", "const int p = c - 2;"),
    # the last chunk's h not stored where S is not a multiple of the chunk
    "ragged_chunk_dropped": (
        "__stcs(out + base + static_cast<size_t>(j) * W, h);",
        "if (n == kChunk) __stcs(out + base + static_cast<size_t>(j) * W, h);"),
    "decay_1pct": ("{ return expf(la); }", "{ return expf(la) * 1.01f; }"),
    "one_minus_a": ("sqrtf(fmaxf(1.f - expf(2.f * la), 0.f))",
                    "(1.f - expf(la))"),
}

#: copies timed by --ablate, one part of the work taken out: (text,
#: replacement) pairs; their h is not checked
ABLATIONS = {
    # the launch, the memset and one ticket a block, nothing else
    "empty": [("  if (mine >= units) return;                // block-uniform",
               "  if (mine < units + 1u) return;           // block-uniform")],
    # a_t = log_a_t, b_t = x_t: no expf, no sqrtf
    "no_coefficients": [("{ return expf(la); }", "{ return la; }"),
                        ("return sqrtf(fmaxf(1.f - expf(2.f * la), 0.f)) * x;",
                         "return x;")],
    # no chunk waits for its predecessor's carry
    "no_chain_wait": [("const int p = c - 1;", "const int p = -1;")],
    # h computed but not stored
    "no_stores": [("__stcs(out + base + static_cast<size_t>(j) * W, h);",
                   "if (h == 1234.5f) __stcs(out + base + j, h);")],
    # the next unit's copies started before the coefficients, not after
    "probe_prefetch_first": [
        ("    // the next unit's loads fly while this one runs (the stage's values\n"
         "    // are all in registers and used above)\n"
         "    if (threadIdx.x == 0) s_ticket[round & 1] = atomicAdd(ticket, 1u);\n"
         "    __syncthreads();\n"
         "    const unsigned next = s_ticket[round & 1];\n"
         "    if (next < units) prefetch(unit_of(next, B, S, W), col, x, log_a, W);\n",
         ""),
        ("#pragma unroll\n    for (int j = 0; j < kChunk; ++j) {\n"
         "      const float la = a[j];\n",
         "    if (threadIdx.x == 0) s_ticket[round & 1] = atomicAdd(ticket, 1u);\n"
         "    __syncthreads();\n"
         "    const unsigned next = s_ticket[round & 1];\n"
         "    if (next < units) prefetch(unit_of(next, B, S, W), col, x, log_a, W);\n"
         "#pragma unroll\n    for (int j = 0; j < kChunk; ++j) {\n"
         "      const float la = a[j];\n")],
}

#: the C interface of the three-launch source the forward's one launch
#: replaced: (x, log_a, h, Ac, Bc, Hin, B, S, W, stream), Ac, Bc and Hin
#: scratch of (B, ceil(S / 64), W) float32 each
PARENT_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + \
    (ctypes.c_void_p,)
#: the serve shape both forward sources are timed at: (B, S, W)
TIMED_SHAPE = (BATCH, 3072, 4096)


#: the ctypes argtypes of a C launcher as a source's text declares it
launcher_argtypes = _build.launcher_argtypes


def parent_args(x, log_a, *, fill=None):
    """``rglru_scan.launch_args`` for ``PARENT_ARGTYPES``: (h, args,
    keep)."""
    B, S, W = x.shape
    NC = -(-S // 64)
    x, la = (t.to(torch.float32).contiguous() for t in (x, log_a))
    h = torch.empty_like(x)
    if fill is not None:
        h.fill_(fill)
    scratch = [torch.empty((B, NC, W), dtype=torch.float32, device=x.device)
               for _ in range(3)]
    args = (x.data_ptr(), la.data_ptr(), h.data_ptr(),
            *(t.data_ptr() for t in scratch), B, S, W)
    return h, args, (x, la, *scratch)


#: the forward's launch arguments by the interface a source declares
FORWARD_ARGS = {tuple(rk._ARGTYPES): rk.launch_args,
                tuple(PARENT_ARGTYPES): parent_args}


def run(fn, make_args, x, log_a):
    """h of one raw launch of `fn` on `make_args`' arguments, h filled
    with NaN first."""
    h, args, _ = make_args(x, log_a, fill=float("nan"))
    _build.check(fn(*args, torch.cuda.current_stream().cuda_stream),
                 "rglru_scan (raw)")
    return h


def first_difference(parent, change):
    """None when float32 tensors `parent` and `change` are equal bit for
    bit, else the first element (in memory order) whose bits differ, its
    two values, and how many elements differ."""
    ne = (parent.view(torch.int32) != change.view(torch.int32)).flatten()
    count = int(ne.sum().item())
    if count == 0:
        return None
    i = int(ne.nonzero()[0].item())
    index = []
    for dim in reversed(parent.shape):
        index.append(i % dim)
        i //= dim
    index = index[::-1]
    return {"index": index, "parent": parent[tuple(index)].item(),
            "change": change[tuple(index)].item(), "count": count}


def _times(launch) -> dict:
    return {"ms": mc_check.event_ms(launch, reps=50),
            **mc_check.device_times(launch, reps=50, cold_reps=10)}


def ablation_times(fns: dict) -> list:
    """``_times`` of each forward copy in `fns` ({variant: ctypes
    launcher}, the unchanged "source" among them) at ``TIMED_SHAPE``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(21)
    x, la = rglru_inputs(gen, *TIMED_SHAPE, "uniform")
    # keep h and the scratch alive: device_times captures a CUDA graph,
    # which first frees PyTorch's cached blocks (torch.cuda.empty_cache)
    _, args, keep = rk.launch_args(x, la)
    out = []
    for name, fn in fns.items():
        def launch(stream, fn=fn):
            return fn(*args, stream)

        out.append({"variant": name, "shape": list(TIMED_SHAPE),
                    **_times(launch)})
    del keep
    return out


def bwd_ablation_times(fns: dict) -> list:
    """``_times`` of each backward copy in `fns` (the unchanged "source"
    among them) at each of ``BWD_TIMED_SHAPES`` (the train path's gates),
    with its outputs' error over the allowance on those inputs."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    out = []
    for shape in BWD_TIMED_SHAPES:
        ins = rglru_bwd_inputs(gen, *shape, "model")
        want, allowed = bwd_reference(*ins)
        for name, fn in fns.items():
            got, args, keep = rk.bwd_launch_args(*ins, fill=float("nan"))

            def launch(stream, fn=fn, args=args):
                return fn(*args, stream)

            _build.check(launch(torch.cuda.current_stream().cuda_stream),
                         f"rglru_scan_bwd ({name})")
            err = rglru_bwd_error(got, want, allowed)
            out.append({"variant": name, "shape": list(shape),
                        "error_over_allowed": err, **_times(launch)})
            del got, keep
        del ins, want, allowed
    return out


def timed_turns(sides: dict, shape) -> list:
    """Both sides' launches ({side: launch(stream)}) in turns parent,
    change, change, parent at `shape`: CUDA-event ms and
    ``mc_check.device_times`` per turn."""
    out = []
    for side in ("parent", "change", "change", "parent"):
        out.append({"side": side, "shape": list(shape),
                    **_times(sides[side])})
    return out


def forward_turns(parent, parent_make, change) -> list:
    """The forward sources at ``TIMED_SHAPE`` (uniform gates) in turns."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    x, la = rglru_inputs(gen, *TIMED_SHAPE, "uniform")
    # the outputs and scratch behind the pointers stay alive: device_times
    # captures a CUDA graph, which first frees PyTorch's cached blocks
    sides, keep = {}, []
    for side, fn, make in (("parent", parent, parent_make),
                           ("change", change, rk.launch_args)):
        out, args, held = make(x, la)
        keep.append((out, held))
        sides[side] = (lambda s, fn=fn, args=args: fn(*args, s))
    return timed_turns(sides, TIMED_SHAPE)


def backward_turns(parent, change) -> list:
    """The backward sources at each of ``BWD_TIMED_SHAPES`` (the train
    path's gates) in turns."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(26)
    out = []
    for shape in BWD_TIMED_SHAPES:
        ins = rglru_bwd_inputs(gen, *shape, "model")
        sides, keep = {}, []
        for side, fn in (("parent", parent), ("change", change)):
            out_, args, held = rk.bwd_launch_args(*ins)
            keep.append((out_, held))
            sides[side] = (lambda s, fn=fn, args=args: fn(*args, s))
        out += timed_turns(sides, shape)
        del ins, keep
    return out


def build_parent(root, out_dir):
    """nvcc, started, on the parent checkout `root`'s forward and backward
    sources: {name: (handle for ``_build.finish_variants``, argtypes,
    text)}, each bound by the launcher its own text declares."""
    found = {}
    for name in ("rglru_scan", "rglru_scan_bwd"):
        src = Path(root) / "src" / "repro_torch" / "kernels" / "csrc" / \
            f"{name}.cu"
        text = src.read_text()
        so = out_dir / f"lib{name}-parent.so"
        found[name] = ({"parent": (_build._nvcc(so, src), so)},
                       launcher_argtypes(text, f"{name}_launch"), text)
    return found


def main(argv=()) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to compare "
                    "with (its src/repro_torch/kernels/csrc/rglru_scan.cu "
                    "and rglru_scan_bwd.cu)")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the ABLATIONS and BWD_ABLATIONS copies")
    args = ap.parse_args(list(argv))
    if not torch.cuda.is_available():
        print("rglru_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = _build.start_variants("rglru_scan", FAULTS, out_dir)
    bwd_procs = _build.start_variants("rglru_scan_bwd", BWD_FAULTS, out_dir)
    ablated = bwd_ablated = None
    if args.ablate:
        ablated = _build.start_variants(
            "rglru_scan", {f"ablate_{k}": v for k, v in ABLATIONS.items()},
            out_dir, with_source=False)
        bwd_ablated = _build.start_variants(
            "rglru_scan_bwd",
            {f"ablate_{k}": v for k, v in BWD_ABLATIONS.items()}, out_dir,
            with_source=False)
    parent = build_parent(args.parent, out_dir) if args.parent else None
    fns = _build.finish_variants(procs, "rglru_scan_launch", rk._ARGTYPES)
    parent_fwd = parent_bwd = None
    if parent is not None:
        handle, types, _ = parent["rglru_scan"]
        if types not in FORWARD_ARGS:
            raise SystemExit(f"rglru_check: the parent's rglru_scan_launch "
                             f"has {len(types)} parameters of an unknown "
                             f"interface")
        parent_fwd = (_build.finish_variants(handle, "rglru_scan_launch",
                                             types)["parent"],
                      FORWARD_ARGS[types])
        handle, types, text = parent["rglru_scan_bwd"]
        if types != tuple(rk.BWD_ARGTYPES):
            raise SystemExit("rglru_check: the parent's rglru_scan_bwd_launch "
                             "is not this source's interface")
        if int(re.search(r"constexpr int kChunk = (\d+);", text)
               .group(1)) < rk.BWD_CHUNK:
            raise SystemExit("rglru_check: the parent's backward has a "
                             "smaller chunk than bwd_launch_args' scratch "
                             "serves")
        parent_bwd = _build.finish_variants(handle, "rglru_scan_bwd_launch",
                                            types)["parent"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    caught = {name: [] for name in FAULTS}
    caught.update({f"bwd_{name}": [] for name in BWD_FAULTS})
    source_ok = True
    all_equal = bwd_all_equal = True
    for case, S, W, kind in CASES:
        x, la = rglru_inputs(gen, BATCH, S, W, kind)
        want, allowed = reference(x, la)
        for name, fn in fns.items():
            h = run(fn, rk.launch_args, x, la)
            err = rglru_error(h, want, allowed)
            ok = err <= 1.0
            print(json.dumps({"variant": name, "case": case,
                              "error_over_allowed": err, "ok": ok}),
                  flush=True)
            if name == "source":
                source_ok &= ok
                source_h = h
            elif not ok:
                caught[name].append(case)
            del h
        if parent_fwd is not None:
            diff = first_difference(run(*parent_fwd, x, la), source_h)
            all_equal &= diff is None
            print(json.dumps({"parent": case, "bitwise_equal": diff is None,
                              "first_difference": diff}), flush=True)
        del x, la, want, allowed, source_h
    bwd_fns = _build.finish_variants(bwd_procs, "rglru_scan_bwd_launch",
                                     rk.BWD_ARGTYPES)
    for case, S, W, kind in BWD_CASES:
        x, la, h, dh = rglru_bwd_inputs(gen, BWD_BATCH, S, W, kind)
        want, allowed = bwd_reference(x, la, h, dh)
        for name, fn in bwd_fns.items():
            got = run_bwd(fn, x, la, h, dh)
            err = rglru_bwd_error(got, want, allowed)
            ok = err <= 1.0
            print(json.dumps({"variant": f"bwd_{name}", "case": case,
                              "error_over_allowed": err, "ok": ok}),
                  flush=True)
            if name == "source":
                source_ok &= ok
                source_got = got
            elif not ok:
                caught[f"bwd_{name}"].append(case)
            del got
        if parent_bwd is not None:
            diffs = {k: first_difference(p, c) for k, p, c in zip(
                ("dx", "dla"), run_bwd(parent_bwd, x, la, h, dh), source_got)}
            equal = all(d is None for d in diffs.values())
            bwd_all_equal &= equal
            print(json.dumps({"parent_bwd": case, "bitwise_equal": equal,
                              "first_difference": diffs}), flush=True)
        del x, la, h, dh, want, allowed, source_got
    missed = [name for name, cases in caught.items() if not cases]
    summary = {"source_passes": source_ok, "caught_in": caught,
               "missed": missed, "gpu": torch.cuda.get_device_name(0)}
    if parent is not None:
        for rec in forward_turns(*parent_fwd, fns["source"]):
            print(json.dumps({"ab": rec}), flush=True)
        for rec in backward_turns(parent_bwd, bwd_fns["source"]):
            print(json.dumps({"ab_bwd": rec}), flush=True)
        summary["parent_bitwise_equal_on_every_case"] = all_equal
        summary["parent_bwd_bitwise_equal_on_every_case"] = bwd_all_equal
    if ablated is not None:
        copies = {"source": fns["source"], **_build.finish_variants(
            ablated, "rglru_scan_launch", rk._ARGTYPES)}
        for rec in ablation_times(copies):
            print(json.dumps({"ablate": rec}), flush=True)
        copies = {"source": bwd_fns["source"], **_build.finish_variants(
            bwd_ablated, "rglru_scan_bwd_launch", rk.BWD_ARGTYPES)}
        for rec in bwd_ablation_times(copies):
            print(json.dumps({"ablate_bwd": rec}), flush=True)
    print(json.dumps(summary), flush=True)
    return 0 if source_ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
