"""Holding the Monte Carlo row kernels ``downtime_eval`` (plain and roster)
and ``latency_charge`` against their plain versions bit for bit, the
faults that holding must catch, their bytes, and their times on the card.

Both kernels stage whole row tiles in 16-byte pieces, so the cases reach
the edges of that tiling: a row count that is not a multiple of a tile,
narrow rows (n_pad 31 and 63, n_real < n_pad), inputs that are contiguous
views at a byte offset (``data_ptr() % 16 != 0``), roster seats outside
[0, n_real), and latency rows whose last block is ragged.  Every output is
held with ``torch.equal``.  A planted fault's copy of a source is run on
outputs filled with a sentinel first, so that a row or byte it leaves
unwritten cannot pass by holding an earlier call's value.

    PYTHONPATH=src python -m repro_torch.kernels.mc_check [--parent DIR]

builds csrc/downtime_eval.cu and csrc/latency_charge.cu and a copy of
each per planted fault (``FAULTS``) under ``build/``, runs every case
through the kernels and the copies, and prints one JSON line per case.
With ``--parent DIR`` (a checkout of an earlier commit, e.g. a ``git
archive`` of it) it also builds that commit's two sources and times both
versions' three launchers at the paper tile in turns, parent, change,
change, parent (``device_times``).  Exits 0 when the kernels pass every
case and every fault fails at least one.  Needs nvcc and a card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from . import _build
from . import pac_eval as pk

#: the paper tile: nodes, partitions, trials
N, P, B = 155, 4096, 8
#: launcher symbols by source
SYMBOLS = {"downtime_eval": ("downtime_eval_launch", "downtime_roster_launch"),
           "latency_charge": ("latency_charge_launch",)}
ARGTYPES = {"downtime_eval": pk._DT_ARGTYPES,
            "latency_charge": pk._LC_ARGTYPES}

#: planted faults: (text that occurs once in the source, replacement)
FAULTS = {
    "downtime_eval": {
        # the creps rank compared with < in place of <=
        "creps_rank_lt": ("if (rank <= rf) sc[4 * k + byte] = 1;",
                          "if (rank < rf) sc[4 * k + byte] = 1;"),
        # a roster seat outside [0, n_real) counted as up
        "seat_out_of_range_up": (
            "if (r < 0 || r >= n_real) continue;   // out of range: reads down",
            "if (r < 0 || r >= n_real) { st.n_rep += c0 == 0; continue; }"),
        # the 16-byte piece holding a range's unaligned head not loaded
        "unaligned_head_dropped": (
            "for (int i = tid; i < pieces; i += nthr)",
            "for (int i = tid + (a != a0 ? 1 : 0); i < pieces; i += nthr)"),
        # the piece holding a range's ragged tail not loaded
        "ragged_tail_dropped": (
            "const uintptr_t a1 = (a + n + 15) & ~static_cast<uintptr_t>(15);",
            "const uintptr_t a1 = (a + n) & ~static_cast<uintptr_t>(15);"),
        # the creps bytes after the last whole 16-byte piece not stored
        "creps_tail_dropped": (
            "for (uintptr_t x = hi + tid; x < b; x += nthr)    // the ragged tail",
            "for (uintptr_t x = b + tid; x < b; x += nthr)    // the ragged tail"),
    },
    "latency_charge": {
        # qsum's pay * rem contracted into an FMA with the subtraction
        "qsum_fma": ("const float v = __fsub_rn(__fmul_rn(payf, remf),",
                     "const float v = fmaf(payf, remf, -1.0f *"),
        # the decay chain multiplied highest bit first
        "chain_highest_bit_first": (
            "for (int g = 0; g < kGroup; ++g)      // bit 0 first",
            "for (int g = kGroup - 1; g >= 0; --g)      // bit 0 first"),
        # dup charged from the decayed value before the 1e-30 flush
        "dup_unflushed": (
            "du[j] = fmaxf(__fmul_rn(kfv[j], __fsub_rn(x[j], nd[j])), 0.0f);",
            "du[j] = fmaxf(__fmul_rn(kfv[j], __fsub_rn(x[j], raw)), 0.0f);"),
        # the grid rounded down: a ragged last block of rows never runs
        "ragged_block_dropped": (
            "static_cast<unsigned>((R + kRows - 1) / kRows);",
            "static_cast<unsigned>(R / kRows);"),
    },
}

#: copies timed by --ablate: one part of the work taken out, or one size
#: changed, each a list of (text, replacement)
ABLATIONS = {
    "downtime_eval": {
        "empty": [("  const bool one_pass = plan.stride == 0;\n",
                   "  const bool one_pass = plan.stride == 0;\n"
                   "  if (R > 0) return;\n")],
        "no_loads": [("    cp_async16(dst + 16 * i,",
                      "    if (n < 0) cp_async16(dst + 16 * i,")],
        "no_walk": [("    if (live && wv > 0) {",
                     "    if (live && wv > 0 && R < 0) {")],
        "no_count": [("      count_share(s_up + ou,",
                      "      if (R < 0) count_share(s_up + ou,")],
        "no_creps_store": [("      store_range(creps + row0 * n_pad, s_creps,",
                            "      if (R < 0) store_range(creps + row0 * n_pad,"
                            " s_creps,")],
        **{f"rows_{t}": [("constexpr int kMaxRows = 64;",
                          f"constexpr int kMaxRows = {t};")]
           for t in (128, 32)},
        **{f"lanes_{t}": [("constexpr int kLanes = 4;",
                           f"constexpr int kLanes = {t};")]
           for t in (1, 2, 8)},
    },
    "latency_charge": {
        "empty": [("  const int t = threadIdx.x;\n",
                   "  const int t = threadIdx.x;\n  if (R > 0) return;\n")],
        "no_tables": [("if (i < kMaxBits && i < nbits && ((d >> i) & 1) != 0)",
                       "if (i < 0)")],
        "no_qhist": [("    *reinterpret_cast<float4*>(q + e) = make_float4(",
                      "    if (v[0] < -1.0f) *reinterpret_cast<float4*>(q + e) ="
                      " make_float4(")],
        "dt_constant": [("const int d = __ldg(dt + b);",
                         "const int d = 0x1A5 + (b & 1);")],
        "no_row_stores": [
            ("    store_row<NB>(new_dirty + r * NB,",
             "    if (rm < -2000000000) store_row<NB>(new_dirty + r * NB,"),
            ("    store_row<NB>(dup + r * NB,",
             "    if (rm < -2000000000) store_row<NB>(dup + r * NB,")],
        **{f"rows_{t}": [("constexpr int kRows = 128;",
                          f"constexpr int kRows = {t};")] for t in (64, 256)},
    },
}

#: downtime cases beside chip_smoke's dense paper-tile ones: (name, R,
#: n_pad, n_real, P(up), byte offsets of up, full and roster).  Half the
#: lanes up puts the majority and the leader on single bytes, so a byte
#: read from the wrong place shows; 3 % up puts leaders and ranks deep
#: into the rows.  8 * 4093 rows leave a ragged last tile.
DOWNTIME_CASES = (("ragged_155", 8 * 4093, 155, 155, 0.5, (0, 0, 0)),
                  ("n31", 1000, 31, 31, 0.5, (0, 0, 0)),
                  ("n63_pad", 1029, 63, 60, 0.5, (0, 0, 0)),
                  ("unaligned_155", 8 * 4093, 155, 155, 0.5, (3, 9, 4)),
                  ("sparse_unaligned_160", 4099, 160, 155, 0.03, (7, 1, 12)))
#: latency cases beside the paper tile's: (name, trials, partitions, byte
#: offset of dirty and the decay tables, slo_ticks)
LATENCY_CASES = (("paper_slo0", 8, 4096, 0, 0),
                 ("paper_slo8", 8, 4096, 0, 8),
                 ("ragged_4093", 8, 4093, 0, 8),
                 ("unaligned_4096", 8, 4096, 4, 8))


# ---------------------------------------------------------------------------
# bytes each call must move (each input read once, each output written once)
# ---------------------------------------------------------------------------

def downtime_bytes(R: int, n_pad: int, rf: int = 0) -> int:
    """downtime_eval on (R, n_pad) tiles: up and full read, creps written,
    11 bytes of row outputs; with a roster (rf > 0) its 4 R rf bytes."""
    return 3 * R * n_pad + 11 * R + 4 * R * rf


def tables_touched(dt, nbits: int) -> int:
    """Decay tables some trial's interval selects: the set bits of the
    OR of dt below nbits."""
    bits = 0
    for d in dt:
        bits |= int(d)
    return bin(bits & ((1 << nbits) - 1)).count("1")


def latency_bytes(B: int, P: int, NB: int, nbins: int, tables: int) -> int:
    """latency_charge over (B, P) rows: dirty, dt, avail, qok, rem, the
    touched tables, kf and lamw read; nd, dup, qhist, qslo, qsum written."""
    R = B * P
    reads = (R * NB * 4 + 4 * B + 2 * R + 4 * R + tables * P * NB * 4
             + NB * 4 + P * 4)
    return reads + 2 * R * NB * 4 + R * nbins * 4 + 2 * R * 4


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def view_at(t, offset: int):
    """A contiguous copy of `t` whose ``data_ptr() % 16 == offset`` (a
    multiple of its element size): a view into a larger byte buffer."""
    nbytes = t.numel() * t.element_size()
    flat = torch.empty(nbytes + 32, dtype=torch.uint8, device=t.device)
    start = (offset - flat.data_ptr()) % 16
    v = flat[start:start + nbytes].view(t.dtype).view(t.shape)
    v.copy_(t)
    return v


def rosters(gen, R, rf, n_real, dev):
    """(R, rf) int32 distinct ranks in [0, n_real), with seats out of
    range (they read as down): n_real + 3 in every 7th row, -1 in every
    11th."""
    ro = torch.argsort(torch.rand((R, n_real), generator=gen, device=dev),
                       dim=1)[:, :rf].to(torch.int32)
    ro[::7, 0] = n_real + 3
    ro[::11, rf - 1] = -1
    return ro.contiguous()


def downtime_inputs(gen, case, rf, dev):
    """(up, full, roster) of a DOWNTIME_CASES entry, each at its offset."""
    _, R, n_pad, n_real, dens, (ou, of, orr) = case
    up = torch.rand((R, n_pad), generator=gen, device=dev) < dens
    full = torch.rand((R, n_pad), generator=gen, device=dev) < 0.5
    up[:5] = False                            # rows with no node up
    roster = rosters(gen, R, rf, n_real, dev)
    return view_at(up, ou), view_at(full, of), view_at(roster, orr)


def latency_inputs(gen, B, P, *, slo_ticks=8):
    """latency_charge arguments: the decay tables of the paper workload
    (zipf keys, 32 requests/tick, 3M-tick horizon: 22 tables), then
    adversarial state — dt with many bits set and 0, rem below 0, inside
    and beyond dt, mixed flags, dirty fractions a few ulps around the
    1e-30 flush floor.  Returns (kwargs, plan)."""
    from ..core import client_latency as cl
    from ..core import downtime_batched as db
    dev = gen.device
    plan = cl.make_latency_plan(0, P, db.DowntimeParams(
        key_zipf=1.0, read_frac=0.8, requests_per_tick=32.0,
        slo_ticks=slo_ticks), 3_000_000)
    NB = plan.kf.shape[0]
    dirty = torch.rand((B, P, NB), generator=gen, device=dev)
    floor = torch.tensor(1e-30, dtype=torch.float32, device=dev)
    ulps = torch.randint(-4, 5, (B, P, NB), generator=gen, device=dev)
    near = (floor.view(torch.int32) + ulps.to(torch.int32)) \
        .view(torch.float32)
    dirty = torch.where(torch.rand((B, P, NB), generator=gen, device=dev)
                        < 0.3, near, dirty)
    dt = torch.randint(0, 3_000_001, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    dt[:4] = torch.tensor([0, 0x2AAAAA, 0x155555, 2 ** 21 - 1],
                          dtype=torch.int32, device=dev)
    rem = torch.randint(0, 9_000_000, (B, P), generator=gen, device=dev,
                        dtype=torch.int32)
    inside = (dt[:, None] * torch.rand((B, P), generator=gen, device=dev)) \
        .to(torch.int32)
    below = torch.randint(-50, 0, (B, P), generator=gen, device=dev,
                          dtype=torch.int32)
    col = torch.arange(P, device=dev) % 3
    rem = torch.where(col == 0, inside, torch.where(col == 1, below, rem))
    return dict(dirty=dirty, dt_i=dt,
                avail=torch.rand((B, P), generator=gen, device=dev) < 0.7,
                qok=torch.rand((B, P), generator=gen, device=dev) < 0.7,
                rem=rem,
                pow_tables=torch.as_tensor(plan.pow_tables, device=dev),
                kf=torch.as_tensor(plan.kf, device=dev),
                lamw=torch.as_tensor(plan.lamw, device=dev)), plan


# ---------------------------------------------------------------------------
# raw launches on sentinel-filled outputs
# ---------------------------------------------------------------------------

def _ptr(t):
    return None if t is None else t.data_ptr()


def run_downtime(fn, up, full, *, rf, n_real, roster=None,
                 want_repmask=False, want_rleader=False):
    """One raw launch of a downtime launcher `fn` (plain or roster symbol,
    to match `roster`); the outputs start as True / -7, and come back in
    the wrapper's order."""
    R, n_pad = up.shape
    dev = up.device

    def rows(dtype):
        if dtype == torch.bool:
            return torch.ones(R, dtype=dtype, device=dev)
        return torch.full((R,), -7, dtype=dtype, device=dev)

    lark, qmaj, lfull = (rows(torch.bool) for _ in range(3))
    leader, nrep = rows(torch.int32), rows(torch.int32)
    repmask = rows(torch.int32) if want_repmask else None
    rleader = rows(torch.int32) if want_rleader else None
    creps = torch.ones((R, n_pad), dtype=torch.bool, device=dev)
    err = fn(up.data_ptr(), full.data_ptr(), _ptr(roster), lark.data_ptr(),
             qmaj.data_ptr(), leader.data_ptr(), lfull.data_ptr(),
             nrep.data_ptr(), _ptr(repmask), _ptr(rleader), creps.data_ptr(),
             R, n_pad, n_real, rf,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "downtime_eval (raw)")
    extras = tuple(t for t in (repmask, rleader) if t is not None)
    return (lark, qmaj, leader, lfull, nrep) + extras + (creps,)


_LC_IN = ("dirty", "dt_i", "avail", "qok", "rem", "pow_tables", "kf", "lamw")


def run_latency(fn, args, *, nbins, slo_ticks):
    """One raw launch of a latency launcher `fn`; the outputs start as
    NaN."""
    Bq, Pq, NB = args["dirty"].shape
    dev = args["dirty"].device
    outs = [torch.full(shape, float("nan"), device=dev)
            for shape in ((Bq, Pq, NB), (Bq, Pq, NB), (Bq, Pq, nbins),
                          (Bq, Pq), (Bq, Pq))]
    err = fn(*(args[k].data_ptr() for k in _LC_IN),
             *(o.data_ptr() for o in outs), Bq, Pq, NB,
             args["pow_tables"].shape[0], nbins, slo_ticks,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "latency_charge (raw)")
    return tuple(outs)


def same(got, want) -> bool:
    return len(got) == len(want) and \
        all(torch.equal(g, w) for g, w in zip(got, want))


def int_err(got, want) -> float:
    return max(float((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def float_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# the checks: one record per case, each fault's verdict in it
# ---------------------------------------------------------------------------

def downtime_checks(gen, faults, *, entry=None):
    """Run every DOWNTIME_CASES case (rf 2 and 3, first-rf and roster,
    with the extras) through ``entry`` (the wrapper by default; a raw
    launcher pair for another build) and through each fault's pair of
    launchers.  Yields one record per case: kernel name, tags, "equal",
    "max_abs_err" and "faults_failed"."""
    dev = gen.device
    for case in DOWNTIME_CASES:
        name, R, n_pad, n_real = case[:4]
        for rf in (2, 3):
            up, full, roster = downtime_inputs(gen, case, rf, dev)
            for with_roster in (False, True):
                kw = dict(rf=rf, n_real=n_real, want_repmask=True,
                          want_rleader=with_roster,
                          roster=roster if with_roster else None)
                want = pk.downtime_eval_plain(up, full, **kw)
                if entry is None:
                    got = pk.downtime_eval(up, full, **kw)
                else:
                    got = run_downtime(entry[int(with_roster)], up, full,
                                       **kw)
                failed = [f for f, fns in faults.items()
                          if not same(run_downtime(fns[int(with_roster)],
                                                   up, full, **kw), want)]
                torch.cuda.synchronize()
                yield {"kernel": "downtime_eval_roster" if with_roster
                       else "downtime_eval", "case": name, "R": R,
                       "n_pad": n_pad, "n_real": n_real, "rf": rf,
                       "offsets": list(case[5]), "equal": same(got, want),
                       "max_abs_err": int_err(got, want),
                       "faults_failed": failed}


def latency_checks(gen, faults, *, entry=None, nbins=16):
    """Run every LATENCY_CASES case through ``entry`` (the wrapper by
    default, else a raw launcher) and each fault's launcher; yields one
    record per case, as ``downtime_checks``."""
    for name, Bq, Pq, off, slo in LATENCY_CASES:
        args, _ = latency_inputs(gen, Bq, Pq, slo_ticks=slo)
        if off:
            args["dirty"] = view_at(args["dirty"], off)
            args["pow_tables"] = view_at(args["pow_tables"], off)
        want = pk.latency_charge_plain(**args, nbins=nbins, slo_ticks=slo)
        if entry is None:
            got = pk.latency_charge(**args, nbins=nbins, slo_ticks=slo)
        else:
            got = run_latency(entry[0], args, nbins=nbins, slo_ticks=slo)
        failed = [f for f, fns in faults.items()
                  if not same(run_latency(fns[0], args, nbins=nbins,
                                          slo_ticks=slo), want)]
        torch.cuda.synchronize()
        yield {"kernel": "latency_charge", "case": name, "B": Bq, "P": Pq,
               "offset": off, "slo_ticks": slo, "equal": same(got, want),
               "max_abs_err": float_err(got, want),
               "dup_sum": got[1].double().sum().item(),
               "flushed": int((got[0] == 0).sum().item()),
               "faults_failed": failed}


# ---------------------------------------------------------------------------
# device time apart from launch rate
# ---------------------------------------------------------------------------

def device_times(launch, *, reps: int = 200, cold_reps: int = 20) -> dict:
    """Times of one raw launch; ``launch(stream)`` makes it on the CUDA
    stream whose handle it is given.

    device_ms: the mean duration of the kernel under torch.profiler over
    `reps` back-to-back launches (the card's time, no launch gaps);
    graph_ms: per launch, replaying a CUDA graph of `reps` launches (the
    handle is read inside the capture, so they land on its stream);
    cold_ms: the mean time of one launch right after 128 MiB were written
    and another 128 MiB read (the 50 MB L2 holds none of its inputs, and
    no dirty line of the write is left to drain into the launch), the
    write's and read's own time taken out by an event between them and
    the launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..profile_step import _device_self_us

    def stream():
        return torch.cuda.current_stream().cuda_stream

    launch(stream())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            launch(stream())
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            total += _device_self_us(evt)
            count += evt.count
    if count == 0 or total <= 0:
        raise RuntimeError("torch.profiler saw no kernel of the launches")

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up off the capture
        launch(stream())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch(stream())
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    graph_ms = t0.elapsed_time(t1) / reps
    del graph

    flush = torch.empty(32 * 2 ** 20, dtype=torch.int32, device="cuda")
    clean = torch.zeros_like(flush)
    pairs = []
    for i in range(cold_reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        flush.fill_(i)
        clean.max()                           # evicts the dirty lines
        a.record()
        launch(stream())
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    cold_ms = sum(a.elapsed_time(b) for a, b in pairs) / cold_reps
    return {"device_ms": total / count / 1e3, "graph_ms": graph_ms,
            "cold_ms": cold_ms}


def event_ms(launch, reps: int = 200) -> float:
    """Mean ms per launch over `reps` back-to-back raw launches, by CUDA
    events (launch rate and device time together)."""
    s = torch.cuda.current_stream().cuda_stream
    launch(s)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        launch(s)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# the paper-tile shapes the main path gives the kernels, for timing
# ---------------------------------------------------------------------------

def paper_downtime(gen):
    """(up, full, roster) at the paper tile in a mostly-up cluster, rf 2."""
    dev = gen.device
    up = torch.rand((B * P, N), generator=gen, device=dev) < 0.99
    full = torch.rand((B * P, N), generator=gen, device=dev) < 0.02
    return up, full, rosters(gen, B * P, 2, N, dev)


def downtime_launch(fn, up, full, roster=None, rf=2):
    """launch(stream) for a raw downtime launcher (the roster one when
    `roster` is given) on fresh outputs (no extras), and those outputs."""
    outs = pk.downtime_eval(up, full, rf=rf, n_real=N, roster=roster)
    ptrs = (up.data_ptr(), full.data_ptr(), _ptr(roster),
            *(o.data_ptr() for o in outs[:5]), None, None,
            outs[5].data_ptr(), up.shape[0], up.shape[1], N, rf)
    return (lambda s: fn(*ptrs, s)), outs


def paper_latency(gen, nbins=16):
    """latency_charge arguments at the main path's shape: dirty fractions
    in [0, 1), intervals of a few to a few hundred ticks, rebuilds under
    128 ticks; and launch(stream) for a raw launcher on them."""
    args, _ = latency_inputs(gen, B, P)
    args["dt_i"] = torch.randint(1, 400, (B,), generator=gen,
                                 device=gen.device, dtype=torch.int32)
    args["rem"] = torch.randint(0, 128, (B, P), generator=gen,
                                device=gen.device, dtype=torch.int32)
    return args


def latency_launch(fn, args, nbins=16, slo_ticks=8):
    outs = pk.latency_charge(**args, nbins=nbins, slo_ticks=slo_ticks)
    Bq, Pq, NB = args["dirty"].shape
    ptrs = (*(args[k].data_ptr() for k in _LC_IN),
            *(o.data_ptr() for o in outs), Bq, Pq, NB,
            args["pow_tables"].shape[0], nbins, slo_ticks)
    return (lambda s: fn(*ptrs, s)), outs


# ---------------------------------------------------------------------------
# the command
# ---------------------------------------------------------------------------

def build_fault_copies(out_dir: Path) -> dict:
    """{source: {fault: tuple of its launchers}}: one built copy of each
    source per planted fault."""
    procs = {src: _build.start_variants(src, faults, out_dir,
                                        with_source=False)
             for src, faults in FAULTS.items()}
    return {src: _build.finish_variants(procs[src], SYMBOLS[src],
                                        ARGTYPES[src]) for src in FAULTS}


def ab_times(parent: dict, change: dict) -> list:
    """Each launcher at the paper tile, parent and change in turns
    (parent, change, change, parent); one record per turn."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    up, full, roster = paper_downtime(gen)
    largs = paper_latency(gen)
    out = []
    for label, src, k in (("downtime_eval", "downtime_eval", 0),
                          ("downtime_eval_roster", "downtime_eval", 1),
                          ("latency_charge", "latency_charge", 0)):
        for side in ("parent", "change", "change", "parent"):
            fn = (parent if side == "parent" else change)[src][k]
            if src == "downtime_eval":
                launch, _ = downtime_launch(fn, up, full,
                                            roster if k else None)
            else:
                launch, _ = latency_launch(fn, largs)
            out.append({"kernel": label, "side": side,
                        "ms": event_ms(launch), **device_times(launch)})
    return out


def ablate(procs: dict, change: dict) -> list:
    """device_times of each ABLATIONS copy (`procs`: {source: the handle
    of ``_build.start_variants``}) at the paper tile, beside the unchanged
    source's; the downtime copies on both launchers."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    up, full, roster = paper_downtime(gen)
    largs = paper_latency(gen)
    fns = {(src, "source"): change[src] for src in SYMBOLS}
    for src, handle in procs.items():
        for name, pair in _build.finish_variants(handle, SYMBOLS[src],
                                                 ARGTYPES[src]).items():
            fns[(src, name)] = pair
    out = []
    for (src, name), pair in sorted(fns.items()):
        if src == "downtime_eval":
            for k, label in enumerate(("downtime_eval",
                                       "downtime_eval_roster")):
                launch, _ = downtime_launch(pair[k], up, full,
                                            roster if k else None)
                out.append({"kernel": label, "variant": name,
                            **device_times(launch)})
        else:
            launch, _ = latency_launch(pair[0], largs)
            out.append({"kernel": src, "variant": name,
                        **device_times(launch)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="checkout of the commit to time "
                    "against (its src/repro_torch/kernels/csrc)")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the ABLATIONS copies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mc_check needs an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "mc_check"
    out_dir.mkdir(parents=True, exist_ok=True)
    parent_procs = {}
    if args.parent:
        csrc = Path(args.parent) / "src" / "repro_torch" / "kernels" / "csrc"
        for src in SYMBOLS:
            so = out_dir / f"lib{src}-parent.so"
            parent_procs[src] = {
                "parent": (_build._nvcc(so, csrc / f"{src}.cu"), so)}
    ablation_procs = {src: _build.start_variants(src, variants, out_dir,
                                                 with_source=False)
                      for src, variants in ABLATIONS.items()} \
        if args.ablate else {}
    faults = build_fault_copies(out_dir)
    _build.build(tuple(SYMBOLS))
    change = {src: tuple(_build.function(src, sym, ARGTYPES[src])
                         for sym in SYMBOLS[src]) for src in SYMBOLS}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    ok = True
    caught = {src: {f: [] for f in fl} for src, fl in FAULTS.items()}
    for src, checks in (("downtime_eval", downtime_checks),
                        ("latency_charge", latency_checks)):
        for rec in checks(gen, faults[src]):
            print(json.dumps(rec), flush=True)
            ok = ok and rec["equal"]
            for f in rec["faults_failed"]:
                caught[src][f].append(f"{rec['kernel']}:{rec['case']}")
    missed = [f for fl in caught.values() for f, cases in fl.items()
              if not cases]
    print(json.dumps({"faults_caught_in": caught, "missed": missed}),
          flush=True)
    if parent_procs:
        parent = {src: _build.finish_variants(handle, SYMBOLS[src],
                                              ARGTYPES[src])["parent"]
                  for src, handle in parent_procs.items()}
        for rec in ab_times(parent, change):
            print(json.dumps({"ab": rec}), flush=True)
    for rec in ablate(ablation_procs, change) if ablation_procs else ():
        print(json.dumps({"ablate": rec}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "kernels_equal": ok, "faults_missed": missed}))
    return 0 if ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
