"""Per-partition throughput/latency micro-simulator — paper §5.2, Tables
3-4 (port of ``repro/core/microsim.py``).

A 1 ms-tick queueing simulation of one partition under a node outage:
processor sharing over (AGES x 2) read/write age cohorts, uniform
arrivals at u * bw / avg request bytes split 80/20 by a random draw, a
node failure at FAIL_T and its return at RECOVER_T.  LARK serves through
the outage and backfills the keys written meanwhile at 20% of bw; the
baseline hydrates a replacement and rejects arrivals for min(ps/bw, 300)
s.  ``MicroConfig``, the constants, ``TABLE_GRID``, ``table_configs`` and
``run_table`` are the reference's; the model and its measurement window
are documented there.

The tick loop has two implementations with one contract, bit for bit
equal to the reference's ``_sim_jit`` as XLA compiles it for the CPU:

  * ``_simulate_batch_plain`` — plain PyTorch, one tick per Python step,
    on any device (the CPU tests and the card-side check use it);
  * ``kernels/microsim_scan.py: microsim_scan`` — the CUDA kernel, one
    warp per (row, mode), the arrivals counted ahead of the queues.

Both take the arrivals from one pre-pass, ``arrivals_plain`` here: a
tick's read and write counts depend on the seed, the tick, the row's rate
accumulator and its read fraction alone, never on the queue.
``run_table`` and ``run_tables`` (both tables in one call) launch the
kernel on a CUDA device and run the plain version on the CPU.

What XLA does to the reference's float32 arithmetic, and the port with it
(read from the CPU compile's object code: three fusions hold a
``vfmadd``; jax 0.9.0, x86-64 with FMA):

  * a division by the constant TICKS_PER_S becomes a multiply by
    float32(0.001): ``rate_pt``, ``bf_rate`` and ``fg_bw`` are
    ``x * 0.001``, not ``x / 1000``;
  * three multiply-adds are contracted into one correctly rounded fused
    multiply-add (``fma_f32`` here, ``__fmaf_rn`` in the kernel):
      - the request-size denominator ``read_frac * rs + ((1 - read_frac)
        * 2 * lf) * rs`` fuses its first product: fma(read_frac, rs,
        rounded second product);
      - the outage key count ``okeys + w_rate * (1 - okeys / n_keys)``
        is fma(w_rate, 1 - okeys / n_keys, okeys);
      - the end of the baseline pause ``FAIL_T + base_down`` is
        fma(min(ps / bw, 300), 1000, FAIL_T);
  * ``fg_bw``'s ``+ 0.0 * backfilling`` adds +0 to a positive number and
    is left out.
Every other operation is one float32 multiply, add, subtract or divide
in the reference's order.  The sums over cohorts (``total``, the latency
histogram's per-tick add and the per-tick completions) add integer
counts of at most MAX_ARR each, below 2^24 in all, so they are exact in
any order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..device import resolve_device
from . import threefry

TICKS_PER_S = 1000
FAIL_T = 2 * TICKS_PER_S
RECOVER_T = 302 * TICKS_PER_S
AGES = 512          # max tracked sojourn (ms); completions clamp here
MAX_ARR = 64        # max arrivals per tick (33/tick at bw=50MB/s, rs=1KB)

#: float32(1 / TICKS_PER_S): XLA's rewrite of the division by TICKS_PER_S
_PER_TICK = 0.001
#: ticks of draws made at once by the plain version
_DRAW_CHUNK = 1024


@dataclass(frozen=True)
class MicroConfig:
    rs: float          # record size, bytes
    ps: float          # partition size, bytes
    bw: float          # bandwidth budget, bytes/s
    u: float           # offered load fraction
    lf: float          # log-bytes fraction (write transfer = lf*rs per leg)
    read_frac: float = 0.8

    @property
    def avg_req_bytes(self) -> float:
        return self.read_frac * self.rs + (1 - self.read_frac) * 2 * self.lf * self.rs

    @property
    def arrival_rate(self) -> float:  # ops per second
        return self.u * self.bw / self.avg_req_bytes


def fma_f32(a, b, c):
    """float32 a * b + c rounded once, as a fused multiply-add (torch has
    no float32 fma).  a * b is exact in float64 (two 24-bit significands);
    the float64 sum is rounded to odd, by TwoSum's exact error, and then
    to nearest float32, which is the correctly rounded result since 53 >=
    24 + 2 (Boldo and Melquiond's rounding to odd)."""
    a, b, c = (x.to(torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def row_constants(rs, ps, bw, u, lf, read_frac):
    """The per-row float32 constants of the tick loop from (R,) float32
    configs, in XLA's arithmetic (module docstring):
    {rate_pt, wbytes, n_keys, w_rate, bf_rate, fg_bw, base_down,
    base_end}; base_end = FAIL_T + base_down, the first tick the baseline
    serves again."""
    f32 = torch.float32
    rs, ps, bw, u, lf, read_frac = (
        x.to(f32) for x in (rs, ps, bw, u, lf, read_frac))
    second = (((1.0 - read_frac) * 2.0) * lf) * rs
    q = (u * bw) / fma_f32(read_frac, rs, second)
    rate_pt = q * _PER_TICK
    lim = torch.minimum(ps / bw, torch.full_like(ps, 300.0))
    return {
        "rate_pt": rate_pt,
        "wbytes": (lf * 2.0) * rs,
        "n_keys": torch.clamp_min(ps / rs, 1.0),
        "w_rate": rate_pt * (1.0 - read_frac),
        "bf_rate": ((bw * 0.2) / rs) * _PER_TICK,
        "fg_bw": bw * _PER_TICK,
        "base_down": lim * float(TICKS_PER_S),
        "base_end": fma_f32(lim, torch.full_like(lim, float(TICKS_PER_S)),
                            torch.full_like(lim, float(FAIL_T))),
    }


def arrivals_plain(rate_pt, read_frac, ticks: int, seed: int, *,
                   draw_rows: int | None = None):
    """The arrivals of every tick before the queue sees them: (n_read,
    n_write), each (R, ticks) int32.  Per row the rate accumulator (acc
    += rate_pt, n_arr = floor(acc), acc -= n_arr, in float32); per tick
    the key chain's sub-key and the reference's uniform(sub, (draw_rows,
    MAX_ARR)), row r taking row r mod draw_rows (default R: one table);
    lane i arrives when i < n_arr, as a read when its draw < read_frac.
    The baseline's pause is applied later, in the queue."""
    dev = rate_pt.device
    f32 = torch.float32
    R = rate_pt.shape[0]
    draw_rows = draw_rows or R
    rate_pt, read_frac = rate_pt.to(f32), read_frac.to(f32)
    lane = torch.arange(MAX_ARR, dtype=f32, device=dev)
    n_read = torch.empty((R, ticks), dtype=torch.int32, device=dev)
    n_write = torch.empty((R, ticks), dtype=torch.int32, device=dev)
    acc = torch.zeros(R, dtype=f32, device=dev)
    key = threefry.prng_key(seed)
    for t0 in range(0, ticks, _DRAW_CHUNK):
        n = min(_DRAW_CHUNK, ticks - t0)
        key, subs = threefry.split_chain(key, n)
        draws = threefry.uniform(subs, (draw_rows, MAX_ARR), device=dev)
        is_read = draws.repeat(1, R // draw_rows, 1) < read_frac[None, :,
                                                                 None]
        n_arr = torch.empty((n, R), dtype=f32, device=dev)
        for i in range(n):
            acc = acc + rate_pt
            n_arr[i] = torch.floor(acc)
            acc = acc - n_arr[i]
        arr = lane < n_arr[..., None]
        n_read[:, t0:t0 + n] = (arr & is_read).sum(dim=2).T
        n_write[:, t0:t0 + n] = (arr & ~is_read).sum(dim=2).T
    return n_read, n_write


def _simulate_batch_plain(rs, ps, bw, u, lf, read_frac, is_lark: bool,
                          ticks: int, seed: int, *, draw_rows=None,
                          check_counts=None):
    """The reference's ``_simulate_batch`` tick by tick in plain PyTorch,
    on the device of `rs`, fed by ``arrivals_plain`` (`draw_rows` as
    there).  All configs are (R,) float32 tensors.  Returns {hist (R,
    AGES), per_tick_done (R, ticks), pending_ts (R, ticks),
    base_down_ticks (R,)}, float32.

    `check_counts`, when a list, gets one entry per tick: whether every
    cohort count, the total and the completions were integers within the
    bounds that make their sums exact in float32 (the kernel's
    reductions rely on it)."""
    _simulate_batch_plain.calls += 1
    dev = rs.device
    f32 = torch.float32
    R = rs.shape[0]
    k = row_constants(rs, ps, bw, u, lf, read_frac)
    n_keys, w_rate = k["n_keys"], k["w_rate"]
    rem = torch.zeros((R, AGES, 2), dtype=f32, device=dev)
    cnt = torch.zeros((R, AGES, 2), dtype=f32, device=dev)
    pending = torch.zeros(R, dtype=f32, device=dev)
    okeys = torch.zeros(R, dtype=f32, device=dev)
    hist = torch.zeros((R, AGES), dtype=f32, device=dev)
    per_tick = torch.empty((R, ticks), dtype=f32, device=dev)
    pending_ts = torch.empty((R, ticks), dtype=f32, device=dev)
    age_ok = (torch.arange(AGES, device=dev) >= 1)[None, :, None]
    new_rem = torch.stack([rs.to(f32), k["wbytes"]], dim=1)
    reads, writes = (a.to(f32) for a in arrivals_plain(
        k["rate_pt"], read_frac, ticks, seed, draw_rows=draw_rows))
    for t in range(ticks):
        in_outage = FAIL_T <= t < RECOVER_T
        backfilling = is_lark and t >= RECOVER_T
        base_paused = (not is_lark and t >= FAIL_T) & (t < k["base_end"])

        # ---- arrivals (rejected while the baseline pauses) ----------------
        n_read = torch.where(base_paused, 0.0, reads[:, t])
        n_write = torch.where(base_paused, 0.0, writes[:, t])

        # age-advance: the oldest cohort (age AGES-1) drops out
        rem = torch.roll(rem, 1, dims=1)
        cnt = torch.roll(cnt, 1, dims=1)
        rem[:, 0] = new_rem
        cnt[:, 0, 0] = n_read
        cnt[:, 0, 1] = n_write

        # ---- outage / backfill key dynamics (fluid) --------------------
        if is_lark:
            if in_outage:
                okeys = fma_f32(w_rate, 1.0 - okeys / n_keys, okeys)
            bf = backfilling & (pending > 0.5)
            if t == RECOVER_T:
                pending = okeys
            pending = torch.where(
                bf, torch.clamp_min(pending - k["bf_rate"]
                                    - (w_rate * pending) / n_keys, 0.0),
                pending)

        # ---- processor sharing -------------------------------------------
        total = torch.clamp_min(cnt.sum(dim=(1, 2)), 1.0)
        share = k["fg_bw"] / total
        busy = cnt > 0
        rem = torch.where(busy, rem - share[:, None, None], rem)

        # ---- completions (rem <= 0 and age >= 1 tick RTT) ----------------
        comp = busy & (rem <= 0.0) & age_ok
        comp_cnt = torch.where(comp, cnt, 0.0)
        hist = hist + comp_cnt.sum(dim=2)
        cnt = torch.where(comp, 0.0, cnt)
        per_tick[:, t] = comp_cnt.sum(dim=(1, 2))
        pending_ts[:, t] = pending
        if check_counts is not None:
            check_counts.append(_counts_exact(cnt, total, per_tick[:, t]))
    return {"hist": hist, "per_tick_done": per_tick,
            "pending_ts": pending_ts, "base_down_ticks": k["base_down"]}


#: calls of the plain tick loop since the last reset, on any device (a run
#: on the card that must go through the kernel reads 0 here)
_simulate_batch_plain.calls = 0


def _counts_exact(cnt, total, done) -> bool:
    """Every cohort count an integer in [0, MAX_ARR]; the total and the
    completions integers at most AGES * 2 * MAX_ARR < 2^24."""
    cap = AGES * 2 * MAX_ARR
    return bool(((cnt == torch.floor(cnt)) & (cnt >= 0)
                 & (cnt <= MAX_ARR)).all()
                and (total == torch.floor(total)).all()
                and (total <= cap).all()
                and (done == torch.floor(done)).all()
                and (done <= cap).all())


def _config_tensors(configs, device):
    return [torch.tensor([getattr(c, f) for c in configs],
                         dtype=torch.float32, device=device)
            for f in ("rs", "ps", "bw", "u", "lf", "read_frac")]


def run_table(configs: List[MicroConfig], *, ticks: int = 1_000_000,
              seed: int = 0, device=None) -> List[Dict]:
    """The reference's ``run_table``: one row per config, summarised on
    the host in float64.  ``device=None`` means ``cuda``: one launch of
    the kernel runs both modes; the CPU runs the plain version."""
    return run_tables({"table": configs}, ticks=ticks, seed=seed,
                      device=device)["table"]


def run_tables(tables: Dict[str, List[MicroConfig]], *,
               ticks: int = 1_000_000, seed: int = 0,
               device=None) -> Dict[str, List[Dict]]:
    """``run_table`` of each table, {name: rows}, in one call of
    ``microsim_scan`` over the tables' grids concatenated (each table of
    the same length draws its arrivals alone, as the reference's
    ``run_table`` does)."""
    # the kernel's module imports this one
    from ..kernels.microsim_scan import microsim_scan
    grids = list(tables.values())
    rows = len(grids[0])
    if any(len(g) != rows for g in grids):
        raise ValueError("run_tables takes tables of one length")
    dev = resolve_device(device)
    out = microsim_scan(*_config_tensors([c for g in grids for c in g], dev),
                        ticks=ticks, seed=seed, rows_per_table=rows)
    lark, base = ({k: v.cpu().numpy() for k, v in out[m].items()}
                  for m in ("lark", "base"))
    return {name: [_summary(cfg, lark, base, i * rows + j, ticks)
                   for j, cfg in enumerate(grid)]
            for i, (name, grid) in enumerate(tables.items())}


def _summary(cfg: MicroConfig, lark, base, i: int, ticks: int) -> Dict:
    """The reference's ``run_table`` row of config row `i` of the
    outputs."""
    pend = lark["pending_ts"][i]
    after = np.where(pend[RECOVER_T + 1:] < 0.5)[0]  # backfilling gate
    backfill_end = RECOVER_T + 1 + (after[0] if len(after) else
                                    len(pend) - RECOVER_T - 1)
    W = min(int(backfill_end), ticks)

    def summary(r):
        done_w = float(r["per_tick_done"][i, :W].sum())
        h = r["hist"][i].astype(np.float64)
        tot = h.sum()
        avg = (h * np.arange(len(h))).sum() / max(tot, 1)
        cum = np.cumsum(h) / max(tot, 1)
        p99 = int(np.searchsorted(cum, 0.99))
        return dict(throughput=done_w / (W / TICKS_PER_S), avg_ms=avg,
                    p99_ms=p99, completed=done_w)

    ls, bs = summary(lark), summary(base)
    return {
        "config": cfg, "window_s": W / TICKS_PER_S,
        "lark": ls, "base": bs,
        "throughput_ratio": ls["throughput"] / max(bs["throughput"], 1e-9),
        "lark_backfill_s": (backfill_end - RECOVER_T) / TICKS_PER_S,
        "base_down_s": float(base["base_down_ticks"][i]) / TICKS_PER_S,
        "lark_ts": lark["per_tick_done"][i],
        "base_ts": base["per_tick_done"][i],
    }


# Paper Tables 3-4 grid: decimal values from §5.2.1 (displayed in the tables
# as binary-prefix: 0.9 GB ≙ 1 GB, 9.3 GB ≙ 10 GB, 48 MB/s ≙ 50 MB/s).
TABLE_GRID = [
    dict(rs=1e3, ps=0.1e9, bw=5e6), dict(rs=1e3, ps=0.1e9, bw=50e6),
    dict(rs=1e3, ps=1e9, bw=5e6), dict(rs=1e3, ps=1e9, bw=50e6),
    dict(rs=1e3, ps=10e9, bw=5e6), dict(rs=1e3, ps=10e9, bw=50e6),
    dict(rs=10e3, ps=0.1e9, bw=5e6), dict(rs=10e3, ps=0.1e9, bw=50e6),
    dict(rs=10e3, ps=1e9, bw=5e6), dict(rs=10e3, ps=1e9, bw=50e6),
    dict(rs=10e3, ps=10e9, bw=5e6), dict(rs=10e3, ps=10e9, bw=50e6),
]


#: (u, lf) of paper Tables 3 and 4 (benchmarks/microsim_tables.py)
TABLES = {"t3": (0.5, 0.5), "t4": (0.8, 1.0)}


def table_configs(u: float, lf: float) -> List[MicroConfig]:
    return [MicroConfig(u=u, lf=lf, **g) for g in TABLE_GRID]
