"""The §5.2 micro-simulator's tick loop on the card: the CUDA kernel
``microsim_scan`` (csrc/microsim_scan.cu) beside its plain PyTorch
version ``core/microsim.py: _simulate_batch_plain``.

``microsim_scan`` replaces ``repro/core/microsim.py: _simulate_batch``, a
``lax.scan`` over 1 ms ticks with no Pallas body.  One launch runs both
modes of every config row given (both tables at once when their grids
are concatenated, ``rows_per_table`` keeping each table's own Threefry
counters): one block computes the key chain once, and per row a block
whose two arrival warps count each tick's reads and writes ahead of its
two queue warps (LARK, baseline), one warp per simulation, while a fifth
warp runs LARK's fluid key counts, which depend on the tick alone.  It
is bound by latency, not by bytes: the key chain is one Threefry hash
deep a tick and each queue two warp reductions and a divide, while the
bytes it must move (the per-tick outputs) take microseconds at the HBM
rate.

Dispatch follows the tensor: CUDA config tensors launch the kernel (or
raise), CPU tensors run the plain version.  There is no fallback.
``FAIL_T`` and ``RECOVER_T`` are read from ``core/microsim.py`` at each
call, so a check can shorten them.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from . import _build
from ..core import microsim, threefry

MODES = ("lark", "base")
#: the faults the card-side check plants in copies of microsim_scan.cu:
#: (text, replacement), each text found once in the source
FAULTS = {
    # the outage key count rounded twice instead of one fused multiply-add
    "okeys_unfused": (
        "okeys = __fmaf_rn(w_rate, __fsub_rn(1.f, __fdiv_rn(okeys, n_keys)),"
        " okeys);",
        "okeys = __fadd_rn(okeys, __fmul_rn(w_rate, __fsub_rn(1.f, "
        "__fdiv_rn(okeys, n_keys))));"),
    # completions allowed in the tick of arrival (no 1-tick RTT)
    "rtt_dropped": ("const bool rtt = age >= 1;", "const bool rtt = true;"),
    # the arrivals drawn under the key chain's sub-key one tick late
    "key_chain_late": ("const uint2 sub = load_sub(subs, t);",
                       "const uint2 sub = load_sub(subs, t > 0 ? t - 1 : 0);"),
    # one lane's partial left out of the warp sum of the cohort counts
    "lane_partial_dropped": (
        "static_cast<float>(__reduce_add_sync(0xffffffffu, mine)), 1.f);",
        "static_cast<float>(__reduce_add_sync(0xffffffffu, "
        "lane == 31 ? 0 : mine)), 1.f);"),
}

#: the card-side check's cases: (name, ticks, FAIL_T, RECOVER_T, ps
#: scale).  The paper's constants over 2,600 ticks cover the arrivals, the
#: failure at 2 s and the baseline's pause; the short outage (failure at
#: 0.2 s, return at 1.2 s, partitions 1,000 times smaller) also covers the
#: backfill, which then ends inside the run on every row.
CASES = (("paper_constants", 2600, 2000, 302000, 1.0),
         ("short_outage", 4000, 200, 1200, 1e-3))


def case_configs(table: str, ps_scale: float, device):
    """The six (R,) float32 config tensors of a table's grid, partition
    sizes scaled by `ps_scale`."""
    u, lf = microsim.TABLES[table]
    return microsim._config_tensors(
        [microsim.MicroConfig(rs=c.rs, ps=c.ps * ps_scale, bw=c.bw, u=u,
                              lf=lf) for c in microsim.table_configs(u, lf)],
        device)


@contextlib.contextmanager
def outage(fail_t: int, recover_t: int):
    """Run the tick loops with the failure at `fail_t` and the return at
    `recover_t` (``core/microsim.py``'s FAIL_T and RECOVER_T)."""
    saved = microsim.FAIL_T, microsim.RECOVER_T
    microsim.FAIL_T, microsim.RECOVER_T = fail_t, recover_t
    try:
        yield
    finally:
        microsim.FAIL_T, microsim.RECOVER_T = saved


_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 5 + \
    (ctypes.c_uint32,) * 2 + (ctypes.c_void_p,) * 6 + (ctypes.c_void_p,)
#: csrc/microsim_scan.cu: threefry_chain_cycles (key words, n, cycles,
#: last key, stream)
CHAIN_ARGTYPES = (ctypes.c_uint32,) * 2 + (ctypes.c_int,) + \
    (ctypes.c_void_p,) * 3


def _check(configs, rows_per_table=None):
    shape, dev = configs[0].shape, configs[0].device
    for c in configs:
        if c.dim() != 1 or c.shape != shape or c.device != dev:
            raise ValueError("microsim_scan takes six (R,) config tensors "
                             "on one device")
        if c.dtype != torch.float32:
            raise TypeError(f"microsim_scan takes float32 configs; got "
                            f"{c.dtype}")
    if shape[0] < 1:
        raise ValueError("microsim_scan needs at least one config row")
    if rows_per_table is not None and (
            rows_per_table < 1 or shape[0] % rows_per_table):
        raise ValueError(f"rows_per_table {rows_per_table} must divide "
                         f"the {shape[0]} rows")


def microsim_scan(rs, ps, bw, u, lf, read_frac, *, ticks: int,
                  seed: int = 0, rows_per_table: int | None = None) -> dict:
    """Both modes of the tick loop: {"lark": outputs, "base": outputs},
    each {hist (R, AGES), per_tick_done (R, ticks), pending_ts (R,
    ticks), base_down_ticks (R,)} float32, as the reference's
    ``_sim_jit``.  `rows_per_table` (default R) divides R: row r draws
    its arrivals as row r mod rows_per_table of one table (the reference
    draws each table's (rows, 64) uniforms alone).  CUDA tensors launch
    the kernel once (``microsim_scan.launches`` counts the calls); CPU
    tensors run ``_simulate_batch_plain`` once per mode."""
    configs = (rs, ps, bw, u, lf, read_frac)
    _check(configs, rows_per_table)
    if rs.device.type == "cpu":
        return {mode: microsim._simulate_batch_plain(
                    *configs, mode == "lark", ticks, seed,
                    draw_rows=rows_per_table)
                for mode in MODES}
    if rs.device.type != "cuda":
        raise ValueError(f"microsim_scan runs on cuda or cpu, not "
                         f"{rs.device}")
    launch = _build.function("microsim_scan", "microsim_scan_launch",
                             _ARGTYPES)
    out, args, _ = launch_args(*configs, ticks=ticks, seed=seed,
                               rows_per_table=rows_per_table)
    _build.check(launch(*args, torch.cuda.current_stream(rs.device)
                        .cuda_stream), "microsim_scan")
    microsim_scan.launches += 1
    return out


def launch_args(rs, ps, bw, u, lf, read_frac, *, ticks: int, seed: int = 0,
                rows_per_table: int | None = None):
    """One launch of csrc/microsim_scan.cu's C interface on checked CUDA
    tensors: returns (out, args, keep), where ``launch(*args, stream)``
    fills `out` (as ``microsim_scan`` returns it) and `keep` holds the
    tensors behind `args` alive."""
    R = rs.shape[0]
    if ticks < 1 or 2 * R * ticks >= 2 ** 31 or R * microsim.MAX_ARR >= \
            2 ** 31:
        raise ValueError(f"microsim_scan: need ticks >= 1 and 2 * R * "
                         f"ticks < 2^31; got R={R}, ticks={ticks}")
    dev = rs.device
    configs = [c.contiguous() for c in (rs, ps, bw, u, lf, read_frac)]
    hist = torch.empty((2, R, microsim.AGES), dtype=torch.float32,
                       device=dev)
    done = torch.empty((2, R, ticks), dtype=torch.float32, device=dev)
    pend = torch.empty((2, R, ticks), dtype=torch.float32, device=dev)
    down = torch.empty((2, R), dtype=torch.float32, device=dev)
    # the key chain's sub-keys (two words a tick) and its progress counter
    subs = torch.empty((ticks, 2), dtype=torch.int32, device=dev)
    progress = torch.empty(1, dtype=torch.int32, device=dev)
    k1, k2 = threefry.prng_key(seed)
    args = (*(c.data_ptr() for c in configs), R, rows_per_table or R,
            ticks, microsim.FAIL_T, microsim.RECOVER_T, k1, k2,
            subs.data_ptr(), progress.data_ptr(), hist.data_ptr(),
            done.data_ptr(), pend.data_ptr(), down.data_ptr())
    out = {mode: {"hist": hist[m], "per_tick_done": done[m],
                  "pending_ts": pend[m], "base_down_ticks": down[m]}
           for m, mode in enumerate(MODES)}
    return out, args, (configs, subs, progress)


def chain_ns_per_hash(device, n: int = 100_000) -> dict:
    """One thread's n dependent key-chain hashes on the card (csrc/
    microsim_scan.cu: threefry_chain_cycles): {"cycles_per_hash",
    "ns_per_hash" (by CUDA events, the launch included), "key_equal"
    (the chain's end key against ``threefry.split_chain``'s)}."""
    fn = _build.function("microsim_scan", "threefry_chain_cycles",
                         CHAIN_ARGTYPES)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    last = torch.zeros(2, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    k1, k2 = threefry.prng_key(0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _build.check(fn(k1, k2, n, cycles.data_ptr(), last.data_ptr(),
                    stream.cuda_stream), "threefry_chain_cycles")
    end.record()
    torch.cuda.synchronize()
    key, _ = threefry.split_chain((k1, k2), n)
    got = tuple(int(w) & threefry.MASK for w in last.tolist())
    return {"cycles_per_hash": cycles.item() / n,
            "ns_per_hash": start.elapsed_time(end) * 1e6 / n,
            "key_equal": got == tuple(key)}


def work(R: int, ticks: int) -> tuple:
    """(bytes, float operations, integer operations) one launch must
    spend on R rows for `ticks` ticks, both modes.  Bytes: the six
    configs read once, per_tick_done and pending_ts written per tick, hist
    and base_down once.  Per (mode, row, tick): per cohort (AGES x 2) the
    share's subtract, the completion test and the two sums it enters, in
    float32.  Per (row, tick), shared by the two modes: per draw
    (MAX_ARR) one Threefry hash of 20 rounds (add, rotate, xor) and 5 key
    injections (2 adds each), in 32-bit integers; and per tick the key
    chain's two hashes, once."""
    cohorts = microsim.AGES * 2
    hash_ops = 20 * 3 + 5 * 2 * 2
    steps = 2 * R * ticks
    nbytes = 4 * (6 * R + 2 * 2 * R * ticks + 2 * R * microsim.AGES + 2 * R)
    return (nbytes, steps * 4 * cohorts,
            (R * microsim.MAX_ARR + 2) * ticks * hash_ops)


#: kernel launches since the last reset
microsim_scan.launches = 0
