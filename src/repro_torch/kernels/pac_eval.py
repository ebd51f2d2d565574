"""Per-row evaluation on boolean rank-space tiles: the CUDA kernels
``pac_eval``, ``downtime_eval`` (plain and roster, each with or without
the in-flight node counts) and ``node_count``, six launchers of
csrc/downtime_eval.cu, each beside its plain PyTorch version.

* ``pac_eval`` replaces ``repro/kernels/pac_eval.py:pac_eval`` (Pallas
  body ``_pac_kernel``): §5.1 PAC.  Bound by bytes: 2·R·n_pad read,
  R·n_pad + 2R written (about 15.3 MB per call at the paper tile
  R = 8·4096, n = 155).
* ``downtime_eval`` replaces ``repro/kernels/pac_eval.py:downtime_eval``
  (bodies ``_downtime_kernel`` and, with a roster,
  ``_downtime_roster_kernel``): the §6 per-step evaluation.  Bound by
  bytes: 2·R·n_pad read, R·n_pad + 11·R written, + 4·R·rf roster bytes
  read (about 15.6 MB, 15.9 MB with a rf = 2 roster).  Given the
  engine's recruit ids and active flags it also returns the in-flight
  counts from the same launch (+ 5·R + 4·B·n_real bytes: 15.8 MB,
  16.0 MB with the roster), the unpacked §6 bandwidth step's one eval.
* ``node_count`` replaces ``repro/kernels/pac_eval.py:node_count`` (body
  ``_node_count_kernel``): in-flight catch-ups per (trial, node), the
  counts mode alone.  5·B·P bytes read, 4·B·n_real written (about
  0.17 MB): bound by launch latency, not by bytes.
* ``latency_charge`` (csrc/latency_charge.cu) replaces
  ``repro/kernels/pac_eval.py:latency_charge`` (body ``_latency_kernel``)
  and the ``decay_from_dt`` chain before it: one interval of the §6
  client-latency layer, one thread per (trial, partition) row, float32
  math held bitwise.  Bound by bytes: 4,735,024 bytes per call at the
  timed shape (B = 8, P = 4096, NB = 4, nbins = 16, 9 of the 22 tables).

``pac_eval`` and ``downtime_eval`` are one kernel body, templated on
what it evaluates and on the counts: it stages tiles of whole rows in
shared memory in 16-byte pieces and walks each row in 4-byte words, four
lanes to a row; a warp's rows add their counts with ``__match_any_sync``
and one atomicAdd per (trial, node).
``latency_charge`` issues every table load of a row before its decay
chain and writes its histogram rows as 16-byte stores.  Every byte is
read or written once; see the sources.

``pac_eval`` and ``downtime_eval`` take ``block_p``, the rows T of the
kernel's tile (None: the kernel's own plan, ``default_row_tile``).  A
named T must be one of ``row_tiles``: a power of two from 16 to 128 that
divides R and whose three row buffers and roster slice fit the 100 KiB
of shared memory a block gets, or 16 alone where a row needs column
passes.  The tile is throughput only: every valid T gives the same bits.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version, which has no tile and
ignores one.  An invalid tile on a CUDA tensor raises ``ValueError``
before any launch.  There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .latency import latency_step_ref

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)

# csrc/downtime_eval.cu's tile constants: threads a row, the rows of the
# plan's largest tile, of the largest a caller may name and of the
# smallest, the blocks the plan keeps in flight (one per SM), a block's
# dynamic shared memory, the largest staged roster slice, and the slack
# each buffer carries for 16-byte widening
_LANES, _MAX_ROWS, _TOP_ROWS, _MIN_ROWS = 4, 64, 128, 16
_MIN_BLOCKS, _BUDGET, _ROSTER_CAP, _SLOP = 132, 100 * 1024, 16 * 1024, 32


def _align16(x: int) -> int:
    return (x + 15) & ~15


def row_tile_bytes(T: int, n_pad: int, *, rf: int = 0,
                   roster: bool = False) -> int:
    """Shared memory of a one-pass tile of T rows: the up, full and creps
    buffers and, for the roster variant, the staged roster slice (read
    from global memory, 0 bytes here, when it would pass 16 KiB)."""
    ro = _align16(4 * T * rf + _SLOP) if roster else 0
    return 3 * _align16(T * n_pad + _SLOP) + (ro if ro <= _ROSTER_CAP else 0)


def default_row_tile(R: int, n_pad: int, *, rf: int = 0,
                     roster: bool = False) -> int:
    """The T that csrc/downtime_eval.cu's make_plan chooses: 64 rows,
    halved to 16 while the tile overflows the budget or the tiles leave
    some of the 132 SMs without one; 16 where rows go in column passes."""
    T = _MAX_ROWS
    while T > _MIN_ROWS and (
            row_tile_bytes(T, n_pad, rf=rf, roster=roster) > _BUDGET
            or (R + T - 1) // T < _MIN_BLOCKS):
        T //= 2
    return T


def row_tiles(R: int, n_pad: int, *, rf: int = 0,
              roster: bool = False) -> tuple:
    """Every T a caller may name for an (R, n_pad) tile: powers of two
    from 16 to 128 that divide R and fit the budget, or 16 alone (when it
    divides R) where even 16 rows overflow it (column passes).  A pure
    function of the shape; empty when no power of two from 16 divides R."""
    if row_tile_bytes(_MIN_ROWS, n_pad, rf=rf, roster=roster) > _BUDGET:
        return (_MIN_ROWS,) if R % _MIN_ROWS == 0 else ()
    return tuple(T for T in (16, 32, 64, _TOP_ROWS) if R % T == 0 and
                 row_tile_bytes(T, n_pad, rf=rf, roster=roster) <= _BUDGET)


def _row_tile(block_p, R: int, n_pad: int, *, rf: int, roster: bool) -> int:
    """The launcher's `tile` for `block_p` (None: 0, the plan's choice);
    raises ValueError, before any launch, on a T the kernel does not take."""
    if block_p is None:
        return 0
    T = int(block_p)
    valid = row_tiles(R, n_pad, rf=rf, roster=roster)
    if T not in valid:
        raise ValueError(f"block_p={block_p} is not a row tile of an "
                         f"({R}, {n_pad}) tile; valid: {valid}")
    return T


def pac_eval_plain(up, full, *, rf: int, voters: int, n_real: int):
    """(R, n_pad) bool tiles -> (lark (R,), maj (R,), creps (R, n_pad)) —
    the math of ``repro/kernels/pac_np.py: pac_eval_rank_np``.  Columns
    >= n_real are padding."""
    n_pad = up.shape[1]
    if n_pad > n_real:                            # mask padding columns
        valid = torch.arange(n_pad, device=up.device) < n_real
        up = up & valid
        full = full & valid
    n_up = up.sum(dim=1)
    majority = 2 * n_up > n_real
    roster_up = up[:, :rf].any(dim=1)
    full_up = (full & up).any(dim=1)
    lark = majority & roster_up & full_up
    maj = 2 * up[:, :voters].sum(dim=1) > voters
    creps = up & (torch.cumsum(up, dim=1) <= rf)
    return lark, maj, creps


def _check(up, full, *, rf: int, voters: int, n_real: int):
    if up.dtype != torch.bool or full.dtype != torch.bool:
        raise TypeError(f"pac_eval takes bool tiles; got {up.dtype}, "
                        f"{full.dtype}")
    if up.dim() != 2 or up.shape != full.shape:
        raise ValueError(f"pac_eval takes two (R, n_pad) tiles of one "
                         f"shape; got {tuple(up.shape)}, "
                         f"{tuple(full.shape)}")
    if up.device != full.device:
        raise ValueError(f"up on {up.device}, full on {full.device}")
    if not (up.is_contiguous() and full.is_contiguous()):
        raise ValueError("pac_eval takes contiguous tiles")
    if not 1 <= n_real <= up.shape[1]:
        raise ValueError(f"n_real={n_real} must be in [1, n_pad="
                         f"{up.shape[1]}]")
    if rf < 1 or voters < 1:
        raise ValueError(f"rf={rf} and voters={voters} must be >= 1")
    if up.numel() >= 2 ** 31:
        raise ValueError("pac_eval tiles must hold fewer than 2^31 lanes")


def pac_eval(up, full, *, rf: int, voters: int, n_real: int,
             block_p=None):
    """(R, n_pad) bool rank-space tiles -> (lark (R,), maj (R,),
    creps (R, n_pad)) bool.  CUDA tensors run the kernel, with `block_p`
    rows a tile (None: the kernel's plan); CPU tensors run
    ``pac_eval_plain``."""
    _check(up, full, rf=rf, voters=voters, n_real=n_real)
    if up.device.type == "cpu":
        return pac_eval_plain(up, full, rf=rf, voters=voters, n_real=n_real)
    if up.device.type != "cuda":
        raise ValueError(f"pac_eval runs on cuda or cpu, not {up.device}")
    R, n_pad = up.shape
    tile = _row_tile(block_p, R, n_pad, rf=rf, roster=False)
    lark = torch.empty(R, dtype=torch.bool, device=up.device)
    maj = torch.empty(R, dtype=torch.bool, device=up.device)
    creps = torch.empty((R, n_pad), dtype=torch.bool, device=up.device)
    launch = _build.function("downtime_eval", "pac_eval_launch", _ARGTYPES)
    err = launch(up.data_ptr(), full.data_ptr(), lark.data_ptr(),
                 maj.data_ptr(), creps.data_ptr(), R, n_pad, n_real, rf,
                 voters, tile,
                 torch.cuda.current_stream(up.device).cuda_stream)
    _build.check(err, "pac_eval")
    pac_eval.launches += 1
    return lark, maj, creps


#: kernel launches since the last reset (a plain count, set to 0 by the
#: caller before a run it wants to attribute)
pac_eval.launches = 0


# ---------------------------------------------------------------------------
# downtime_eval: the §6 per-row evaluation (plain and roster variants)
# ---------------------------------------------------------------------------

_DT_ARGTYPES = (ctypes.c_void_p,) * 11 + (ctypes.c_int,) * 5 + \
    (ctypes.c_void_p,)
#: the counts launchers: + recruit, active, cnt and B, P
_DTC_ARGTYPES = (ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 7 + \
    (ctypes.c_void_p,)


def downtime_eval_plain(up, full, *, rf: int, n_real: int, roster=None,
                        want_repmask: bool = False,
                        want_rleader: bool = False):
    """(R, n_pad) bool tiles -> (lark, qmaj, leader, leader_full, nrep,
    *extras, creps) — the math of ``repro/kernels/pac_np.py:
    downtime_eval_rank_np``.

    lark (R,) bool is PAC; qmaj (R,) bool is a majority of the replica
    set up and nrep (R,) int32 its up count — the first rf lanes, or the
    ranks of ``roster`` (R, rf) when given, where a rank outside
    [0, n_real) reads as down (as the Pallas kernel's one-hot compare
    over valid lanes); leader (R,) int32 is the lowest up rank (n_real
    when none) and leader_full (R,) bool whether it holds the latest
    copy; creps (R, n_pad) bool the first rf up lanes.  Extras, between
    nrep and creps: repmask (R,) int32, bit j = lane j < rf up; rleader
    (R,) int32, the lowest up roster rank (n_real when none)."""
    if want_rleader and roster is None:
        raise ValueError("rleader needs a roster (it elects among "
                         "roster members)")
    lark, _, creps = pac_eval_plain(up, full, rf=rf, voters=rf,
                                    n_real=n_real)
    R, n_pad = up.shape
    lanes = torch.arange(n_pad, dtype=torch.int32, device=up.device)
    if n_pad > n_real:
        up = up & (lanes < n_real)
        full = full & (lanes < n_real)
    rup = None
    if roster is None:
        nrep = up[:, :rf].sum(dim=1).to(torch.int32)
    else:
        idx = roster.clamp(0, n_pad - 1).to(torch.int64)
        rup = torch.gather(up, 1, idx) & (roster >= 0) & (roster < n_real)
        nrep = rup.sum(dim=1).to(torch.int32)
    qmaj = 2 * nrep > rf
    leader = torch.where(up, lanes[None, :], n_pad).amin(dim=1)
    leader = leader.clamp(max=n_real)
    leader_full = ((full & up) & (lanes[None, :] == leader[:, None])) \
        .any(dim=1)
    extras = ()
    if want_repmask:
        first = up[:, :rf]                      # rf may exceed n_pad
        bits = torch.tensor([1 << j for j in range(first.shape[1])],
                            dtype=torch.int32, device=up.device)
        extras = extras + ((first.to(torch.int32) * bits[None, :])
                           .sum(dim=1, dtype=torch.int32),)
    if want_rleader:
        extras = extras + (torch.where(rup, roster.to(torch.int32), n_real)
                           .amin(dim=1),)
    return (lark, qmaj, leader, leader_full, nrep) + extras + (creps,)


def downtime_eval(up, full, *, rf: int, n_real: int, roster=None,
                  want_repmask: bool = False, want_rleader: bool = False,
                  recruit=None, active=None, block_p=None):
    """(R, n_pad) bool rank-space tiles [+ roster (R, rf) int32] ->
    (lark, qmaj, leader, leader_full, nrep, *extras, creps[, counts]);
    see ``downtime_eval_plain``.  With recruit (B, P) int32 and active
    (B, P) bool, R = B·P, the per-(trial, node) in-flight counts (B,
    n_real) int32 of ``node_count_plain`` come last.  CUDA tensors make
    one launch (``downtime_eval.launches`` counts the plain variant,
    ``roster_launches`` the roster one, ``counts_launches`` and
    ``roster_counts_launches`` the same with the counts), with `block_p`
    rows a tile (None: the kernel's plan); CPU tensors run the plain
    versions."""
    _check(up, full, rf=rf, voters=rf, n_real=n_real)
    if want_rleader and roster is None:
        raise ValueError("rleader needs a roster (it elects among "
                         "roster members)")
    if want_repmask and rf > 30:
        raise ValueError(f"repmask needs rf <= 30 (a non-negative int32 "
                         f"bitmask); got rf={rf}")
    R = up.shape[0]
    if roster is not None:
        if roster.dtype != torch.int32 or roster.shape != (R, rf):
            raise ValueError(f"roster must be ({R}, {rf}) int32; got "
                             f"{tuple(roster.shape)} {roster.dtype}")
        if roster.device != up.device or not roster.is_contiguous():
            raise ValueError("roster must be contiguous, on the tiles' "
                             "device")
    counting = recruit is not None or active is not None
    if counting:
        if recruit is None or active is None:
            raise ValueError("recruit and active must be passed together")
        check_counts_args(recruit, active, n_real=n_real)
        if recruit.numel() != R or recruit.device != up.device:
            raise ValueError(f"recruit/active must be (B, P) with B·P = "
                             f"R = {R}, on the tiles' device; got "
                             f"{tuple(recruit.shape)} on {recruit.device}")
    if up.device.type == "cpu":
        outs = downtime_eval_plain(up, full, rf=rf, n_real=n_real,
                                   roster=roster, want_repmask=want_repmask,
                                   want_rleader=want_rleader)
        if counting:
            outs = outs + (node_count_plain(recruit, active,
                                            n_real=n_real),)
        return outs
    if up.device.type != "cuda":
        raise ValueError(f"downtime_eval runs on cuda or cpu, not "
                         f"{up.device}")
    dev = up.device
    n_pad = up.shape[1]
    tile = _row_tile(block_p, R, n_pad, rf=rf, roster=roster is not None)

    def rows(dtype):
        return torch.empty(R, dtype=dtype, device=dev)

    lark, qmaj, lfull = (rows(torch.bool) for _ in range(3))
    leader, nrep = rows(torch.int32), rows(torch.int32)
    repmask = rows(torch.int32) if want_repmask else None
    rleader = rows(torch.int32) if want_rleader else None
    creps = torch.empty((R, n_pad), dtype=torch.bool, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    ins = (up.data_ptr(), full.data_ptr(), ptr(roster))
    row_outs = (lark.data_ptr(), qmaj.data_ptr(), leader.data_ptr(),
                lfull.data_ptr(), nrep.data_ptr(), ptr(repmask),
                ptr(rleader), creps.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    symbol, counter = _LAUNCHERS[(roster is not None, counting)]
    if counting:
        B, P = recruit.shape
        counts = torch.empty((B, n_real), dtype=torch.int32, device=dev)
        launch = _build.function("downtime_eval", symbol, _DTC_ARGTYPES)
        err = launch(*ins, recruit.data_ptr(), active.data_ptr(), *row_outs,
                     counts.data_ptr(), R, n_pad, n_real, rf, B, P, tile,
                     stream)
    else:
        launch = _build.function("downtime_eval", symbol, _DT_ARGTYPES)
        err = launch(*ins, *row_outs, R, n_pad, n_real, rf, tile, stream)
    _build.check(err, "downtime_eval")
    setattr(downtime_eval, counter, getattr(downtime_eval, counter) + 1)
    extras = tuple(t for t in (repmask, rleader) if t is not None)
    outs = (lark, qmaj, leader, lfull, nrep) + extras + (creps,)
    return outs + (counts,) if counting else outs


#: (roster given, counts asked) -> (launcher symbol, launch counter)
_LAUNCHERS = {
    (False, False): ("downtime_eval_launch", "launches"),
    (True, False): ("downtime_roster_launch", "roster_launches"),
    (False, True): ("downtime_eval_counts_launch", "counts_launches"),
    (True, True): ("downtime_roster_counts_launch", "roster_counts_launches"),
}

#: kernel launches since the last reset, one count per launcher
downtime_eval.launches = 0
downtime_eval.roster_launches = 0
downtime_eval.counts_launches = 0
downtime_eval.roster_counts_launches = 0


# ---------------------------------------------------------------------------
# node_count: in-flight catch-ups per (trial, node)
# ---------------------------------------------------------------------------

_NC_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + \
    (ctypes.c_void_p,)


def node_count_plain(recruit, active, *, n_real: int):
    """recruit (B, P) int32 node ids, active (B, P) bool -> (B, n_real)
    int32 counts: cnt[b, node] = #{p : active[b, p] and recruit[b, p] ==
    node}.  Ids outside [0, n_real) count nowhere — the math of
    ``repro/kernels/pac_np.py: rebuild_node_counts_np``."""
    ok = active & (recruit >= 0) & (recruit < n_real)
    counts = torch.zeros((recruit.shape[0], n_real), dtype=torch.int32,
                         device=recruit.device)
    return counts.scatter_add_(
        1, recruit.clamp(0, n_real - 1).to(torch.int64), ok.to(torch.int32))


def check_counts_args(recruit, active, *, n_real: int):
    if recruit.dtype != torch.int32 or active.dtype != torch.bool:
        raise TypeError(f"node counts take int32 recruit ids and a bool "
                        f"active mask; got {recruit.dtype}, "
                        f"{active.dtype}")
    if recruit.dim() != 2 or recruit.shape != active.shape:
        raise ValueError(f"recruit/active must share a (B, P) shape; got "
                         f"{tuple(recruit.shape)} vs "
                         f"{tuple(active.shape)}")
    if recruit.device != active.device:
        raise ValueError(f"recruit on {recruit.device}, active on "
                         f"{active.device}")
    if not (recruit.is_contiguous() and active.is_contiguous()):
        raise ValueError("recruit and active must be contiguous")
    # a row's key b·n_real + node and the counts' index are int32, and so
    # is a row's index b·P + p
    if n_real < 1 or recruit.shape[0] * n_real >= 2 ** 31:
        raise ValueError(f"n_real={n_real} must be >= 1 with B·n_real < "
                         f"2^31 (B = {recruit.shape[0]})")
    if recruit.numel() >= 2 ** 31:
        raise ValueError("recruit must hold fewer than 2^31 rows")


def node_count(recruit, active, *, n_real: int):
    """recruit (B, P) int32, active (B, P) bool -> (B, n_real) int32
    per-node in-flight counts; see ``node_count_plain``.  CUDA tensors
    launch the counts kernel of csrc/downtime_eval.cu (which zeroes the
    counts first); CPU tensors run the plain version."""
    check_counts_args(recruit, active, n_real=n_real)
    if recruit.device.type == "cpu":
        return node_count_plain(recruit, active, n_real=n_real)
    if recruit.device.type != "cuda":
        raise ValueError(f"node_count runs on cuda or cpu, not "
                         f"{recruit.device}")
    B, P = recruit.shape
    counts = torch.empty((B, n_real), dtype=torch.int32,
                         device=recruit.device)
    launch = _build.function("downtime_eval", "node_count_launch",
                             _NC_ARGTYPES)
    err = launch(recruit.data_ptr(), active.data_ptr(), counts.data_ptr(),
                 B, P, n_real,
                 torch.cuda.current_stream(recruit.device).cuda_stream)
    _build.check(err, "node_count")
    node_count.launches += 1
    return counts


#: kernel launches since the last reset
node_count.launches = 0


# ---------------------------------------------------------------------------
# latency_charge: one interval of the §6 client-latency layer
# ---------------------------------------------------------------------------

_LC_ARGTYPES = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 6 + \
    (ctypes.c_void_p,)

#: most key-popularity buckets the kernel keeps in registers
_LC_MAX_BUCKETS = 8


#: the plain version: the decay chain and the dirty/quorum math in eager
#: PyTorch, the reference's ``latency_step_ref`` op for op
latency_charge_plain = latency_step_ref


def _check_latency_args(dirty, dt_i, avail, qok, rem, pow_tables, kf, lamw,
                        nbins: int):
    if dirty.dim() != 3:
        raise ValueError(f"dirty must be (B, P, NB); got "
                         f"{tuple(dirty.shape)}")
    B, P, NB = dirty.shape
    want = {"dirty": (dirty, torch.float32, (B, P, NB)),
            "dt_i": (dt_i, torch.int32, (B,)),
            "avail": (avail, torch.bool, (B, P)),
            "qok": (qok, torch.bool, (B, P)),
            "rem": (rem, torch.int32, (B, P)),
            "pow_tables": (pow_tables, torch.float32,
                           (pow_tables.shape[0], P, NB)),
            "kf": (kf, torch.float32, (NB,)),
            "lamw": (lamw, torch.float32, (P,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {dtype}; got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dirty.device:
            raise ValueError(f"{name} on {t.device}, dirty on "
                             f"{dirty.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= pow_tables.shape[0] <= 31:
        raise ValueError(f"pow_tables must hold 1..31 tables (one per bit "
                         f"of an int32 dt); got {pow_tables.shape[0]}")
    if not 2 <= nbins <= 30:
        raise ValueError(f"nbins={nbins} must be in [2, 30]")
    if not 1 <= NB <= _LC_MAX_BUCKETS:
        raise ValueError(f"NB={NB} must be in [1, {_LC_MAX_BUCKETS}]")


def latency_charge(dirty, dt_i, avail, qok, rem, *, pow_tables, kf, lamw,
                   nbins: int, slo_ticks: int):
    """One event interval of the client-latency layer.

    dirty (B, P, NB) float32 carried dirty-key fractions; dt_i (B,) int32
    interval lengths; avail, qok (B, P) bool (partition serving, replica
    majority up, at interval start); rem (B, P) int32 remaining rebuild
    wall-ticks; pow_tables (nbits, P, NB) float32 decay squares; kf (NB,)
    float32 keys per bucket; lamw (P,) float32 write rates.  Returns
    (new_dirty (B, P, NB), dup (B, P, NB), qhist (B, P, nbins),
    qslo (B, P), qsum (B, P)) float32.

    CUDA tensors make one ``latency_charge`` launch (decay chain
    included); CPU tensors run ``latency_charge_plain``.  Both give the
    same bits."""
    _check_latency_args(dirty, dt_i, avail, qok, rem, pow_tables, kf, lamw,
                        nbins)
    if dirty.device.type == "cpu":
        return latency_charge_plain(dirty, dt_i, avail, qok, rem,
                                    pow_tables=pow_tables, kf=kf, lamw=lamw,
                                    nbins=nbins, slo_ticks=slo_ticks)
    if dirty.device.type != "cuda":
        raise ValueError(f"latency_charge runs on cuda or cpu, not "
                         f"{dirty.device}")
    B, P, NB = dirty.shape
    dev = dirty.device
    new_dirty = torch.empty_like(dirty)
    dup = torch.empty_like(dirty)
    qhist = torch.empty((B, P, nbins), dtype=torch.float32, device=dev)
    qslo = torch.empty((B, P), dtype=torch.float32, device=dev)
    qsum = torch.empty((B, P), dtype=torch.float32, device=dev)
    launch = _build.function("latency_charge", "latency_charge_launch",
                             _LC_ARGTYPES)
    err = launch(dirty.data_ptr(), dt_i.data_ptr(), avail.data_ptr(),
                 qok.data_ptr(), rem.data_ptr(), pow_tables.data_ptr(),
                 kf.data_ptr(), lamw.data_ptr(), new_dirty.data_ptr(),
                 dup.data_ptr(), qhist.data_ptr(), qslo.data_ptr(),
                 qsum.data_ptr(), B, P, NB, pow_tables.shape[0], nbins,
                 slo_ticks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "latency_charge")
    latency_charge.launches += 1
    return new_dirty, dup, qhist, qslo, qsum


#: kernel launches since the last reset
latency_charge.launches = 0
