"""Per-step evaluation on bit-packed (B, W, P) word planes: the CUDA
kernels ``fused_pac_eval`` and ``fused_downtime_eval``, two launchers of
one kernel body (csrc/fused_downtime.cu, templated on the mode), each
beside its plain PyTorch version.

* ``fused_pac_eval`` replaces ``repro/kernels/fused_step.py:
  fused_pac_eval`` (Pallas body ``_fused_pac_kernel``): §5.1 PAC.
  Bound by bytes: 3·B·W·P·4 + 2·B·P per call (about 2.0 MB at the paper
  tile B = 8, W = 5, P = 4096).
* ``fused_downtime_eval`` replaces ``repro/kernels/fused_step.py:
  fused_downtime_eval`` (Pallas bodies ``_fused_downtime_kernel`` and
  ``_node_count_block``): the §6 evaluation, the roster select and the
  in-flight node counts in one launch.  Bound by bytes: 3·B·W·P·4 +
  11·B·P (about 2.33 MB), 2.76 MB with a rf = 2 roster and the counts.

The kernel gives one thread to each (trial, partition); word k of
neighbouring partitions is contiguous, so every load and store is
coalesced.  It holds a thread's words in registers for W <= 8, every
load issued before the arithmetic, and walks more in a loop.  Words are
carried as int32 (the reference's uint32 bit patterns).  Both wrappers
take ``block_t`` and ``block_p``, the block's trials and partitions
(both None: the default block, 128 partitions of one trial; one None:
1 trial or 128 partitions); a named pair must be one of
``fused_blocks``.  The block is throughput only: every valid pair gives
the same bits.  Dispatch follows the tensor: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version, which has no
block and ignores one.  An invalid block on a CUDA tensor raises
``ValueError`` before any launch.  There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, bitpack, pac_eval

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)

#: csrc/fused_downtime.cu's block bounds: the default block's threads
#: (128 partitions of one trial), the most threads a named block may
#: have, and block_p's and block_t's ranges (powers of two)
DEFAULT_BLOCK = (1, 128)
MAX_THREADS, MIN_BLOCK_P, MAX_BLOCK_P, MAX_BLOCK_T = 1024, 32, 1024, 16


def fused_blocks(B: int, P: int, *, max_threads: int = MAX_THREADS) -> tuple:
    """Every (block_t, block_p) a caller may name for a (B, P) grid:
    block_p a power of two from 32 to 1024 dividing P, block_t a power of
    two up to 16 dividing B, at most `max_threads` threads; in (block_t,
    block_p) order.  A pure function of the shape; empty when P has no
    power-of-two divisor from 32."""
    out = []
    bt = 1
    while bt <= min(B, MAX_BLOCK_T):
        if B % bt == 0:
            bp = MIN_BLOCK_P
            while bp <= min(P, MAX_BLOCK_P):
                if P % bp == 0 and bt * bp <= max_threads:
                    out.append((bt, bp))
                bp *= 2
        bt *= 2
    return tuple(out)


def _block(block_t, block_p, B: int, P: int) -> tuple:
    """The launchers' (block_t, block_p): (0, 0) when both are None, else
    the pair with a None taken from the default block; raises ValueError,
    before any launch, on a pair the kernel does not take."""
    if block_t is None and block_p is None:
        return 0, 0
    pair = (DEFAULT_BLOCK[0] if block_t is None else int(block_t),
            DEFAULT_BLOCK[1] if block_p is None else int(block_p))
    if pair not in fused_blocks(B, P):
        raise ValueError(f"(block_t, block_p)={pair} is not a block of a "
                         f"(B={B}, P={P}) grid: block_p a power of two in "
                         f"[{MIN_BLOCK_P}, {MAX_BLOCK_P}] dividing P, "
                         f"block_t a power of two <= {MAX_BLOCK_T} dividing "
                         f"B, block_t * block_p <= {MAX_THREADS}")
    return pair


def fused_pac_eval_plain(upw, fullw, *, rf: int, voters: int, n_real: int):
    """(B, W, P) int32 words -> (lark (B, P), maj (B, P), crepsw
    (B, W, P) int32) — ``bitpack.pac_eval_packed`` on the word planes."""
    W = upw.shape[1]
    lark, maj, creps = bitpack.pac_eval_packed(
        [upw[:, k, :] for k in range(W)], [fullw[:, k, :] for k in range(W)],
        rf=rf, voters=voters, n_real=n_real)
    return lark, maj, torch.stack(creps, dim=1)


def _check(upw, fullw, *, rf: int, voters: int, n_real: int):
    if upw.dtype != torch.int32 or fullw.dtype != torch.int32:
        raise TypeError(f"fused_pac_eval takes int32-carried words; got "
                        f"{upw.dtype}, {fullw.dtype}")
    if upw.dim() != 3 or upw.shape != fullw.shape:
        raise ValueError(f"fused_pac_eval takes two (B, W, P) word tensors "
                         f"of one shape; got {tuple(upw.shape)}, "
                         f"{tuple(fullw.shape)}")
    if upw.device != fullw.device:
        raise ValueError(f"upw on {upw.device}, fullw on {fullw.device}")
    if not (upw.is_contiguous() and fullw.is_contiguous()):
        raise ValueError("fused_pac_eval takes contiguous word tensors")
    if not 1 <= n_real <= 32 * upw.shape[1]:
        raise ValueError(f"n_real={n_real} must be in [1, 32 * W]")
    if rf < 1 or voters < 1:
        raise ValueError(f"rf={rf} and voters={voters} must be >= 1")
    if upw.numel() >= 2 ** 31:
        raise ValueError("fused_pac_eval state must hold fewer than 2^31 "
                         "words")


def fused_pac_eval(upw, fullw, *, rf: int, voters: int, n_real: int,
                   block_t=None, block_p=None):
    """(B, W, P) int32 words -> (lark (B, P) bool, maj (B, P) bool,
    crepsw (B, W, P) int32).  CUDA tensors run the kernel in blocks of
    (block_t, block_p); CPU tensors run ``fused_pac_eval_plain``."""
    _check(upw, fullw, rf=rf, voters=voters, n_real=n_real)
    if upw.device.type == "cpu":
        return fused_pac_eval_plain(upw, fullw, rf=rf, voters=voters,
                                    n_real=n_real)
    if upw.device.type != "cuda":
        raise ValueError(f"fused_pac_eval runs on cuda or cpu, not "
                         f"{upw.device}")
    B, W, P = upw.shape
    if B > 65535:
        raise ValueError(f"fused_pac_eval takes at most 65535 trials (the "
                         f"grid's y axis); got {B}")
    bt, bp = _block(block_t, block_p, B, P)
    lark = torch.empty((B, P), dtype=torch.bool, device=upw.device)
    maj = torch.empty((B, P), dtype=torch.bool, device=upw.device)
    crepsw = torch.empty((B, W, P), dtype=torch.int32, device=upw.device)
    launch = _build.function("fused_downtime", "fused_pac_eval_launch",
                             _ARGTYPES)
    err = launch(upw.data_ptr(), fullw.data_ptr(), lark.data_ptr(),
                 maj.data_ptr(), crepsw.data_ptr(), B, W, P, n_real, rf,
                 voters, bt, bp,
                 torch.cuda.current_stream(upw.device).cuda_stream)
    _build.check(err, "fused_pac_eval")
    fused_pac_eval.launches += 1
    return lark, maj, crepsw


#: kernel launches since the last reset (a plain count, set to 0 by the
#: caller before a run it wants to attribute)
fused_pac_eval.launches = 0


# ---------------------------------------------------------------------------
# fused_downtime_eval: §6 eval + roster + node counts on packed words
# ---------------------------------------------------------------------------

_FDT_ARGTYPES = (ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 7 + \
    (ctypes.c_void_p,)


def fused_downtime_eval_plain(upw, fullw, *, rf: int, n_real: int,
                              roster=None, recruit=None, active=None,
                              want_repmask: bool = False,
                              want_rleader: bool = False):
    """``bitpack.downtime_eval_packed`` on the word planes, plus
    ``pac_eval.node_count_plain`` when recruit/active are given.  Returns
    (lark, qmaj, leader, leader_full, nrep, *extras, crepsw (B, W, P)
    int32[, counts (B, n_real) int32])."""
    W = upw.shape[1]
    rost = None if roster is None else \
        [roster[..., j] for j in range(rf)]
    outs = bitpack.downtime_eval_packed(
        [upw[:, k, :] for k in range(W)], [fullw[:, k, :] for k in range(W)],
        rf=rf, n_real=n_real, roster=rost, want_repmask=want_repmask,
        want_rleader=want_rleader)
    outs = outs[:-1] + (torch.stack(outs[-1], dim=1),)
    if recruit is not None:
        outs = outs + (pac_eval.node_count_plain(recruit, active,
                                                 n_real=n_real),)
    return outs


def fused_downtime_eval(upw, fullw, *, rf: int, n_real: int, roster=None,
                        recruit=None, active=None,
                        want_repmask: bool = False,
                        want_rleader: bool = False, block_t=None,
                        block_p=None):
    """(B, W, P) int32 words -> (lark, qmaj, leader, leader_full, nrep
    (each (B, P)), *extras, crepsw (B, W, P) int32[, counts (B, n_real)
    int32]) in one launch.

    roster, optional: (B, P, rf) int32 — the layout the engine carries
    (rank j of partition p at [b, p, j]), read as it is; the reference
    passes it moved to (B, rf, P) for the TPU's lanes.  recruit (B, P)
    int32 and active (B, P) bool, optional and together: also count the
    in-flight catch-ups per (trial, node).  CUDA tensors launch the
    kernel in blocks of (block_t, block_p); CPU tensors run
    ``fused_downtime_eval_plain``."""
    _check(upw, fullw, rf=rf, voters=rf, n_real=n_real)
    if want_rleader and roster is None:
        raise ValueError("rleader needs a roster (it elects among "
                         "roster members)")
    if want_repmask and rf > 30:
        raise ValueError(f"repmask needs rf <= 30 (a non-negative int32 "
                         f"bitmask); got rf={rf}")
    if (recruit is None) != (active is None):
        raise ValueError("recruit and active must be passed together")
    B, W, P = upw.shape
    if roster is not None:
        if roster.dtype != torch.int32 or roster.shape != (B, P, rf):
            raise ValueError(f"roster must be ({B}, {P}, {rf}) int32; got "
                             f"{tuple(roster.shape)} {roster.dtype}")
        if roster.device != upw.device or not roster.is_contiguous():
            raise ValueError("roster must be contiguous, on the words' "
                             "device")
    if recruit is not None:
        pac_eval.check_counts_args(recruit, active, n_real=n_real)
        if recruit.shape != (B, P) or recruit.device != upw.device:
            raise ValueError(f"recruit/active must be ({B}, {P}) on the "
                             f"words' device")
    if upw.device.type == "cpu":
        return fused_downtime_eval_plain(
            upw, fullw, rf=rf, n_real=n_real, roster=roster,
            recruit=recruit, active=active, want_repmask=want_repmask,
            want_rleader=want_rleader)
    if upw.device.type != "cuda":
        raise ValueError(f"fused_downtime_eval runs on cuda or cpu, not "
                         f"{upw.device}")
    if B > 65535:
        raise ValueError(f"fused_downtime_eval takes at most 65535 trials "
                         f"(the grid's y axis); got {B}")
    bt, bp = _block(block_t, block_p, B, P)
    dev = upw.device

    def rows(dtype):
        return torch.empty((B, P), dtype=dtype, device=dev)

    lark, qmaj, lfull = (rows(torch.bool) for _ in range(3))
    leader, nrep = rows(torch.int32), rows(torch.int32)
    repmask = rows(torch.int32) if want_repmask else None
    rleader = rows(torch.int32) if want_rleader else None
    crepsw = torch.empty((B, W, P), dtype=torch.int32, device=dev)
    counts = None if recruit is None else \
        torch.zeros((B, n_real), dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    launch = _build.function("fused_downtime", "fused_downtime_eval_launch",
                             _FDT_ARGTYPES)
    err = launch(upw.data_ptr(), fullw.data_ptr(), ptr(roster),
                 ptr(recruit), ptr(active), lark.data_ptr(),
                 qmaj.data_ptr(), leader.data_ptr(), lfull.data_ptr(),
                 nrep.data_ptr(), ptr(repmask), ptr(rleader),
                 crepsw.data_ptr(), ptr(counts), B, W, P, n_real, rf, bt,
                 bp, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_downtime_eval")
    fused_downtime_eval.launches += 1
    extras = tuple(t for t in (repmask, rleader) if t is not None)
    outs = (lark, qmaj, leader, lfull, nrep) + extras + (crepsw,)
    return outs + ((counts,) if counts is not None else ())


#: kernel launches since the last reset
fused_downtime_eval.launches = 0
