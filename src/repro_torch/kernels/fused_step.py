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
carried as int32 (the reference's uint32 bit patterns).  Dispatch follows
the tensor: a CUDA tensor launches the kernel (or raises), a CPU tensor
runs the plain version.  There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, bitpack, pac_eval

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


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


def fused_pac_eval(upw, fullw, *, rf: int, voters: int, n_real: int):
    """(B, W, P) int32 words -> (lark (B, P) bool, maj (B, P) bool,
    crepsw (B, W, P) int32).  CUDA tensors run the kernel; CPU tensors
    run ``fused_pac_eval_plain``."""
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
    lark = torch.empty((B, P), dtype=torch.bool, device=upw.device)
    maj = torch.empty((B, P), dtype=torch.bool, device=upw.device)
    crepsw = torch.empty((B, W, P), dtype=torch.int32, device=upw.device)
    launch = _build.function("fused_downtime", "fused_pac_eval_launch",
                             _ARGTYPES)
    err = launch(upw.data_ptr(), fullw.data_ptr(), lark.data_ptr(),
                 maj.data_ptr(), crepsw.data_ptr(), B, W, P, n_real, rf,
                 voters, torch.cuda.current_stream(upw.device).cuda_stream)
    _build.check(err, "fused_pac_eval")
    fused_pac_eval.launches += 1
    return lark, maj, crepsw


#: kernel launches since the last reset (a plain count, set to 0 by the
#: caller before a run it wants to attribute)
fused_pac_eval.launches = 0


# ---------------------------------------------------------------------------
# fused_downtime_eval: §6 eval + roster + node counts on packed words
# ---------------------------------------------------------------------------

_FDT_ARGTYPES = (ctypes.c_void_p,) * 14 + (ctypes.c_int,) * 5 + \
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
                        want_rleader: bool = False):
    """(B, W, P) int32 words -> (lark, qmaj, leader, leader_full, nrep
    (each (B, P)), *extras, crepsw (B, W, P) int32[, counts (B, n_real)
    int32]) in one launch.

    roster, optional: (B, P, rf) int32 — the layout the engine carries
    (rank j of partition p at [b, p, j]), read as it is; the reference
    passes it moved to (B, rf, P) for the TPU's lanes.  recruit (B, P)
    int32 and active (B, P) bool, optional and together: also count the
    in-flight catch-ups per (trial, node).  CUDA tensors launch the
    kernel; CPU tensors run ``fused_downtime_eval_plain``."""
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
                 crepsw.data_ptr(), ptr(counts), B, W, P, n_real, rf,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_downtime_eval")
    fused_downtime_eval.launches += 1
    extras = tuple(t for t in (repmask, rleader) if t is not None)
    outs = (lark, qmaj, leader, lfull, nrep) + extras + (crepsw,)
    return outs + ((counts,) if counts is not None else ())


#: kernel launches since the last reset
fused_downtime_eval.launches = 0
