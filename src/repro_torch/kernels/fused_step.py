"""§5.1 PAC evaluation on bit-packed (B, W, P) word planes: the CUDA
kernel ``fused_pac_eval`` (csrc/fused_step.cu) and its plain PyTorch
version.

Replaces ``repro/kernels/fused_step.py:fused_pac_eval`` (Pallas body
``_fused_pac_kernel``).  Bound by bytes: 3·B·W·P·4 + 2·B·P per call
(about 2.0 MB at the paper tile B = 8, W = 5, P = 4096).  The kernel
gives one thread to each (trial, partition); word k of neighbouring
partitions is contiguous, so every load and store is coalesced.  Words
are carried as int32 (the reference's uint32 bit patterns).

Dispatch follows the tensor: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs ``fused_pac_eval_plain``.  There is no
fallback.  The §6 ``fused_downtime_eval`` is still to be ported (ROADMAP
Queue 2 item 6).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, bitpack

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
    lark = torch.empty((B, P), dtype=torch.bool, device=upw.device)
    maj = torch.empty((B, P), dtype=torch.bool, device=upw.device)
    crepsw = torch.empty((B, W, P), dtype=torch.int32, device=upw.device)
    launch = _build.function("fused_step", "fused_pac_eval_launch",
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
