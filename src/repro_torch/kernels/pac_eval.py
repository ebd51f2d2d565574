"""§5.1 PAC evaluation on boolean rank-space tiles: the CUDA kernel
``pac_eval`` (csrc/pac_eval.cu) and its plain PyTorch version.

Replaces ``repro/kernels/pac_eval.py:pac_eval`` (Pallas body
``_pac_kernel``).  Bound by bytes: 2·R·n_pad read, R·n_pad + 2R written
(about 15.3 MB per call at the paper tile R = 8·4096, n = 155).  The
kernel gives one warp to each row and turns each 32-column chunk into a
word with ``__ballot_sync``, so every byte is read or written once and
the counts are ``__popc`` of those words; see the source for the rest.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs ``pac_eval_plain``.  There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


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


def pac_eval(up, full, *, rf: int, voters: int, n_real: int):
    """(R, n_pad) bool rank-space tiles -> (lark (R,), maj (R,),
    creps (R, n_pad)) bool.  CUDA tensors run the kernel; CPU tensors run
    ``pac_eval_plain``."""
    _check(up, full, rf=rf, voters=voters, n_real=n_real)
    if up.device.type == "cpu":
        return pac_eval_plain(up, full, rf=rf, voters=voters, n_real=n_real)
    if up.device.type != "cuda":
        raise ValueError(f"pac_eval runs on cuda or cpu, not {up.device}")
    R, n_pad = up.shape
    lark = torch.empty(R, dtype=torch.bool, device=up.device)
    maj = torch.empty(R, dtype=torch.bool, device=up.device)
    creps = torch.empty((R, n_pad), dtype=torch.bool, device=up.device)
    launch = _build.function("pac_eval", "pac_eval_launch", _ARGTYPES)
    err = launch(up.data_ptr(), full.data_ptr(), lark.data_ptr(),
                 maj.data_ptr(), creps.data_ptr(), R, n_pad, n_real, rf,
                 voters, torch.cuda.current_stream(up.device).cuda_stream)
    _build.check(err, "pac_eval")
    pac_eval.launches += 1
    return lark, maj, creps


#: kernel launches since the last reset (a plain count, set to 0 by the
#: caller before a run it wants to attribute)
pac_eval.launches = 0
