"""Causal / sliding-window attention, forward: the CUDA kernel
``flash_attention_fwd`` beside its plain PyTorch version.

``flash_attention_fwd`` replaces ``repro/kernels/flash_attention.py:
flash_attention_fwd`` (Pallas body ``_flash_kernel``) and keeps that
kernel's semantics where they differ from the oracle
``repro/kernels/ref.py: attention_ref``:

* layout (B, H, S, D), the same head count for q, k and v;
* the causal mask is left-aligned, k <= q, also when Sq != Sk (the
  oracle right-aligns it);
* a window keeps k > q - window; a row that no key may attend gives 0
  (the kernel's max(l, 1e-30) guard; the oracle's softmax would average).

It takes any Sq and Sk (the Pallas wrapper asserts that the blocks
divide them).  Two CUDA sources compute it; ``_route`` picks one from the
dtype and the head dims alone:

* ``sm90`` (csrc/flash_attention_sm90.cu): bf16 with D == Dv in
  ``SM90_HEAD_DIMS`` (the head dims of smollm, internlm2 and
  recurrentgemma).  bf16 wgmma on TMA-fed tiles; the softmax weights p
  stay float32 through a hi/lo split into two bf16 products.
* ``simt`` (csrc/flash_attention.cu): float32, and every other D or Dv up
  to 256.  Float32 on the CUDA cores.

Bound by operations at the recurrentgemma-9b local attention shape (B =
4, 16 heads, S = 3072, D = 256, window 2048, bf16): 268.5 M kept (q, k)
pairs at 4 D float ops each, 278 us at the bf16 tensor-core peak.
``flash_check`` holds both sources against the plain version.

No model path calls it, as in the reference: the local attention of
``models/attention.py`` is the reference's own masked softmax.  Its entry
point is ``ops.flash_attention``.  Dispatch follows the tensor: a CUDA
tensor launches the kernel of its route (or raises), a CPU tensor runs
the plain version.  There is no fallback.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

NEG = -1e30
#: the largest head dims the simt kernel takes (its accumulator is 16
#: columns per thread of a 16-wide grid)
MAX_D = 256
#: the head dims of the sm90 kernel (one template instantiation each)
SM90_HEAD_DIMS = (64, 128, 256)


def attention_mask(Sq: int, Sk: int, *, causal: bool, window: int,
                   device=None):
    """(Sq, Sk) bool: which keys each query may attend (left-aligned)."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= kp > qp - window
    return mask


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None):
    """The Pallas kernel's function, one dense masked softmax: q (B, H, Sq,
    D), k (B, H, Sk, D), v (B, H, Sk, Dv).  Computes in float32 (float64
    when q is float64) and returns (B, H, Sq, Dv) in q's type."""
    flash_attention_plain.calls += 1
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf = (t.to(dt) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = attention_mask(q.shape[2], k.shape[2], causal=causal,
                          window=window, device=q.device)
    s = torch.where(mask, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return (torch.einsum("bhqk,bhkd->bhqd", p, vf) / den).to(q.dtype)


#: calls since the last reset (the plain version must not run on the card)
flash_attention_plain.calls = 0


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

#: csrc/flash_attention.cu: flash_attention_launch
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + \
    (ctypes.c_float,) + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
#: csrc/flash_attention_sm90.cu: flash_attention_sm90_launch
_ARGTYPES_SM90 = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + \
    (ctypes.c_float,) + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)
#: route: (source, C symbol, argtypes)
ROUTES = {"sm90": ("flash_attention_sm90", "flash_attention_sm90_launch",
                   _ARGTYPES_SM90),
          "simt": ("flash_attention", "flash_attention_launch", _ARGTYPES)}


def _route(dtype, D: int, Dv: int) -> str:
    """The CUDA source that computes attention on these inputs, from the
    dtype and the head dims alone: "sm90" for bf16 with D == Dv in
    ``SM90_HEAD_DIMS``, else "simt"."""
    if dtype == torch.bfloat16 and D == Dv and D in SM90_HEAD_DIMS:
        return "sm90"
    return "simt"


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:2] != q.shape[:2] or v.shape[:3] != k.shape[:3] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention_fwd takes q (B, H, Sq, D), k "
                         f"(B, H, Sk, D) and v (B, H, Sk, Dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or not q.is_floating_point():
        raise TypeError(f"q, k, v must share one float type; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention_fwd takes q, k, v on one device")


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: int = 0,
                        scale: Optional[float] = None):
    """q (B, H, Sq, D), k (B, H, Sk, D), v (B, H, Sk, Dv).  Returns
    (B, H, Sq, Dv) in q's type, as ``flash_attention_plain``.  CUDA tensors
    (float32 or bfloat16, D and Dv <= 256) launch the kernel of
    ``_route`` (``flash_attention_fwd.launches`` counts all launches,
    ``.sm90_launches`` and ``.simt_launches`` each route's); CPU tensors
    (and meta tensors, which only carry shapes) run the plain version."""
    _check(q, k, v)
    if q.device.type in _build.PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda, cpu or meta, not "
                         f"{q.device}")
    route = _route(q.dtype, q.shape[3], v.shape[3])
    launch = _build.function(*ROUTES[route])
    out = launch_with(launch, q, k, v, causal=causal, window=window,
                      scale=scale, route=route)
    flash_attention_fwd.launches += 1
    if route == "sm90":
        flash_attention_fwd.sm90_launches += 1
    else:
        flash_attention_fwd.simt_launches += 1
    return out


def launch_with(launch, q, k, v, *, causal, window, scale, route):
    """Allocate the output and call `launch`, a ctypes function of the C
    interface of `route`'s source (``ROUTES``), on checked CUDA tensors;
    raises on a launch error.  Counts nothing."""
    B, H, Sq, D = q.shape
    Sk, Dv = k.shape[2], v.shape[3]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16; got "
                        f"{q.dtype}")
    if not (1 <= D <= MAX_D and 1 <= Dv <= MAX_D) or Sq < 1 or Sk < 1 or \
            B * H > 65535 or window < 0:
        raise ValueError(f"the kernel takes D, Dv in [1, {MAX_D}], Sq, Sk "
                         f">= 1, B * H <= 65535, window >= 0; got "
                         f"{tuple(q.shape)}, Dv={Dv}, Sk={Sk}, "
                         f"window={window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q, k, v = (t.contiguous() for t in (q, k, v))
    o = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if route == "sm90":
        if _route(q.dtype, D, Dv) != "sm90" or (Sq + 127) // 128 * B * H \
                >= 2 ** 31:
            raise ValueError(f"the sm90 kernel takes bf16 with D == Dv in "
                             f"{SM90_HEAD_DIMS} and (Sq / 128) B H < 2^31; "
                             f"got {q.dtype}, D={D}, Dv={Dv}, "
                             f"{tuple(q.shape)}")
        # TMA reads from 16-byte aligned bases
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     B * H, Sq, Sk, D, scale, int(causal), int(window),
                     stream)
        _build.check(err, "flash_attention_fwd (sm90)")
        return o
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B * H, Sq, Sk, D, Dv, scale, int(causal), int(window),
                 int(q.dtype == torch.bfloat16), stream)
    _build.check(err, "flash_attention_fwd (simt)")
    return o


#: kernel launches since the last reset: all, and by route
flash_attention_fwd.launches = 0
flash_attention_fwd.sm90_launches = 0
flash_attention_fwd.simt_launches = 0
