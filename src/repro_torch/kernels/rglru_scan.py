"""The RG-LRU linear recurrence of Griffin / RecurrentGemma: the CUDA
kernel ``rglru_scan`` (csrc/rglru_scan.cu) beside its plain PyTorch
version, and the one-step recurrence ``rglru_step_plain`` that decode
uses.

    h_t = a_t h_{t-1} + b_t,   a_t = exp(log_a_t),   h_{-1} = 0

* ``rglru_scan`` replaces ``repro/kernels/rglru_scan.py: rglru_scan``
  (Pallas body ``_rglru_kernel``).  It follows the oracle
  ``repro/kernels/ref.py: rglru_scan_ref`` (b_t = sqrt(max(1 -
  exp(2 log_a_t), 0)) x_t) where the Pallas wrapper falls short: any S and
  W.  Bound by bytes: at the recurrentgemma-9b serve shape (B = 4,
  S = 3072, W = 4096) a call moves 604 MB, and the kernel reads x and
  log_a once: one launch, a chain of chunks across its blocks.
  ``rglru_check`` holds it against the plain version.
* ``rglru_step_plain`` is ``ref.py: rglru_step``, which takes
  b = sqrt(max(1 - a a, 0)) x, another expression of the same term; the
  reference has no kernel for it, and neither has the port.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version.  There is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: the kernel's chunk of positions and tile of channels (csrc/rglru_scan.cu
#: kChunk, kThreads); the scratch of a call is one 64-bit carry word per
#: (b, chunk, channel) and the ticket
CHUNK, TILE = 64, 128


def _work_dtype(*xs):
    """float64 when an input is float64 (the card-side check's
    reference), else float32."""
    return torch.float64 if any(x.dtype == torch.float64 for x in xs) \
        else torch.float32


def rglru_coefficients(x, log_a):
    """(a, b) of the recurrence in the working type: a = exp(log_a),
    b = sqrt(max(1 - exp(2 log_a), 0)) x."""
    dt = _work_dtype(x, log_a)
    la = log_a.to(dt)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), min=0.0)) * \
        x.to(dt)
    return torch.exp(la), b


def rglru_scan_plain(x, log_a):
    """The recurrence over S, the math of ``ref.rglru_scan_ref``, walked
    in order.  x, log_a (B, S, W) in any float type.  Returns h (B, S, W)
    float32 (float64 when an input is float64)."""
    rglru_scan_plain.calls += 1
    a, b = rglru_coefficients(x, log_a)
    out = torch.empty_like(b)
    h = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


#: calls of the plain version since the last reset, on any device (a run
#: on the card that must go through the kernel reads 0 here)
rglru_scan_plain.calls = 0


def rglru_step_plain(x, log_a, h):
    """One decode step, the math of ``ref.rglru_step``: x, log_a (B, W),
    h (B, W) float32 carry."""
    a = torch.exp(log_a.to(torch.float32))
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * x.to(torch.float32)
    return a * h + b


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + \
    (ctypes.c_void_p,)


def _check(x, log_a):
    if x.dim() != 3 or log_a.shape != x.shape:
        raise ValueError(f"rglru_scan takes x and log_a of one shape "
                         f"(B, S, W); got {tuple(x.shape)}, "
                         f"{tuple(log_a.shape)}")
    if not (x.is_floating_point() and log_a.is_floating_point()):
        raise TypeError(f"rglru_scan takes float tensors; got {x.dtype}, "
                        f"{log_a.dtype}")
    if x.device != log_a.device:
        raise ValueError("rglru_scan takes x and log_a on one device")


def rglru_scan(x, log_a):
    """x, log_a (B, S, W), any float type.  Returns h (B, S, W) float32
    as ``rglru_scan_plain``.  CUDA tensors launch the kernel
    (``rglru_scan.launches`` counts the calls); CPU tensors run the plain
    version."""
    _check(x, log_a)
    if x.device.type == "cpu":
        return rglru_scan_plain(x, log_a)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, not {x.device}")
    launch = _build.function("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    h, args, _ = launch_args(x, log_a)
    _build.check(launch(*args, torch.cuda.current_stream(x.device)
                        .cuda_stream), "rglru_scan")
    rglru_scan.launches += 1
    return h


def launch_args(x, log_a, *, fill=None):
    """One launch of csrc/rglru_scan.cu's C interface on checked CUDA
    tensors: returns (h, args, keep), where ``launch(*args, stream)``
    writes h (B, S, W) float32 (``torch.empty``, or filled with `fill`)
    and `keep` holds the tensors behind the pointers of `args` (x and
    log_a cast to contiguous float32, the carry scratch) alive."""
    B, S, W = x.shape
    units = B * -(-S // CHUNK) * -(-W // TILE)
    if S < 1 or W < 1 or units >= 2 ** 31:
        raise ValueError(f"rglru_scan: need S, W >= 1 and B * ceil(S / "
                         f"{CHUNK}) * ceil(W / {TILE}) < 2^31; got "
                         f"{(B, S, W)}")
    x, la = (t.to(torch.float32).contiguous() for t in (x, log_a))
    h = torch.empty((B, S, W), dtype=torch.float32, device=x.device)
    if fill is not None:
        h.fill_(fill)
    carry = torch.empty(B * -(-S // CHUNK) * W + 1, dtype=torch.int64,
                        device=x.device)
    args = (x.data_ptr(), la.data_ptr(), h.data_ptr(), carry.data_ptr(), B,
            S, W)
    return h, args, (x, la, carry)


#: kernel launches since the last reset
rglru_scan.launches = 0
