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
* ``rglru_scan_bwd`` (csrc/rglru_scan_bwd.cu) is its gradient, beside
  ``rglru_scan_bwd_plain``.  The reference has no backward kernel: its
  training differentiates the oracle with ``jax.value_and_grad``.  With
  a = e^la, s = sqrt(max(1 - e^{2 la}, 0)) and b = s x, the reverse
  recurrence is g_t = dh_t + a_{t+1} g_{t+1} (g past the end 0), and
  dx_t = g_t s_t, dla_t = g_t h_{t-1} a_t - g_t x_t e^{2 la_t} / s_t.
  Where 1 - e^{2 la} rounds to 0 or below (the clamp holds; |la| below
  about 3e-8 in float32) the port takes the second term as 0: the
  derivative of the clamped branch.  The reference's autodiff meets the
  derivative of sqrt at 0 there and gives inf or NaN (a stated
  departure; tests/test_torch_rglru_bwd.py pins both).  Bound by bytes:
  x, log_a, h and dh in, dx and dla out.
* ``rglru_scan`` is a ``torch.autograd.Function``: its forward saves x,
  log_a and h, and its backward launches the backward kernel (reading
  h_{t-1}, never rescanning).  ``rglru_scan_reference`` is the same
  Function over the plain versions on any device, which checks on the
  card compare the kernels with.
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
#: the backward's chunk (csrc/rglru_scan_bwd.cu kChunk; its tile is TILE):
#: a quarter of the forward's, so its shared-memory stage of four inputs
#: fits six blocks an SM
BWD_CHUNK = 16


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


def rglru_scan_bwd_plain(x, log_a, h, dh):
    """The gradient of ``rglru_scan_plain`` with respect to x and log_a,
    walked in reverse: x, log_a, h (the forward's output) and dh (B, S, W)
    in any float type.  Returns (dx, dlog_a) float32 (float64 when an
    input is float64); where the clamp of 1 - e^{2 la} holds, dlog_a takes
    only its first term."""
    rglru_scan_bwd_plain.calls += 1
    dt = _work_dtype(x, log_a, h, dh)
    la, xx, hh, gout = (t.to(dt) for t in (log_a, x, h, dh))
    a = torch.exp(la)
    e2 = torch.exp(2.0 * la)
    s = torch.sqrt(torch.clamp(1.0 - e2, min=0.0))
    live = s > 0
    s_safe = torch.where(live, s, torch.ones_like(s))
    dx, dla = torch.empty_like(gout), torch.empty_like(gout)
    carry = torch.zeros_like(gout[:, 0])          # a_{t+1} g_{t+1}
    for t in range(gout.shape[1] - 1, -1, -1):
        g = gout[:, t] + carry
        h_prev = hh[:, t - 1] if t else torch.zeros_like(g)
        dx[:, t] = g * s[:, t]
        dla[:, t] = g * h_prev * a[:, t] - torch.where(
            live[:, t], g * xx[:, t] * e2[:, t] / s_safe[:, t], 0.0)
        carry = a[:, t] * g
    return dx, dla


rglru_scan_bwd_plain.calls = 0


class _RglruScan(torch.autograd.Function):
    """h = rglru_scan(x, log_a) with its gradient: the kernels on the
    card, the plain versions on the CPU or when `plain` is set."""

    @staticmethod
    def forward(ctx, x, log_a, plain):
        if x.is_meta:                    # shapes only: no walk to take
            h = torch.empty(x.shape, dtype=_work_dtype(x, log_a),
                            device="meta")
        else:
            h = rglru_scan_plain(x, log_a) if plain else \
                _scan_kernel(x, log_a)
        ctx.save_for_backward(x, log_a, h)
        ctx.plain = plain
        return h

    @staticmethod
    def backward(ctx, dh):
        x, log_a, h = ctx.saved_tensors
        bwd = rglru_scan_bwd_plain if ctx.plain and not x.is_meta else \
            rglru_scan_bwd
        dx, dla = bwd(x, log_a, h, dh)
        return dx.to(x.dtype), dla.to(log_a.dtype), None


def rglru_scan(x, log_a):
    """x, log_a (B, S, W), any float type.  Returns h (B, S, W) float32
    as ``rglru_scan_plain``, differentiable in x and log_a.  CUDA tensors
    launch the kernel (``rglru_scan.launches`` counts the calls) and,
    backwards, ``rglru_scan_bwd``; CPU tensors run the plain versions,
    and meta tensors (the dry run's shapes) give the result's shape and
    type without a walk.  A tensor-parallel step calls it on each rank's
    local width shard (``models/ssm.py``)."""
    _check(x, log_a)
    if x.device.type not in ("cuda",) + _build.PLAIN_DEVICES:
        raise ValueError(f"rglru_scan runs on cuda, cpu or meta, not "
                         f"{x.device}")
    return _RglruScan.apply(x, log_a, x.device.type in _build.PLAIN_DEVICES)


def rglru_scan_reference(x, log_a):
    """``rglru_scan`` over the plain forward and backward on any device:
    what checks on the card hold the kernels' gradients against."""
    _check(x, log_a)
    return _RglruScan.apply(x, log_a, True)


def _scan_kernel(x, log_a):
    launch = _build.function("rglru_scan", "rglru_scan_launch", _ARGTYPES)
    h, args, _ = launch_args(x, log_a)
    _build.check(launch(*args, torch.cuda.current_stream(x.device)
                        .cuda_stream), "rglru_scan")
    rglru_scan.launches += 1
    return h


def rglru_scan_bwd(x, log_a, h, dh):
    """(dx, dlog_a) float32 as ``rglru_scan_bwd_plain``: CUDA tensors
    launch csrc/rglru_scan_bwd.cu (``rglru_scan_bwd.launches`` counts the
    calls), CPU tensors run the plain version, meta tensors give the
    results' shapes and type."""
    _check(x, log_a)
    if h.shape != x.shape or dh.shape != x.shape:
        raise ValueError(f"rglru_scan_bwd takes h and dh of x's shape "
                         f"{tuple(x.shape)}; got {tuple(h.shape)}, "
                         f"{tuple(dh.shape)}")
    if x.is_meta:                        # shapes only: no walk to take
        dt = _work_dtype(x, log_a, h, dh)
        return tuple(torch.empty(x.shape, dtype=dt, device="meta")
                     for _ in range(2))
    if x.device.type in _build.PLAIN_DEVICES:
        return rglru_scan_bwd_plain(x, log_a, h, dh)
    if x.device.type != "cuda" or h.device != x.device or \
            dh.device != x.device:
        raise ValueError(f"rglru_scan_bwd runs on one cuda or cpu device; "
                         f"got {x.device}, {h.device}, {dh.device}")
    launch = _build.function("rglru_scan_bwd", "rglru_scan_bwd_launch",
                             BWD_ARGTYPES)
    out, args, _ = bwd_launch_args(x, log_a, h, dh)
    _build.check(launch(*args, torch.cuda.current_stream(x.device)
                        .cuda_stream), "rglru_scan_bwd")
    rglru_scan_bwd.launches += 1
    return out


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


def bwd_launch_args(x, log_a, h, dh, *, fill=None):
    """One launch of csrc/rglru_scan_bwd.cu's C interface on checked CUDA
    tensors: returns ((dx, dla), args, keep) as ``launch_args``, the
    outputs float32 (``torch.empty``, or filled with `fill`).  The carry
    scratch also serves a build with a larger kChunk (``rglru_check``'s
    parent and probes)."""
    B, S, W = x.shape
    units = B * -(-S // BWD_CHUNK) * -(-W // TILE)
    if S < 1 or W < 1 or units >= 2 ** 31:
        raise ValueError(f"rglru_scan_bwd: need S, W >= 1 and B * ceil(S / "
                         f"{BWD_CHUNK}) * ceil(W / {TILE}) < 2^31; got "
                         f"{(B, S, W)}")
    ins = tuple(t.to(torch.float32).contiguous() for t in (x, log_a, h, dh))
    dx, dla = (torch.empty((B, S, W), dtype=torch.float32, device=x.device)
               for _ in range(2))
    if fill is not None:
        dx.fill_(fill)
        dla.fill_(fill)
    carry = torch.empty(B * -(-S // BWD_CHUNK) * W + 1, dtype=torch.int64,
                        device=x.device)
    args = tuple(t.data_ptr() for t in (*ins, dx, dla, carry)) + (B, S, W)
    return (dx, dla), args, (*ins, carry)


#: csrc/rglru_scan_bwd.cu: rglru_scan_bwd_launch(x, log_a, h, dh, dx, dla,
#: carry, B, S, W, stream)
BWD_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + \
    (ctypes.c_void_p,)

#: kernel launches since the last reset
rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
