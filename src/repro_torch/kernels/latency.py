"""Client-latency charge math for the §6 per-key request layer, in
PyTorch (port of ``repro/kernels/latency.py``).

The layer carries one analytic "dirty key fraction" per (trial,
partition, key-popularity bucket) and, per event interval, charges:

  LARK    the expected first-touch requests of keys still dirty after a
          leader change onto a stale leader: ``kf * (d - d * rho^dt)``,
          with the dirty fraction decayed by host-built float32 factors.
  quorum  writes arriving while a rebuild is in flight wait out the
          remaining rebuild: closed forms in (rem, dt) give the
          power-of-two latency histogram, the SLO-violation count and the
          latency sum, in integer tick arithmetic scaled once by the
          float32 write rate.

Bit-identity contract, as the reference's: every in-graph float op is
one exactly rounded IEEE float32 multiply, add or subtract, written as a
separate eager op (PyTorch does not contract them into an FMA), in the
reference's expression order, with its ``max(x, 0)`` fences.  The exp()
runs once on the host in float64 (``decay_pow_tables``).  Gradual
underflow is never switched off (no ``torch.set_flush_denormal``); the
``_SUBNORMAL_FLOOR`` flush is what keeps every backend equal once the
geometric decay crosses 2^-126.

``decay_pow_tables`` is host numpy, copied verbatim.  The other functions
take torch tensors; ``latency_step_ref`` is the plain version of the CUDA
kernel ``latency_charge`` (``kernels/pac_eval.py``).
"""
from __future__ import annotations

import numpy as np
import torch

#: int32 "open-ended top bucket" upper edge
_I32_MAX = 2 ** 31 - 1

#: subnormal guard: XLA's CPU/TPU backends run float32 math with
#: FTZ/DAZ (subnormals flush to zero), numpy honors gradual underflow —
#: the one way "exactly-rounded elementwise f32" can still diverge.  The
#: dirty-fraction state decays geometrically toward 0, so it WILL cross
#: the subnormal range; we flush it to exact 0 at a floor comfortably
#: above 2^-126, identically on every backend, before the difference can
#: reach a charge.  Host-built decay tables get the same flush so DAZ
#: never sees a subnormal input either.
_SUBNORMAL_FLOOR = np.float32(1e-30)


# ---------------------------------------------------------------------------
# Host-side (numpy, float64 -> float32) precomputation
# ---------------------------------------------------------------------------

def decay_pow_tables(lam, g, f, keys_per_partition: int,
                     max_ticks: int) -> np.ndarray:
    """(nbits, P, NB) float32 successive squares of the per-tick key
    survival probability rho_{j,b} = exp(-lam_j * g_b / (K * f_b)).

    Table i holds rho^(2^i); `decay_from_dt` selects the bits of dt and
    multiplies, so rho^dt is a fixed-order chain of exactly-rounded
    float32 multiplies — identical on every backend.  The exp() runs
    here, host-side, in float64; the in-graph math never sees a
    transcendental.  nbits covers dt <= max_ticks (an event interval
    never exceeds the horizon)."""
    lam = np.asarray(lam, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    f = np.asarray(f, dtype=np.float64)
    mu = lam[:, None] * g[None, :] / (keys_per_partition * f[None, :])
    rho = np.exp(-mu).astype(np.float32)                     # (P, NB)
    nbits = max(1, int(max_ticks).bit_length())
    tabs = np.empty((nbits,) + rho.shape, dtype=np.float32)
    t = np.where(rho >= _SUBNORMAL_FLOOR, rho, np.float32(0.0))
    for i in range(nbits):
        tabs[i] = t
        t = t * t                                            # float32
        t = np.where(t >= _SUBNORMAL_FLOOR, t, np.float32(0.0))
    return tabs


# ---------------------------------------------------------------------------
# In-graph math (torch)
# ---------------------------------------------------------------------------

def decay_from_dt(dt, pow_tables):
    """rho^dt per (trial, partition, bucket): dt (B,) int32, pow_tables
    (nbits, P, NB) float32 -> (B, P, NB) float32 by binary
    exponentiation over the precomputed squares.  A multiply by an exact
    1.0 where a bit is clear is the identity, so the chain length is
    static and the product order fixed: table 0 first, then each higher
    table in turn."""
    dec = None
    for i in range(pow_tables.shape[0]):
        bit = ((dt >> i) & 1) > 0                              # (B,)
        fac = torch.where(bit[:, None, None], pow_tables[i][None], 1.0)
        dec = fac if dec is None else dec * fac
    return dec


def dirty_step(dirty, decay, avail, kf):
    """One interval of dirty-fraction decay and LARK first-touch charges.

    dirty, decay (..., NB) float32; avail broadcastable bool (keys are
    only touched while the partition serves); kf broadcastable float32
    keys per bucket.  Returns (new_dirty, dup) with dup = kf * (dirty -
    new_dirty), the decayed fraction flushed to 0 below _SUBNORMAL_FLOOR
    before the charge is taken; the trailing max(x, 0) is the reference's
    FMA fence (exact: dirty >= new_dirty >= 0)."""
    dec = torch.where(avail, decay, 1.0)
    new_dirty = dirty * dec
    new_dirty = torch.where(new_dirty >= float(_SUBNORMAL_FLOOR), new_dirty,
                            0.0)
    dup = torch.clamp_min(kf * (dirty - new_dirty), 0.0)
    return new_dirty, dup


def quorum_step(rem, dt, qok, lamw, lanes, *, nbins: int, slo_ticks: int):
    """Quorum-side closed-form charges for one interval.

    rem, dt (..., 1) int32, qok (..., 1) bool, lamw (..., 1) float32;
    lanes broadcastable int32 bucket indices.  A write arriving tau in
    [0, dt) ticks into the interval pays max(rem - tau, 0) ticks, while
    the replica majority is up (qok).  Returns (qhist (..., L), qslo
    (..., 1), qsum (..., 1)) float32: requests per power-of-two latency
    bucket [2^k, 2^(k+1)) (top bucket open-ended; lanes >= nbins give 0),
    requests strictly over slo_ticks, and the latency sum.  The counts
    are int32; each float is one multiply by lamw behind a max(x, 0)
    fence, and qsum keeps the reference's order: (half * payf) *
    (payf - 1), subtracted from payf * remf, times lamw."""
    pay = torch.clamp_min(torch.minimum(dt, rem), 0)         # paying ticks
    k = torch.clamp_max(lanes, nbins - 1)
    lo = torch.bitwise_left_shift(torch.ones_like(k), k)
    hi = torch.where(k == nbins - 1, _I32_MAX, 2 * lo - 1)
    # paying writes see remaining values rem, rem-1, ..., rem-pay+1;
    # the count inside [lo, hi] is a clipped interval intersection
    cnt = torch.minimum(rem, hi) - torch.maximum(rem - pay + 1, lo) + 1
    cnt = torch.where(qok & (lanes < nbins), torch.clamp_min(cnt, 0), 0)
    qhist = torch.clamp_min(lamw * cnt.to(torch.float32), 0.0)
    payf = pay.to(torch.float32)
    remf = rem.to(torch.float32)
    qsum = torch.where(qok, lamw * (payf * remf - 0.5 * payf * (payf - 1.0)),
                       0.0)
    qsum = torch.clamp_min(qsum, 0.0)
    slo_cnt = torch.clamp_min(torch.minimum(dt, rem - slo_ticks), 0)
    qslo = torch.clamp_min(
        torch.where(qok, lamw * slo_cnt.to(torch.float32), 0.0), 0.0)
    return qhist, qslo, qsum


def latency_step_ref(dirty, dt_i, avail, qok, rem, *, pow_tables, kf,
                     lamw, nbins: int, slo_ticks: int):
    """The full per-interval latency update on (B, P) state — the plain
    version the CUDA kernel is held against, and the reference's
    ``latency_step_ref`` op for op.

    dirty (B, P, NB) f32; dt_i (B,) i32; avail, qok (B, P) bool; rem
    (B, P) i32; pow_tables (nbits, P, NB) f32; kf (NB,) f32; lamw (P,)
    f32.  Returns (new_dirty, dup, qhist, qslo, qsum) with shapes
    (B, P, NB), (B, P, NB), (B, P, nbins), (B, P), (B, P)."""
    decay = decay_from_dt(dt_i, pow_tables)
    new_dirty, dup = dirty_step(dirty, decay, avail[:, :, None],
                                kf[None, None, :])
    lanes = torch.arange(nbins, dtype=torch.int32, device=dirty.device)
    qhist, qslo, qsum = quorum_step(
        rem[:, :, None], dt_i[:, None, None], qok[:, :, None],
        lamw[None, :, None], lanes, nbins=nbins, slo_ticks=slo_ticks)
    return new_dirty, dup, qhist, qslo[:, :, 0], qsum[:, :, 0]
