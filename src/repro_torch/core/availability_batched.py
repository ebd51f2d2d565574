"""Batched availability Monte Carlo — paper §5.1 at scale, in PyTorch
(port of ``repro/core/availability_batched.py``).

Advances B independent failure trajectories x P partitions per step.
Every trial keeps tensor state on one device — up mask (B, n),
next-event times (B, n), frozen holder masks (B, P, n) bool or (B, W, P)
packed words — and each step jumps every trial to its own next event,
then evaluates PAC / majority / current-replica conditions through
``kernels/ops.step_eval``: on a CUDA device the hand-written kernels
``pac_eval`` (unpacked) or ``fused_pac_eval`` (packed), on the CPU their
plain PyTorch versions.

The port reproduces the reference bit for bit for the same seed and
knobs:

* Randomness is the reference's counter hash keyed by (seed, step,
  global lane).  torch has no uint32 shifts or adds on the CPU, so the
  32-bit values ride in int64 and are masked back to 32 bits after each
  multiply (the low 32 bits of an int64 product are the uint32 product).
  No ``torch.Generator`` is used.
* Geometric gaps invert a float32 CDF table built in float64 numpy
  exactly as the reference builds it, by ``torch.searchsorted(...,
  right=True)`` with both operands float32: comparisons only.
* ``lpt = lpt + count.float() * dt`` stays two eager ops, so no FMA
  changes the float32 bits the float64 drains sum (ARCHITECTURE
  invariant 8).
* A Python loop over ``chunk_steps`` replaces ``lax.scan``; the float64
  drains, the early-stop test and the trajectory columns fall on the
  reference's chunk boundaries and are computed host-side in numpy with
  the reference's expressions.

``carry_from_numpy`` / ``carry_to_numpy`` move an engine carry between
the reference's numpy arrays and the port's tensors, so both engines can
be started from one mid-run state.  Multi-device sharding is not ported:
``devices > 1`` is validated and the trials run as one batch on one
device, which invariant 2 makes identical to the sharded run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import bitpack
from ..kernels.ops import StepSpec, step_eval
from .availability import t975
from .succession import succession_matrix_fast

_GEO_SALT = 0x9E3779B9
_PAIR_SALT = 0x85EBCA6B
_LANE_MUL = 0x9E3779B9
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Counter-based RNG: 32-bit values carried in int64 tensors (or python ints)
# ---------------------------------------------------------------------------

def _mix32(x):
    """lowbias32-style avalanche on 32-bit values held as python ints or
    int64 tensors in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0xD35A2D97) & _MASK32
    x = x ^ (x >> 15)
    return x


def _seed_mix(seed: int) -> int:
    return _mix32((seed & _MASK32) ^ 0x6A09E667)


def _lane_keys(lane0, n: int):
    """(B, n) int64 ``(lane0[b] + j) * 0x9E3779B9 mod 2^32`` — the per-lane
    hash input, a function of the global lane only (so of no step)."""
    j = torch.arange(n, dtype=torch.int64, device=lane0.device)
    lanes = (lane0.to(torch.int64)[:, None] + j[None, :]) & _MASK32
    return (lanes * _LANE_MUL) & _MASK32


def _uniforms(seed_mix: int, step: int, salt: int, lanes):
    """(B, n) float32 uniforms in [0, 1) from (seed, step, global lane).

    ``lanes`` is ``_lane_keys(lane0, n)``.  The step is hashed into a
    per-step key on the host (a python int), exactly as the reference
    hashes its uint32 step scalar."""
    key = _mix32((step & _MASK32) ^ seed_mix ^ salt)
    h = _mix32(_mix32(lanes ^ key) ^ seed_mix)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _geometric_breaks(p: float, gap_cap: int) -> np.ndarray:
    """CDF breakpoints for Geom(p) inversion by searchsorted — built in
    float64 numpy and cast to float32 exactly as the reference does (see
    its docstring for why a table and not a log inverse)."""
    k_max = int(math.ceil(math.log(2.0 ** -25) / math.log1p(-p))) + 2
    k_max = min(k_max, gap_cap)
    k = np.arange(1, k_max + 1, dtype=np.float64)
    return (-np.expm1(k * math.log1p(-p))).astype(np.float32)  # 1-(1-p)^k


def _geometric(u, breaks):
    """Geom(p) on {1, 2, ...}: g = #{k : cdf(k) <= u} + 1, int32."""
    return torch.searchsorted(breaks, u, right=True, out_int32=True) + 1


def _geo_tables(p_arr: np.ndarray, gap_cap: int, device):
    """Per-node-class Geom(p) tables: (node masks, CDF tables) per
    distinct p, selected per node by mask."""
    uniq, inv = np.unique(p_arr, return_inverse=True)
    masks = [torch.as_tensor(inv == k, device=device)
             for k in range(len(uniq))]
    tables = [torch.as_tensor(_geometric_breaks(float(pv), gap_cap),
                              device=device) for pv in uniq]
    return masks, tables


def _geometric_multi(u, geo_masks, geo_tables):
    geo = _geometric(u, geo_tables[0])
    for m, tbl in zip(geo_masks[1:], geo_tables[1:]):
        geo = torch.where(m[None, :], _geometric(u, tbl), geo)
    return geo


# ---------------------------------------------------------------------------
# Result
# ---------------------------------------------------------------------------

@dataclass
class BatchedAvailabilityResult:
    p: float
    rf: int
    n: int
    partitions: int
    trials: int
    device: str
    ticks: int                    # mean elapsed ticks per trial
    u_lark: float                 # pooled over trials
    u_maj: float
    lark_events: int
    maj_events: int
    ci_lark: float
    ci_maj: float
    stopped_early: bool
    devices: int = 1
    u_lark_trials: np.ndarray = field(repr=False, default=None)
    u_maj_trials: np.ndarray = field(repr=False, default=None)
    trajectory: Optional[Dict[str, np.ndarray]] = field(repr=False,
                                                        default=None)

    @property
    def improvement(self) -> float:
        return self.u_maj / self.u_lark if self.u_lark > 0 else math.inf


# ---------------------------------------------------------------------------
# Node-trajectory advance
# ---------------------------------------------------------------------------

def _make_node_advance(*, n: int, horizon: int, dt_vec, geo_masks,
                       geo_tables, seed_mix: int, pair_fail_prob: float,
                       pair_perm, restart_period: int, wave_width: int):
    """Closure advancing the node up/down state to the next event.

    advance(now, up, ev_t, rr_t, rr_idx, lane0, s) ->
        (t_clamp, dt, active, up, ev_t, rr_t, rr_idx)

    All randomness is drawn here, keyed by (seed, step s, global lane),
    as in the reference.  The lane hash depends on lane0 alone, so it is
    kept for the lane0 tensor last seen.
    """
    device = dt_vec.device
    node_ids = torch.arange(n, dtype=torch.int32, device=device)
    perm = torch.as_tensor(pair_perm, dtype=torch.int64, device=device)
    # u2 < p compares in float32 in numpy 2 and jax; say so explicitly
    pair_cut = float(np.float32(pair_fail_prob))
    lane_cache = [None, None]

    def advance(now, up, ev_t, rr_t, rr_idx, lane0, s: int):
        if lane_cache[0] is not lane0:
            lane_cache[:] = [lane0, _lane_keys(lane0, n)]
        lanes = lane_cache[1]
        node_next = ev_t.amin(dim=1)                         # (B,)
        t_next = node_next if not restart_period else \
            torch.minimum(node_next, rr_t)
        active = t_next < horizon
        t_clamp = t_next.clamp(max=horizon)
        dt = (t_clamp - now).to(torch.float32)

        hit = (ev_t == t_next[:, None]) & active[:, None]
        fail_hit = hit & up
        rec_hit = hit & ~up
        if restart_period:
            rr_hit = active & (rr_t == t_next)
            offs = (node_ids[None, :] - rr_idx[:, None]) % n  # floor-mod
            tgt = offs < wave_width
            fail_hit = fail_hit | (tgt & up & rr_hit[:, None])
            rr_idx = torch.where(rr_hit, (rr_idx + wave_width) % n, rr_idx)
            rr_t = torch.where(rr_hit, rr_t + restart_period, rr_t)
        if pair_fail_prob > 0.0:
            u2 = _uniforms(seed_mix, s, _PAIR_SALT, lanes)
            pf = fail_hit[:, perm] & up & ~fail_hit & ~rec_hit & \
                (u2 < pair_cut)
            fail_hit = fail_hit | pf
        up = (up & ~fail_hit) | rec_hit
        geo = _geometric_multi(_uniforms(seed_mix, s, _GEO_SALT, lanes),
                               geo_masks, geo_tables)
        ev_t = torch.where(fail_hit, t_clamp[:, None] + dt_vec[None, :],
                           torch.where(rec_hit, t_clamp[:, None] + geo,
                                       ev_t))
        return t_clamp, dt, active, up, ev_t, rr_t, rr_idx
    return advance


def _initial_node_state(*, B: int, n: int, seed_mix: int, geo_masks,
                        geo_tables, restart_period: int, horizon: int,
                        device):
    """(lane0, up0, ev0, rr_t0) — everyone up, first failures at
    geometric gaps drawn at step counter 0 (steps start at 1).  lane0
    (int64, values < 2^32) is each trial's first global lane id."""
    lane0 = torch.arange(B, dtype=torch.int64, device=device) * n & _MASK32
    up0 = torch.ones((B, n), dtype=torch.bool, device=device)
    ev0 = _geometric_multi(
        _uniforms(seed_mix, 0, _GEO_SALT, _lane_keys(lane0, n)),
        geo_masks, geo_tables)
    rr_t0 = torch.full((B,), restart_period if restart_period
                       else horizon + 1, dtype=torch.int32, device=device)
    return lane0, up0, ev0, rr_t0


def _pack_holders(ups):
    """(B, P, n) bool -> (B, W, P) int32 words, contiguous for the kernel."""
    return bitpack.pack_words(ups).movedim(-1, 1).contiguous()


def _initial_full_state(eval_fn, up0, succ, *, B: int, P: int, n: int,
                        rf: int, packed: bool = False):
    """t=0 'has the latest copy' mask: roster replicas full, one
    evaluation on that state, then available partitions refresh to the
    committed replica set.  Returns (full0, eval outputs).  The kernel
    therefore runs once before step 1."""
    device = up0.device
    if packed:
        masks = bitpack.to_i32(torch.tensor(bitpack.prefix_masks(rf, n),
                                            device=device))
        full0 = masks[None, :, None].expand(B, len(masks), P).contiguous()
        outs = eval_fn(_pack_holders(up0[:, succ]), full0)
        lark0, creps0 = outs[0], outs[-1]
        full0 = torch.where(lark0[:, None, :], creps0, full0)
        return full0, outs
    full0 = torch.zeros((B, P, n), dtype=torch.bool, device=device)
    full0[:, :, :rf] = True
    outs = eval_fn(up0[:, succ].reshape(B * P, n), full0.reshape(B * P, n))
    lark0, creps0 = outs[0], outs[-1]
    full0 = torch.where(lark0.reshape(B, P)[:, :, None],
                        creps0.reshape(B, P, n), full0)
    return full0, outs


# ---------------------------------------------------------------------------
# Shared engine scaffolding
# ---------------------------------------------------------------------------

def _validate_batched_args(*, devices: int, trials: int, wave_width: int,
                           n: int):
    if devices < 1:
        raise ValueError("devices must be >= 1")
    if trials % devices:
        raise ValueError(f"trials ({trials}) must divide evenly across "
                         f"devices ({devices})")
    if not 1 <= wave_width <= n:
        raise ValueError("wave_width must be in [1, n]")


def _engine_setup(*, n: int, partitions: int, seed: int, p: float,
                  downtime: int, p_node, downtime_node, max_ticks: int,
                  device):
    """(succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm, p_arr,
    dt_arr) — every deterministic per-run constant, on `device`."""
    succ = torch.as_tensor(succession_matrix_fast(partitions, range(n),
                                                  seed=seed),
                           dtype=torch.int64, device=device)
    p_arr = np.full(n, p, dtype=np.float64) if p_node is None \
        else np.asarray(p_node, dtype=np.float64)
    dt_arr = np.full(n, downtime, dtype=np.int64) if downtime_node is None \
        else np.asarray(downtime_node, dtype=np.int64)
    if p_arr.shape != (n,) or dt_arr.shape != (n,):
        raise ValueError("p_node / downtime_node must have shape (n,)")
    if not ((p_arr > 0) & (p_arr < 1)).all() or (dt_arr < 1).any():
        raise ValueError("p_node must lie in (0, 1) and downtime_node >= 1")

    seed_mix = _seed_mix(seed)
    geo_masks, geo_tables = _geo_tables(
        p_arr, max_ticks + int(dt_arr.max()) + 2, device)
    dt_vec = torch.as_tensor(dt_arr, dtype=torch.int32, device=device)
    pair_perm = np.arange(n)
    pair_perm[:n - n % 2] ^= 1
    return (succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
            p_arr, dt_arr)


def _default_max_steps(p_arr, dt_arr, *, n: int, horizon: int,
                       restart_period: int) -> int:
    """Step budget: ~3x the expected event count plus slack."""
    p_eff = float(p_arr.mean())
    per_trial = 2.0 * n * horizon / (1.0 / p_eff + float(dt_arr.mean()))
    if restart_period:
        per_trial += 2.0 * horizon / restart_period
    return int(3 * per_trial) + 2000


def _run_chunk(step, carry, s0: int, chunk_steps: int,
               trajectory: bool = True):
    """Run steps s0 .. s0+chunk_steps-1.  Returns (carry, ys) with ys the
    per-step outputs stacked to numpy (chunk_steps, B) columns, or None
    when trajectory is False."""
    ys = []
    for s in range(s0, s0 + chunk_steps):
        carry, y = step(carry, s)
        if trajectory:
            ys.append(y)
    if not trajectory:
        return carry, None
    return carry, tuple(torch.stack(col).cpu().numpy() for col in zip(*ys))


# ---------------------------------------------------------------------------
# The per-event step
# ---------------------------------------------------------------------------

def _make_step(pac_fn, succ, *, n: int, P: int, horizon: int, dt_vec,
               geo_masks, geo_tables, seed_mix: int, pair_fail_prob: float,
               pair_perm, restart_period: int, wave_width: int,
               packed: bool = False):
    advance = _make_node_advance(
        n=n, horizon=horizon, dt_vec=dt_vec, geo_masks=geo_masks,
        geo_tables=geo_tables, seed_mix=seed_mix,
        pair_fail_prob=pair_fail_prob, pair_perm=pair_perm,
        restart_period=restart_period, wave_width=wave_width)

    def step(carry, s: int):
        (now, up, ev_t, full, dnl, dnm, lpt, mpt, le, me, rr_t, rr_idx,
         lane0) = carry
        B = up.shape[0]
        t_clamp, dt, active, up, ev_t, rr_t, rr_idx = advance(
            now, up, ev_t, rr_t, rr_idx, lane0, s)
        # two eager ops each: no FMA (invariant 8)
        lpt = lpt + dnl.sum(dim=1).to(torch.float32) * dt
        mpt = mpt + dnm.sum(dim=1).to(torch.float32) * dt
        now = t_clamp

        ups = up[:, succ]                                    # (B, P, n)
        if packed:
            lark, maj, crepsw = pac_fn(_pack_holders(ups), full)
            full = torch.where(lark[:, None, :], crepsw, full)
        else:
            lark, maj, creps = pac_fn(ups.reshape(B * P, n),
                                      full.reshape(B * P, n))
            lark = lark.reshape(B, P)
            maj = maj.reshape(B, P)
            full = torch.where(lark[:, :, None], creps.reshape(B, P, n),
                               full)
        # outage events are per-partition down-transitions
        le = le + (~dnl & ~lark).sum(dim=1).to(torch.int32)
        me = me + (~dnm & ~maj).sum(dim=1).to(torch.int32)
        dnl = ~lark
        dnm = ~maj
        new_unl = dnl.sum(dim=1).to(torch.int32)
        new_unm = dnm.sum(dim=1).to(torch.int32)
        nodes_up = up.sum(dim=1).to(torch.int32)
        carry = (now, up, ev_t, full, dnl, dnm, lpt, mpt, le, me,
                 rr_t, rr_idx, lane0)
        return carry, (t_clamp, new_unl, new_unm, nodes_up)
    return step


# ---------------------------------------------------------------------------
# Carry exchange with the reference engine
# ---------------------------------------------------------------------------

#: carry slots: (now, up, ev_t, full, dnl, dnm, lpt, mpt, le, me, rr_t,
#: rr_idx, lane0)
_FULL, _LANE0 = 3, 12


def carry_from_numpy(carry, device="cpu"):
    """The reference engine's carry (a 13-tuple of numpy arrays) as the
    port's tensors on `device`.  Packed holder words (uint32) are
    reinterpreted as int32 with ``.view``; lane0 (uint32 lane ids) becomes
    int64 of the same value."""
    dev = torch.device(device)
    out = []
    for i, a in enumerate(carry):
        a = np.asarray(a)
        if i == _LANE0:
            a = a.astype(np.int64)
        elif a.dtype == np.uint32:
            a = np.ascontiguousarray(a).view(np.int32)
        out.append(torch.from_numpy(np.array(a)).to(dev))
    return tuple(out)


def carry_to_numpy(carry):
    """The port's carry as the reference engine's numpy arrays (int32
    holder words viewed back as uint32, lane0 as uint32)."""
    out = []
    for i, t in enumerate(carry):
        a = t.detach().cpu().numpy()
        if i == _LANE0:
            a = a.astype(np.uint32)
        elif i == _FULL and a.dtype == np.int32:
            a = a.view(np.uint32)
        out.append(a)
    return tuple(out)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def simulate_availability_batched(
        *, n: int = 155, partitions: int = 4096, rf: int = 2,
        p: float = 1e-3, downtime: int = 10, trials: int = 8,
        min_ticks: int = 50_000, max_ticks: int = 3_000_000,
        eps_abs: float = 5e-6, eps_rel: float = 0.05,
        min_events: int = 200, seed: int = 0,
        pair_fail_prob: float = 0.0, restart_period: int = 0,
        wave_width: int = 1, p_node=None, downtime_node=None,
        devices: int = 1, chunk_steps: int = 512,
        max_steps: Optional[int] = None, trajectory: bool = False,
        voters: Optional[int] = None, packed: bool = False,
        device=None) -> BatchedAvailabilityResult:
    """Batched Monte Carlo over `trials` trajectories sharing one
    succession matrix (seeded); failure randomness is independent per
    trial.  Same knobs and results as the reference engine.

    device: ``None`` runs on ``cuda`` (and raises without a card);
    ``"cpu"`` runs the plain PyTorch kernels.  devices > 1 is the
    reference's trials-sharding request: it is validated (trials must
    divide) and the trials run as one batch on `device`, bit-identical
    to the sharded run.

    voters overrides the baseline quorum size (default 2*(rf-1)+1).
    packed=True carries the holder masks as (B, W, P) int32 words and
    evaluates with ``fused_pac_eval`` — layout only, trajectories
    bit-identical to packed=False.
    """
    _validate_batched_args(devices=devices, trials=trials,
                           wave_width=wave_width, n=n)
    dev = resolve_device(device)
    B, P, horizon = trials, partitions, max_ticks
    voters = voters if voters is not None else 2 * (rf - 1) + 1
    if not 1 <= voters <= n:
        raise ValueError("voters must be in [1, n]")
    (succ, seed_mix, geo_masks, geo_tables, dt_vec, pair_perm,
     p_arr, dt_arr) = _engine_setup(
        n=n, partitions=P, seed=seed, p=p, downtime=downtime,
        p_node=p_node, downtime_node=downtime_node, max_ticks=max_ticks,
        device=dev)
    spec = StepSpec(metric="availability", rf=rf, voters=voters, n_real=n,
                    packed=packed)

    def pac_fn(u, f):
        o = step_eval(spec, u, f)
        return o.lark, o.maj, o.creps

    step = _make_step(pac_fn, succ, n=n, P=P, horizon=horizon,
                      dt_vec=dt_vec, geo_masks=geo_masks,
                      geo_tables=geo_tables, seed_mix=seed_mix,
                      pair_fail_prob=pair_fail_prob, pair_perm=pair_perm,
                      restart_period=restart_period, wave_width=wave_width,
                      packed=packed)

    lane0, up0, ev0, rr_t0 = _initial_node_state(
        B=B, n=n, seed_mix=seed_mix, geo_masks=geo_masks,
        geo_tables=geo_tables, restart_period=restart_period,
        horizon=horizon, device=dev)
    full0, (lark0, maj0, _creps0) = _initial_full_state(
        pac_fn, up0, succ, B=B, P=P, n=n, rf=rf, packed=packed)
    zi = torch.zeros((B,), dtype=torch.int32, device=dev)
    zf = torch.zeros((B,), dtype=torch.float32, device=dev)
    carry = (zi, up0, ev0, full0,
             ~lark0.reshape(B, P),                 # dnl (per-partition)
             ~maj0.reshape(B, P),                  # dnm
             zf, zf, zi, zi, rr_t0, zi, lane0)

    if max_steps is None:
        max_steps = _default_max_steps(p_arr, dt_arr, n=n, horizon=horizon,
                                       restart_period=restart_period)

    lpt_tot = np.zeros(B)
    mpt_tot = np.zeros(B)
    le_tot = me_tot = 0
    traj = [] if trajectory else None
    stopped = False
    s0 = 1
    while s0 < max_steps:
        carry, ys = _run_chunk(step, carry, s0, chunk_steps, trajectory)
        s0 += chunk_steps
        if trajectory:
            traj.append(ys)
        # drain per-chunk accumulators into float64/int totals
        now = carry[0].cpu().numpy().astype(np.int64)
        lpt_tot += carry[6].cpu().numpy().astype(np.float64)
        mpt_tot += carry[7].cpu().numpy().astype(np.float64)
        le_tot += int(carry[8].cpu().numpy().sum())
        me_tot += int(carry[9].cpu().numpy().sum())
        carry = carry[:6] + (zf, zf, zi, zi) + carry[10:]
        if (now >= horizon).all():
            break
        # pooled CI early stop (nominal binomial width), as the reference
        if now.mean() >= min_ticks and le_tot >= min_events \
                and me_tot >= min_events:
            pt = float(P) * float(now.sum())
            u_l, u_m = lpt_tot.sum() / pt, mpt_tot.sum() / pt
            hw_l = 1.96 * math.sqrt(max(u_l * (1 - u_l), 1e-30) / pt)
            hw_m = 1.96 * math.sqrt(max(u_m * (1 - u_m), 1e-30) / pt)
            if hw_l <= max(eps_abs, eps_rel * u_l) and \
                    hw_m <= max(eps_abs, eps_rel * u_m):
                stopped = True
                break

    now = np.maximum(carry[0].cpu().numpy().astype(np.int64), 1)
    pt_b = P * now.astype(np.float64)
    pt = float(pt_b.sum())
    u_l = float(lpt_tot.sum()) / pt
    u_m = float(mpt_tot.sum()) / pt
    u_l_trials = lpt_tot / pt_b
    u_m_trials = mpt_tot / pt_b
    # honest CI from the spread of independent trials, floored by the
    # pooled binomial width for tiny batches
    hw_l = hw_m = 0.0
    if B >= 3:
        t = t975(B - 1) / math.sqrt(B)
        hw_l = t * float(u_l_trials.std(ddof=1))
        hw_m = t * float(u_m_trials.std(ddof=1))
    traj_out = None
    if trajectory:
        cols = [np.concatenate([c[i] for c in traj]) for i in range(4)]
        traj_out = {"times": cols[0], "unavail_lark": cols[1],
                    "unavail_maj": cols[2], "nodes_up": cols[3]}
    return BatchedAvailabilityResult(
        p=p, rf=rf, n=n, partitions=P, trials=B, device=str(dev),
        ticks=int(now.mean()), u_lark=u_l, u_maj=u_m,
        lark_events=le_tot, maj_events=me_tot,
        ci_lark=max(hw_l,
                    1.96 * math.sqrt(max(u_l * (1 - u_l), 1e-30) / pt)),
        ci_maj=max(hw_m,
                   1.96 * math.sqrt(max(u_m * (1 - u_m), 1e-30) / pt)),
        stopped_early=stopped, devices=devices,
        u_lark_trials=u_l_trials, u_maj_trials=u_m_trials,
        trajectory=traj_out)
