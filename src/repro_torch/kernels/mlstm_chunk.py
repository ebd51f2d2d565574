"""The chunkwise mLSTM forward (xLSTM matrix memory): the CUDA kernel
``mlstm_chunkwise`` beside its plain PyTorch version, and the one-step
recurrence ``mlstm_step_plain`` that decode uses.

* ``mlstm_chunkwise`` replaces ``repro/kernels/mlstm_chunk.py:
  mlstm_chunkwise`` (Pallas body ``_mlstm_kernel``).  It follows the
  oracle ``repro/kernels/ref.py: mlstm_chunkwise`` where the Pallas
  wrapper falls short: any S (the ragged tail counts as padding with
  f = 1 and i = 0), an optional ``initial`` (C, n, m), and the final
  state taken from the kernel's own carry.  Bound by bytes: at the
  xlstm-350m serve shape (B = 4, H = 4, S = 1024, Dq = Dv = 512,
  chunk 256, bf16) a call moves 84 MB and needs 21.5 GFLOP (the causal
  half of each chunk's L x L block).  Two CUDA sources compute it;
  ``_route`` picks one from the dtype, the head dims and the chunk alone:

  - ``sm90`` (csrc/mlstm_chunk_sm90.cu): bf16 with Dq and Dv multiples of
    64 in [64, 512] and a chunk that is a multiple of 64, whose kernels
    fit a block's shared memory (``sm90_smem_bytes``; at Dq = 512 a chunk
    up to 448).  bf16 wgmma on TMA-fed tiles; the gated keys, the
    chunk-start states and the gated scores stay float32 through hi/lo
    splits into two bf16 products.  The bounds are the kernel's tiles:
    64-row panels and 64-position slabs, and the q rows of one block
    (128 x Dq bf16) beside a 96 KB ring in shared memory, which caps Dq
    at 512.
  - ``simt`` (csrc/mlstm_chunk.cu): float32, and every other shape whose
    (Dq, 64) slice of C fits a block's shared memory.  Float32 on the
    CUDA cores.

  ``mlstm_check`` holds both against the plain version.
* ``mlstm_chunkwise_bwd`` is its gradient for ``initial=None``, beside
  ``mlstm_chunkwise_bwd_plain``; the reference has no backward kernel
  (its training differentiates the oracle).  See
  ``mlstm_chunkwise_bwd_plain`` for the math.  Two CUDA sources, chosen
  by ``bwd_route``: the forward's sm90 predicate and the backward's own
  shared memory take csrc/mlstm_chunk_bwd_sm90.cu (bf16 wgmma on TMA-fed
  tiles, every float32 operand split hi/lo), the rest
  csrc/mlstm_chunk_bwd.cu (SIMT, float32 on the CUDA cores).
* ``mlstm_chunkwise`` is a ``torch.autograd.Function`` when no initial
  state is given: its forward saves q, k, v, log_f and log_i, its
  backward launches the backward kernel, and the final (C, n, m) is not
  differentiable.  ``mlstm_chunkwise_reference`` is the same Function
  over the plain versions on any device, which checks on the card
  compare the kernels with.
* ``mlstm_step_plain`` is ``ref.py: mlstm_step``; the reference has no
  kernel for it, and neither has the port.

Dispatch follows the tensor: a CUDA tensor launches the kernel of its
route (or raises), a CPU tensor runs the plain version.  There is no
fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

NEG = -1e30

#: the kernel's output tile (rows and columns), and the shared memory one
#: block of it may use on Hopper (bytes)
TILE = 64
SMEM_LIMIT = 232448


#: the sm90 kernels' tiles: rows of q per output block, the slots of the
#: output kernel's ring (bytes) and of the states kernel's; and the static
#: shared memory (mbarriers) beside the dynamic
SM90_ROWS = 128
SM90_OUT_RING = 3 * 32768
SM90_STATE_STAGES = 4
SM90_STATIC = 64


def sm90_smem_bytes(Dq: int, Dv: int, chunk: int) -> int:
    """Dynamic shared memory of csrc/mlstm_chunk_sm90.cu's larger kernel:
    the output kernel's q rows (128 x Dq bf16), ring and the chunk's g
    (chunk floats), or the states kernel's ring of k (64 positions x 128
    d) and v (64 x NV) slabs and two chunks' wv; each with 1024 bytes to
    align the swizzled tiles.  NV = 256, 128 or 64 as Dv divides."""
    nv = 256 if Dv % 256 == 0 else 128 if Dv % 128 == 0 else 64
    out = Dq // 64 * SM90_ROWS * 128 + SM90_OUT_RING + 4 * chunk + 1024
    states = SM90_STATE_STAGES * (2 + nv // 64) * 64 * 128 + 8 * chunk + \
        1024
    return max(out, states)


def columns_smem_bytes(Dq: int, chunk: int) -> int:
    """Shared memory of csrc/mlstm_chunk.cu's column kernel: its (Dq, 64)
    slice of C and n (Dq rounded up to 64), a 64 x 65 and a 64 x 64
    staged tile, two row vectors and the chunk's carry weights."""
    DqP = -(-Dq // TILE) * TILE
    return 4 * (DqP * TILE + DqP + TILE * 65 + TILE * TILE + 2 * TILE + chunk)


def _f32(*xs):
    return tuple(x.to(torch.float32) for x in xs)


def mlstm_chunkwise_plain(q, k, v, log_f, log_i, *, chunk: int = 256,
                          initial=None):
    """Chunk-parallel mLSTM forward, the math of ``ref.mlstm_chunkwise``.

    q, k (B, H, S, Dq), v (B, H, S, Dv); log_f, log_i (B, H, S) log-space
    gates.  Returns (h (B, H, S, Dv) in q's dtype, (C (B, H, Dq, Dv),
    n (B, H, Dq), m (B, H)) float32 final state)."""
    mlstm_chunkwise_plain.calls += 1
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    dev = q.device
    pad = (-S) % chunk
    if pad:
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                   for a in (q, k, v))
        log_f = torch.nn.functional.pad(log_f, (0, pad))            # f = 1
        log_i = torch.nn.functional.pad(log_i, (0, pad), value=NEG)  # i = 0
    nC = (S + pad) // chunk

    if initial is None:
        initial = (torch.zeros((B, H, Dq, Dv), dtype=torch.float32,
                               device=dev),
                   torch.zeros((B, H, Dq), dtype=torch.float32, device=dev),
                   torch.full((B, H), NEG, dtype=torch.float32, device=dev))
    C, n, m = _f32(*initial)

    scale = 1.0 / math.sqrt(Dq)
    lpos = torch.arange(chunk, device=dev)
    causal = lpos[:, None] >= lpos[None, :]
    hs = []
    for c in range(nC):
        sl = slice(c * chunk, (c + 1) * chunk)
        qi, ki, vi = _f32(q[:, :, sl], k[:, :, sl], v[:, :, sl])
        lf, li = _f32(log_f[:, :, sl], log_i[:, :, sl])
        F = torch.cumsum(lf, dim=-1)                             # inclusive
        g = li - F
        Mt = torch.maximum(m[..., None], torch.cummax(g, dim=-1).values)
        m_t = F + Mt
        # inter-chunk (carry) contribution
        qCf = torch.einsum("bhld,bhdv->bhlv", qi, C) * scale
        qnf = torch.einsum("bhld,bhd->bhl", qi, n) * scale
        w_carry = torch.exp(m[..., None] - Mt)
        # intra-chunk
        sc = torch.einsum("bhld,bhsd->bhls", qi, ki) * scale
        D = torch.where(causal, torch.exp(g[:, :, None, :] - Mt[..., None]),
                        0.0)
        W = sc * D
        num = w_carry[..., None] * qCf + torch.einsum("bhls,bhsv->bhlv", W,
                                                      vi)
        den = w_carry * qnf + W.sum(dim=-1)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # carry update
        ML = Mt[..., -1]
        FL = F[..., -1]
        wv = torch.exp(g - ML[..., None])
        decay = torch.exp(m - ML)
        C = decay[..., None, None] * C + \
            torch.einsum("bhld,bhlv->bhdv", wv[..., None] * ki, vi)
        n = decay[..., None] * n + (wv[..., None] * ki).sum(dim=-2)
        m = FL + ML
    h = torch.cat(hs, dim=2)[:, :, :S]
    return h.to(q.dtype), (C, n, m)


#: calls of the plain version since the last reset, on any device (a run
#: on the card that must go through the kernel reads 0 here)
mlstm_chunkwise_plain.calls = 0


def mlstm_step_plain(q, k, v, log_f, log_i, state):
    """One decode step, the math of ``ref.mlstm_step``.  q, k, v
    (B, H, D*); log_f, log_i (B, H); state (C, n, m) float32."""
    C, n, m = state
    Dq = q.shape[-1]
    scale = 1.0 / math.sqrt(Dq)
    qf, kf, vf = _f32(q, k, v)
    m_new = torch.maximum(log_f + m, log_i)
    wf = torch.exp(log_f + m - m_new)
    wi = torch.exp(log_i - m_new)
    C_new = wf[..., None, None] * C + \
        wi[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n_new = wf[..., None] * n + wi[..., None] * kf
    num = torch.einsum("bhd,bhdv->bhv", qf, C_new) * scale
    den = torch.einsum("bhd,bhd->bh", qf, n_new) * scale
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C_new, n_new, m_new)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

#: csrc/mlstm_chunk.cu: mlstm_chunk_launch
_ARGTYPES = (ctypes.c_void_p,) * 17 + (ctypes.c_int,) * 6 + \
    (ctypes.c_void_p,)
#: csrc/mlstm_chunk_sm90.cu: mlstm_chunk_sm90_launch
_ARGTYPES_SM90 = (ctypes.c_void_p,) * 19 + (ctypes.c_int,) * 6 + \
    (ctypes.c_void_p,)
#: route: (source, C symbol, argtypes)
ROUTES = {"sm90": ("mlstm_chunk_sm90", "mlstm_chunk_sm90_launch",
                   _ARGTYPES_SM90),
          "simt": ("mlstm_chunk", "mlstm_chunk_launch", _ARGTYPES)}
#: the sm90 kernels' parts (``launch_args``' `parts`): the stabilizer
#: chain, the chunk-start states, h; all three are the function
PARTS = {"gates": 1, "states": 2, "output": 4}


def _route(dtype, Dq: int, Dv: int, chunk: int) -> str:
    """The CUDA source that computes the forward on these inputs, from the
    dtype, the head dims and the chunk alone: "sm90" for bf16 with Dq and
    Dv multiples of 64 in [64, 512] and chunk a multiple of 64 whose
    kernels fit a block's shared memory, else "simt"."""
    if dtype == torch.bfloat16 and chunk % 64 == 0 and chunk >= 64 and \
            all(d % 64 == 0 and 64 <= d <= 512 for d in (Dq, Dv)) and \
            sm90_smem_bytes(Dq, Dv, chunk) + SM90_STATIC <= SMEM_LIMIT:
        return "sm90"
    return "simt"


def _check(q, k, v, log_f, log_i, chunk, initial):
    B, H, S, Dq = q.shape if q.dim() == 4 else (None,) * 4
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or \
            v.shape[:3] != q.shape[:3]:
        raise ValueError(f"mlstm_chunkwise takes q, k (B, H, S, Dq) and v "
                         f"(B, H, S, Dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if log_f.shape != (B, H, S) or log_i.shape != (B, H, S):
        raise ValueError(f"log_f and log_i must be {(B, H, S)}; got "
                         f"{tuple(log_f.shape)}, {tuple(log_i.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in (torch.float32, torch.bfloat16, torch.float64) \
            or (q.dtype == torch.float64 and q.device.type == "cuda"):
        raise TypeError(f"q, k, v must share one dtype, float32 or "
                        f"bfloat16 (float64 too on the CPU); got {q.dtype}, "
                        f"{k.dtype}, {v.dtype} on {q.device}")
    if S < 1 or chunk < 1:
        raise ValueError(f"need S >= 1 and chunk >= 1; got S={S}, "
                         f"chunk={chunk}")
    tensors = [k, v, log_f, log_i]
    if initial is not None:
        C0, n0, m0 = initial
        Dv = v.shape[-1]
        if C0.shape != (B, H, Dq, Dv) or n0.shape != (B, H, Dq) or \
                m0.shape != (B, H):
            raise ValueError(f"initial (C, n, m) must be {(B, H, Dq, Dv)}, "
                             f"{(B, H, Dq)}, {(B, H)}; got "
                             f"{tuple(C0.shape)}, {tuple(n0.shape)}, "
                             f"{tuple(m0.shape)}")
        tensors += [C0, n0, m0]
    if any(t.device != q.device for t in tensors):
        raise ValueError("mlstm_chunkwise takes all its tensors on one "
                         "device")


def mlstm_chunkwise(q, k, v, log_f, log_i, *, chunk: int = 256,
                    initial=None):
    """q, k (B, H, S, Dq), v (B, H, S, Dv) float32 or bfloat16; log_f,
    log_i (B, H, S); optional initial (C, n, m).  Returns (h, (C, n, m))
    as ``mlstm_chunkwise_plain``.  CUDA tensors launch the kernel of
    ``_route`` (``mlstm_chunkwise.launches`` counts all launches,
    ``.sm90_launches`` and ``.simt_launches`` each route's); CPU and meta
    tensors run the plain version.  Without `initial`, h is differentiable in q,
    k, v, log_f and log_i (backwards ``mlstm_chunkwise_bwd``); with it,
    nothing is."""
    _check(q, k, v, log_f, log_i, chunk, initial)
    if q.device.type not in ("cuda",) + _build.PLAIN_DEVICES:
        raise ValueError(f"mlstm_chunkwise runs on cuda, cpu or meta, not "
                         f"{q.device}")
    plain = q.device.type in _build.PLAIN_DEVICES
    if initial is None:
        h, C, n, m = _MlstmChunkwise.apply(q, k, v, log_f, log_i, chunk,
                                           plain)
        return h, (C, n, m)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, log_f, log_i, *initial)):
        raise NotImplementedError("mlstm_chunkwise has no gradient with an "
                                  "initial state")
    if plain:
        return mlstm_chunkwise_plain(q, k, v, log_f, log_i, chunk=chunk,
                                     initial=initial)
    return _forward_kernel(q, k, v, log_f, log_i, chunk, initial)


def mlstm_chunkwise_reference(q, k, v, log_f, log_i, *, chunk: int = 256):
    """``mlstm_chunkwise`` without an initial state over the plain forward
    and backward on any device: what checks on the card hold the kernels'
    gradients against."""
    _check(q, k, v, log_f, log_i, chunk, None)
    h, C, n, m = _MlstmChunkwise.apply(q, k, v, log_f, log_i, chunk, True)
    return h, (C, n, m)


class _MlstmChunkwise(torch.autograd.Function):
    """(h, C, n, m) = mlstm_chunkwise(q, k, v, log_f, log_i) from a zero
    state, with the gradient of h: the kernels on the card, the plain
    versions on the CPU or when `plain` is set."""

    @staticmethod
    def forward(ctx, q, k, v, log_f, log_i, chunk, plain):
        if plain:
            h, (C, n, m) = mlstm_chunkwise_plain(q, k, v, log_f, log_i,
                                                 chunk=chunk)
        else:
            h, (C, n, m) = _forward_kernel(q, k, v, log_f, log_i, chunk,
                                           None)
        ctx.mark_non_differentiable(C, n, m)
        ctx.save_for_backward(q, k, v, log_f, log_i)
        ctx.chunk, ctx.plain = chunk, plain
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, log_f, log_i = ctx.saved_tensors
        bwd = mlstm_chunkwise_bwd_plain if ctx.plain else mlstm_chunkwise_bwd
        dq, dk, dv, dlf, dli = bwd(q, k, v, log_f, log_i, dh,
                                   chunk=ctx.chunk)
        return dq, dk, dv, dlf.to(log_f.dtype), dli.to(log_i.dtype), \
            None, None


def _forward_kernel(q, k, v, log_f, log_i, chunk, initial):
    route = _route(q.dtype, q.shape[3], v.shape[3], chunk)
    launch = _build.function(*ROUTES[route])
    out = launch_with(launch, q, k, v, log_f, log_i, chunk, initial,
                      route=route)
    mlstm_chunkwise.launches += 1
    if route == "sm90":
        mlstm_chunkwise.sm90_launches += 1
    else:
        mlstm_chunkwise.simt_launches += 1
    return out


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def _bwd_chunks(q, k, v, log_f, log_i, dh, chunk):
    """The forward's per-chunk quantities for the backward, in the
    working type (float64 when an input is, else float32), padded to
    whole chunks: a list of dicts with the chunk's q, k, v, dh, D (the
    stabilized causal weights exp(g_s - M_t)), w_carry, wv, decay, m_t
    and the chunk-start state C, n (zero for the first chunk)."""
    dt = torch.float64 if any(t.dtype == torch.float64 for t in
                              (q, k, v, log_f, log_i, dh)) else torch.float32
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    dev = q.device
    pad = (-S) % chunk
    q, k, v, dh = (a.to(dt) for a in (q, k, v, dh))
    log_f, log_i = log_f.to(dt), log_i.to(dt)
    if pad:
        q, k, v, dh = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                       for a in (q, k, v, dh))
        log_f = torch.nn.functional.pad(log_f, (0, pad))
        log_i = torch.nn.functional.pad(log_i, (0, pad), value=NEG)
    nC = (S + pad) // chunk
    C = torch.zeros((B, H, Dq, Dv), dtype=dt, device=dev)
    n = torch.zeros((B, H, Dq), dtype=dt, device=dev)
    m = torch.full((B, H), NEG, dtype=dt, device=dev)
    lpos = torch.arange(chunk, device=dev)
    causal = lpos[:, None] >= lpos[None, :]
    out = []
    for c in range(nC):
        sl = slice(c * chunk, (c + 1) * chunk)
        lf, li = log_f[:, :, sl], log_i[:, :, sl]
        F = torch.cumsum(lf, dim=-1)
        g = li - F
        Mt = torch.maximum(m[..., None], torch.cummax(g, dim=-1).values)
        ML = Mt[..., -1]
        wv = torch.exp(g - ML[..., None])
        decay = torch.exp(m - ML)
        ch = {"q": q[:, :, sl], "k": k[:, :, sl], "v": v[:, :, sl],
              "dh": dh[:, :, sl], "m_t": F + Mt, "C": C, "n": n,
              "w_carry": torch.exp(m[..., None] - Mt),
              "D": torch.where(causal, torch.exp(g[:, :, None, :] -
                                                 Mt[..., None]), 0.0),
              "wv": wv, "decay": decay}
        out.append(ch)
        C = decay[..., None, None] * C + torch.einsum(
            "bhld,bhlv->bhdv", wv[..., None] * ch["k"], ch["v"])
        n = decay[..., None] * n + (wv[..., None] * ch["k"]).sum(dim=-2)
        m = F[..., -1] + ML
    return out


def _bwd_sums(ch, scale):
    """A chunk's recomputed stabilized den_t and dh_t.num_t."""
    q, k, v, dh, D, wc = (ch[n] for n in ("q", "k", "v", "dh", "D",
                                          "w_carry"))
    DS = D * torch.einsum("bhld,bhsd->bhls", q, k) * scale
    num = wc[..., None] * scale * torch.einsum("bhld,bhdv->bhlv", q,
                                               ch["C"]) + \
        torch.einsum("bhls,bhsv->bhlv", DS, v)
    den = wc * scale * torch.einsum("bhld,bhd->bhl", q, ch["n"]) + \
        DS.sum(dim=-1)
    return den, (dh * num).sum(dim=-1)


def _bwd_rows(ch, scale):
    """A chunk's row scalars: 1 / max(|den_t|, e^{-m_t}) and the gradient
    dd_t of the loss with respect to the stabilized den_t, both from the
    recomputed stabilized num and den.  dd is taken where |den_t| >
    e^{-m_t} and is 0 where the clamp holds, ties included."""
    den, dhnum = _bwd_sums(ch, scale)
    clamp = torch.exp(-ch["m_t"])
    active = den.abs() > clamp
    inv = 1.0 / torch.maximum(den.abs(), clamp)
    dd = torch.where(active, -torch.sign(den) * dhnum * inv * inv, 0.0)
    return inv, dd


def _bwd_apply(chunks, rows, scale):
    """The reverse chunk loop, linear in the chunks' q, k, v, dh and the
    rows' (inv, dd): returns per chunk (dq, dk, dv, R = q.dq, Li = k.dk)
    in the working type.  G and dn carry the gradient of the stabilized
    chunk-start state C, n backwards with the forward's decay."""
    G = torch.zeros_like(chunks[-1]["C"])
    dn = torch.zeros_like(chunks[-1]["n"])
    out = [None] * len(chunks)
    for c in range(len(chunks) - 1, -1, -1):
        ch = chunks[c]
        inv, dd = rows[c]
        q, k, v, dh, D, wc, wv = (ch[n] for n in ("q", "k", "v", "dh", "D",
                                                  "w_carry", "wv"))
        delta = dh * inv[..., None]
        Dsc = D * scale
        coef = Dsc * (torch.einsum("bhtv,bhsv->bhts", delta, v) +
                      dd[..., None])
        P = Dsc * torch.einsum("bhtd,bhsd->bhts", q, k)
        wcs = (wc * scale)[..., None]
        dq = torch.einsum("bhts,bhsd->bhtd", coef, k) + wcs * (
            torch.einsum("bhtv,bhdv->bhtd", delta, ch["C"]) +
            dd[..., None] * ch["n"][:, :, None, :])
        dk = torch.einsum("bhts,bhtd->bhsd", coef, q) + wv[..., None] * (
            torch.einsum("bhsv,bhdv->bhsd", v, G) + dn[:, :, None, :])
        dv = torch.einsum("bhts,bhtv->bhsv", P, delta) + wv[..., None] * \
            torch.einsum("bhsd,bhdv->bhsv", k, G)
        out[c] = (dq, dk, dv, (q * dq).sum(-1), (k * dk).sum(-1))
        G = ch["decay"][..., None, None] * G + torch.einsum(
            "bhtd,bhtv->bhdv", wcs * q, delta)
        dn = ch["decay"][..., None] * dn + torch.einsum(
            "bhtd,bht->bhd", wcs * q, dd)
    return out


def _bwd_gates(R, Li):
    """dlog_f_r = sum over t >= r of (R_t - Li_t) (the pairs s < r <= t),
    dlog_i = Li; R, Li (B, H, S)."""
    return torch.flip(torch.cumsum(torch.flip(R - Li, [-1]), -1), [-1]), Li


def mlstm_chunkwise_bwd_plain(q, k, v, log_f, log_i, dh, *,
                              chunk: int = 256):
    """The gradient of h = mlstm_chunkwise(q, k, v, log_f, log_i) (zero
    initial state) given dh (B, H, S, Dv): an explicit reverse chunk loop,
    the function csrc/mlstm_chunk_bwd.cu computes.  Returns (dq, dk, dv in
    q's dtype, dlog_f, dlog_i float32), float64 throughout when an input
    is float64.

    The stabilizer cancels out of h: with w_ts = exp(li_s + sum_{s<r<=t}
    lf_r), num_t = sum_{s<=t} w_ts scale (q_t.k_s) v_s and den_t the same
    sum over 1, h_t = num_t / max(|den_t|, 1).  Both of the reference's
    branches, max(|den|, exp(-m_t)) on the stabilized sums, divide num
    and den by e^{m_t}, so h does not depend on m, and the gradients that
    the reference's autodiff takes through m (the cummax and max of the
    stabilizer chain) sum to zero analytically and to rounding
    numerically.  This function differentiates the unstabilized form and
    uses m only to keep exponentials in range: with delta_t = dh_t /
    max(|den_t|, e^{-m_t}) and dd_t the gradient of the stabilized den_t,
    and the per-pair terms P_ts = D_ts scale (q_t.k_s)(v_s.delta_t +
    dd_t), dlog_i_s = sum_t P_ts = k_s.dk_s and dlog_f_r = sum_{t>=r}
    sum_{s<r} P_ts = sum_{t>=r} (q_t.dq_t - k_t.dk_t).  Where |den_t|
    equals e^{-m_t} the whole gradient goes to the clamp (dd_t = 0);
    JAX's maximum splits it 0.5 / 0.5 there."""
    mlstm_chunkwise_bwd_plain.calls += 1
    B, H, S, Dq = q.shape
    scale = 1.0 / math.sqrt(Dq)
    chunks = _bwd_chunks(q, k, v, log_f, log_i, dh, chunk)
    rows = [_bwd_rows(ch, scale) for ch in chunks]
    parts = _bwd_apply(chunks, rows, scale)
    dq, dk, dv, R, Li = (torch.cat([p[i] for p in parts], dim=2)[:, :, :S]
                         for i in range(5))
    dlf, dli = _bwd_gates(R, Li)
    gate_dt = torch.float64 if dlf.dtype == torch.float64 else torch.float32
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), \
        dlf.to(gate_dt), dli.to(gate_dt)


mlstm_chunkwise_bwd_plain.calls = 0

#: the backward kernel's tiles: 64 x 64 outputs, 32-deep slabs padded to
#: 65 columns, and per block one (64, chunk rounded up to 64, + 1) float32
#: buffer (the rows kernel) or two (the columns kernel)
BWD_TILE, BWD_SLAB, BWD_PAD = 64, 32, 65


def bwd_smem_bytes(chunk: int) -> int:
    """Dynamic shared memory of csrc/mlstm_chunk_bwd.cu's larger kernel
    (the columns kernel) at this chunk."""
    Lp = -(-chunk // BWD_TILE) * BWD_TILE
    return 4 * (2 * BWD_SLAB * BWD_PAD + 2 * BWD_TILE * (Lp + 1))


def _tile_of(n: int) -> int:
    """The column tile of an sm90 backward product with n columns: 256
    where it divides n, else 64 (csrc/mlstm_chunk_bwd_sm90.cu's
    tile_of)."""
    return 256 if n % 256 == 0 else 64


#: the sm90 backward's rings: slots of its GEMM kernels and of its walks
BWD_SM90_STAGES, BWD_SM90_WALK_STAGES = 2, 4


def bwd_sm90_smem_bytes(Dq: int, Dv: int, chunk: int) -> int:
    """Dynamic shared memory of csrc/mlstm_chunk_bwd_sm90.cu's larger
    kernel: a walk's ring of X (64 positions x 128 d) and Y (64 x NV)
    slabs and two chunks' coefficients (a and b, chunk floats each), or a
    GEMM kernel's two slots of 128 x 64 A tiles (two with hi and lo) and
    an NT x 64 B tile (two with hi and lo), NT 256 where it divides the
    columns, else 64; each with 1024 bytes to align the swizzled
    tiles."""
    nv = _tile_of(Dv)
    walk = BWD_SM90_WALK_STAGES * (2 + nv // 64) * 64 * 128 + 1024 + \
        16 * chunk
    nt = max(_tile_of(Dq), _tile_of(Dv))
    tile = 128 * 128
    gemm = BWD_SM90_STAGES * max(tile + 2 * nt * 128, 2 * tile + nt * 128) \
        + 1024
    return max(walk, gemm)


def bwd_sm90_workspace_bytes(BH: int, S: int, Dq: int, Dv: int,
                             chunk: int) -> int:
    """Scratch bytes of one sm90 backward call, carved in the order of
    csrc/mlstm_chunk_bwd_sm90.cu's ``carve`` (each region 256-byte
    aligned): per position g, M_t, m_t, wv, the dstates walk's two row
    weights, inv and dd; M_L and the m chain; C_c and G_{c+1} as bf16 hi
    and lo, n_c and dn_{c+1}; S, dP (chunk x chunk a chunk) and C_c dh
    (chunk x Dq) in float32; the weights Wk, Wk^T and Wv^T as bf16 hi and
    lo; per position and Dq column tile q.dq and k.dk."""
    nC = -(-S // chunk)
    Sp, Z = nC * chunk, BH * nC
    nN = Dq // _tile_of(Dq)
    sizes = [4 * BH * Sp] * 8 + [4 * BH * nC, 4 * BH * (nC + 1)] + \
        [2 * Z * Dq * Dv] * 4 + [4 * Z * Dq] * 2 + \
        [4 * Z * chunk * chunk] * 2 + [4 * Z * chunk * Dq] + \
        [2 * Z * chunk * chunk] * 6 + [4 * BH * Sp * nN] * 2
    return sum(-(-b // 256) * 256 for b in sizes)


def bwd_route(dtype, Dq: int, Dv: int, chunk: int) -> str:
    """The CUDA source that computes the backward on these inputs: "sm90"
    where the forward's route is (``_route``: bf16, Dq and Dv multiples of
    64 in [64, 512], chunk a multiple of 64) and the sm90 backward's
    kernels fit a block's shared memory, else "simt"."""
    if _route(dtype, Dq, Dv, chunk) == "sm90" and \
            bwd_sm90_smem_bytes(Dq, Dv, chunk) + SM90_STATIC <= SMEM_LIMIT:
        return "sm90"
    return "simt"


def mlstm_chunkwise_bwd(q, k, v, log_f, log_i, dh, *, chunk: int = 256):
    """(dq, dk, dv, dlog_f, dlog_i) as ``mlstm_chunkwise_bwd_plain``: CUDA
    tensors launch the source of ``bwd_route`` (``mlstm_chunkwise_bwd.
    launches`` counts the calls, ``.sm90_launches`` and
    ``.simt_launches`` each route's), CPU and meta tensors run the plain
    version."""
    _check(q, k, v, log_f, log_i, chunk, None)
    if dh.shape != v.shape:
        raise ValueError(f"dh must be v's shape {tuple(v.shape)}; got "
                         f"{tuple(dh.shape)}")
    if q.device.type in _build.PLAIN_DEVICES:
        return mlstm_chunkwise_bwd_plain(q, k, v, log_f, log_i, dh,
                                         chunk=chunk)
    if q.device.type != "cuda" or dh.device != q.device:
        raise ValueError(f"mlstm_chunkwise_bwd runs on one cuda or cpu "
                         f"device; got {q.device}, {dh.device}")
    route = bwd_route(q.dtype, q.shape[3], v.shape[3], chunk)
    launch = _build.function(*BWD_ROUTES[route])
    args, out, _ = bwd_launch_args(q, k, v, log_f, log_i, dh, chunk,
                                   route=route)
    _build.check(launch(*args), f"mlstm_chunkwise_bwd ({route})")
    mlstm_chunkwise_bwd.launches += 1
    if route == "sm90":
        mlstm_chunkwise_bwd.sm90_launches += 1
    else:
        mlstm_chunkwise_bwd.simt_launches += 1
    return out


#: csrc/mlstm_chunk_bwd.cu: mlstm_chunk_bwd_launch
BWD_ARGTYPES = (ctypes.c_void_p,) * 25 + (ctypes.c_int,) * 6 + \
    (ctypes.c_void_p,)
#: csrc/mlstm_chunk_bwd_sm90.cu: mlstm_chunk_bwd_sm90_launch
BWD_ARGTYPES_SM90 = (ctypes.c_void_p,) * 12 + (ctypes.c_longlong,) + \
    (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
#: route: (source, C symbol, argtypes) of the backward
BWD_ROUTES = {"sm90": ("mlstm_chunk_bwd_sm90", "mlstm_chunk_bwd_sm90_launch",
                       BWD_ARGTYPES_SM90),
              "simt": ("mlstm_chunk_bwd", "mlstm_chunk_bwd_launch",
                       BWD_ARGTYPES)}


def bwd_launch_args(q, k, v, log_f, log_i, dh, chunk, *, route="simt",
                    fill=None):
    """The arguments of one call of `route`'s backward launcher
    (``BWD_ROUTES``) on checked CUDA tensors, the stream last, with the
    outputs (filled with `fill` when given) and scratch allocated.
    Returns (args, (dq, dk, dv, dlog_f, dlog_i), the tensors the pointers
    refer to)."""
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    dev = q.device
    dtype = q.dtype
    nC = -(-S // chunk)
    BH, Sp = B * H, nC * chunk
    if route == "sm90":
        if bwd_route(dtype, Dq, Dv, chunk) != "sm90":
            raise ValueError(f"the sm90 backward takes bf16 with Dq, Dv "
                             f"multiples of 64 in [64, 512] and chunk a "
                             f"multiple of 64 within its shared memory; got "
                             f"{dtype}, Dq={Dq}, Dv={Dv}, chunk={chunk}")
        # its one-dimensional grids (the launcher's check); the workspace
        # of such a call would not fit a card
        if BH * Sp >= 2 ** 31 or BH * Sp // 64 * (chunk // 64 + 8) >= 2 ** 31:
            raise ValueError(f"the sm90 backward numbers B H ceil(S / chunk) "
                             f"chunk = {BH * Sp} positions' blocks in one "
                             f"grid dimension: too many")
    elif bwd_smem_bytes(chunk) > SMEM_LIMIT:
        raise ValueError(f"the backward kernel keeps (64, chunk) float32 "
                         f"buffers in shared memory: chunk={chunk} needs "
                         f"{bwd_smem_bytes(chunk)} bytes > {SMEM_LIMIT}")
    q, k, v = (a.contiguous() for a in (q, k, v))
    dh = dh.to(dtype).contiguous()
    if route == "sm90":     # TMA reads from 16-byte aligned bases
        q, k, v, dh = (t if t.data_ptr() % 16 == 0 else t.clone()
                       for t in (q, k, v, dh))
    lf, li = (a.to(torch.float32).contiguous() for a in (log_f, log_i))

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    outs = [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            f32(B, H, S), f32(B, H, S)]
    if fill is not None:
        for t in outs:
            t.fill_(fill)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "sm90":
        nbytes = bwd_sm90_workspace_bytes(BH, S, Dq, Dv, chunk)
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        tensors = (q, k, v, lf, li, dh, *outs, work)
        args = tuple(t.data_ptr() for t in tensors) + \
            (nbytes, BH, S, Dq, Dv, chunk, stream)
        return args, tuple(outs), tensors
    # the gates (g, M_t, m_t per position; M_L per chunk; the chunk-start
    # m), the chunk-start states and their gradients, the rows' C_c dh_t,
    # and per position 1 / max(|den|, e^{-m}), dd, q.dq and k.dk
    scratch = (f32(BH, Sp), f32(BH, Sp), f32(BH, Sp), f32(BH, nC),
               f32(BH, nC + 1), f32(BH, nC, Dq, Dv), f32(BH, nC, Dq),
               f32(BH, nC, Dq, Dv), f32(BH, nC, Dq), f32(BH, Sp, Dq),
               f32(BH, Sp), f32(BH, Sp), f32(BH, Sp), f32(BH, Sp))
    tensors = (q, k, v, lf, li, dh, *outs, *scratch)
    args = tuple(t.data_ptr() for t in tensors) + \
        (BH, S, Dq, Dv, chunk, int(dtype == torch.bfloat16), stream)
    return args, tuple(outs), tensors


def launch_args(q, k, v, log_f, log_i, chunk, initial, *, route="simt",
                parts=7):
    """The arguments of one call of `route`'s C launcher (``ROUTES``) on
    checked CUDA tensors, the stream last, with the outputs and scratch
    allocated; `parts` (sm90 only) picks its kernels (``PARTS``).  Returns
    (args, (h, (C, n, m)), the tensors the pointers refer to)."""
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    dev = q.device
    q, k, v = (a.contiguous() for a in (q, k, v))
    lf, li = (a.to(torch.float32).contiguous() for a in (log_f, log_i))
    C0 = n0 = m0 = None
    if initial is not None:
        C0, n0, m0 = (a.to(torch.float32).contiguous() for a in initial)
    nC = -(-S // chunk)
    BH = B * H

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h = torch.empty((B, H, S, Dv), dtype=q.dtype, device=dev)
    C, n, m = f32(B, H, Dq, Dv), f32(B, H, Dq), f32(B, H)
    # scratch: per-position gates, the stabilizer chain
    g, Mt, mt = f32(BH, nC * chunk), f32(BH, nC * chunk), f32(BH, nC * chunk)
    mchain = f32(BH, nC + 1)
    if route == "sm90":
        if _route(q.dtype, Dq, Dv, chunk) != "sm90" or \
                BH * nC * -(-chunk // SM90_ROWS) * Dv // 64 >= 2 ** 31:
            raise ValueError(f"the sm90 kernel takes bf16 with Dq, Dv "
                             f"multiples of 64 in [64, 512] and chunk a "
                             f"multiple of 64 within its shared memory; "
                             f"got {q.dtype}, Dq={Dq}, Dv={Dv}, "
                             f"chunk={chunk}")
        # TMA reads from 16-byte aligned bases
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
        # the chunk-start states C_c as bf16 hi and lo, and n_c
        Chi, Clo = (torch.empty((BH, nC, Dq, Dv), dtype=torch.bfloat16,
                                device=dev) for _ in range(2))
        scratch = (g, Mt, mt, mchain, Chi, Clo, f32(BH, nC, Dq))
        tail = (BH, S, Dq, Dv, chunk, parts)
    else:
        if columns_smem_bytes(Dq, chunk) > SMEM_LIMIT:
            raise ValueError(f"the kernel keeps a (Dq, {TILE}) slice of C "
                             f"in shared memory: Dq={Dq}, chunk={chunk} "
                             f"need {columns_smem_bytes(Dq, chunk)} bytes "
                             f"> {SMEM_LIMIT}")
        Lp = -(-chunk // TILE) * TILE
        # and the masked scores
        scratch = (g, Mt, mt, mchain, f32(BH * nC, Lp, Lp))
        tail = (BH, S, Dq, Dv, chunk, int(q.dtype == torch.bfloat16))
    tensors = (q, k, v, lf, li, C0, n0, m0, h, C, n, m, *scratch)
    ptrs = tuple(None if t is None else t.data_ptr() for t in tensors)
    args = ptrs + tail + (torch.cuda.current_stream(dev).cuda_stream,)
    return args, (h, (C, n, m)), tensors


def launch_with(launch, q, k, v, log_f, log_i, chunk, initial, *,
                route="simt"):
    """Allocate the outputs and scratch and call `launch`, a ctypes
    function of the C interface of `route`'s source (``ROUTES``), on
    checked CUDA tensors; raises on a launch error.  Counts nothing."""
    args, out, _ = launch_args(q, k, v, log_f, log_i, chunk, initial,
                               route=route)
    _build.check(launch(*args), f"mlstm_chunkwise ({route})")
    return out


#: kernel launches since the last reset: all, and by route; and the
#: backward's, all and by route
mlstm_chunkwise_bwd.launches = 0
mlstm_chunkwise_bwd.sm90_launches = 0
mlstm_chunkwise_bwd.simt_launches = 0
mlstm_chunkwise.launches = 0
mlstm_chunkwise.sm90_launches = 0
mlstm_chunkwise.simt_launches = 0
