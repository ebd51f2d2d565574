"""The chunkwise mLSTM forward (xLSTM matrix memory): the CUDA kernel
``mlstm_chunkwise`` (csrc/mlstm_chunk.cu) beside its plain PyTorch
version, and the one-step recurrence ``mlstm_step_plain`` that decode
uses.

* ``mlstm_chunkwise`` replaces ``repro/kernels/mlstm_chunk.py:
  mlstm_chunkwise`` (Pallas body ``_mlstm_kernel``).  It follows the
  oracle ``repro/kernels/ref.py: mlstm_chunkwise`` where the Pallas
  wrapper falls short: any S (the ragged tail counts as padding with
  f = 1 and i = 0), an optional ``initial`` (C, n, m), and the final
  state taken from the kernel's own carry.  Bound by bytes: at the
  xlstm-350m serve shape (B = 4, H = 4, S = 1024, Dq = Dv = 512,
  chunk 256, bf16) a call moves 84 MB and needs 21.5 GFLOP (the causal
  half of each chunk's L x L block).  ``mlstm_check`` holds it against
  the plain version.
* ``mlstm_step_plain`` is ``ref.py: mlstm_step``; the reference has no
  kernel for it, and neither has the port.

Dispatch follows the tensor: a CUDA tensor launches the kernel (or
raises), a CPU tensor runs the plain version.  There is no fallback.
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
        C = torch.zeros((B, H, Dq, Dv), dtype=torch.float32, device=dev)
        n = torch.zeros((B, H, Dq), dtype=torch.float32, device=dev)
        m = torch.full((B, H), NEG, dtype=torch.float32, device=dev)
    else:
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
# the CUDA kernel
# ---------------------------------------------------------------------------

_ARGTYPES = (ctypes.c_void_p,) * 17 + (ctypes.c_int,) * 6 + \
    (ctypes.c_void_p,)


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
            q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
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
    as ``mlstm_chunkwise_plain``.  CUDA tensors launch the kernel
    (``mlstm_chunkwise.launches`` counts the calls); CPU tensors run the
    plain version."""
    _check(q, k, v, log_f, log_i, chunk, initial)
    if q.device.type == "cpu":
        return mlstm_chunkwise_plain(q, k, v, log_f, log_i, chunk=chunk,
                                     initial=initial)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunkwise runs on cuda or cpu, not "
                         f"{q.device}")
    launch = _build.function("mlstm_chunk", "mlstm_chunk_launch", _ARGTYPES)
    out = launch_with(launch, q, k, v, log_f, log_i, chunk, initial)
    mlstm_chunkwise.launches += 1
    return out


def launch_with(launch, q, k, v, log_f, log_i, chunk, initial):
    """Allocate the outputs and scratch and call `launch`, a ctypes
    function of csrc/mlstm_chunk.cu's C interface, on checked CUDA
    tensors; raises on a launch error.  Counts nothing."""
    B, H, S, Dq = q.shape
    Dv = v.shape[-1]
    if columns_smem_bytes(Dq, chunk) > SMEM_LIMIT:
        raise ValueError(f"the kernel keeps a (Dq, {TILE}) slice of C in "
                         f"shared memory: Dq={Dq}, chunk={chunk} need "
                         f"{columns_smem_bytes(Dq, chunk)} bytes > "
                         f"{SMEM_LIMIT}")
    dev = q.device
    q, k, v = (a.contiguous() for a in (q, k, v))
    lf, li = (a.to(torch.float32).contiguous() for a in (log_f, log_i))
    C0 = n0 = m0 = None
    if initial is not None:
        C0, n0, m0 = (a.to(torch.float32).contiguous() for a in initial)
    nC = -(-S // chunk)
    Lp = -(-chunk // TILE) * TILE
    BH = B * H

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    h = torch.empty((B, H, S, Dv), dtype=q.dtype, device=dev)
    C, n, m = f32(B, H, Dq, Dv), f32(B, H, Dq), f32(B, H)
    # scratch: per-position gates, the stabilizer chain, the masked scores
    g, Mt, mt = f32(BH, nC * chunk), f32(BH, nC * chunk), f32(BH, nC * chunk)
    mchain, W = f32(BH, nC + 1), f32(BH * nC, Lp, Lp)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), lf.data_ptr(),
                 li.data_ptr(), ptr(C0), ptr(n0), ptr(m0), h.data_ptr(),
                 C.data_ptr(), n.data_ptr(), m.data_ptr(), g.data_ptr(),
                 Mt.data_ptr(), mt.data_ptr(), mchain.data_ptr(),
                 W.data_ptr(), BH, S, Dq, Dv, chunk,
                 int(q.dtype == torch.bfloat16),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mlstm_chunkwise")
    return h, (C, n, m)


#: kernel launches since the last reset
mlstm_chunkwise.launches = 0
