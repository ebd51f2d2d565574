"""Holding ``flash_attention_fwd`` against its plain version, and the
faults that holding must catch.

Each output is a weighted mean of the value rows, o = sum_j p_j v_j / l.
The kernel forms the scores, the weights and both sums in float32 in
another order than the reference, and rounds o to its type.  So each
element is held against the scale of its own rounding: the same sums
over absolute values, with each score's own scale (scale sum_d |q_d k_d|,
which multiplies the error of p_j),

    GAMMA sum_j p_j (1 + |s|_j) (|v_j| + |o|) / l  +  OUT_STEP |o|,

and a row that no key may attend must give 0.  The reference is the plain
version on float64 copies of the same inputs.

    PYTHONPATH=src python -m repro_torch.kernels.flash_check

builds csrc/flash_attention.cu and copies of it with one planted fault
each (the window one key too wide, the rescale of the accumulator by
exp(m_old - m_new) dropped, the last k tile skipped) under ``build/``,
runs every case of ``CASES`` through each on the card, and prints per
variant and case the largest error over its allowance.  It exits 0 when
the source passes every case and every fault fails at least one.  Needs
nvcc and a card.
"""
from __future__ import annotations

import json
import math
import sys

import torch

from . import _build
from . import flash_attention as fa

#: the card-side cases at the recurrentgemma-9b local-attention width
#: (B = 4, 16 heads, D = 256, bf16, causal): (name, S, window, q scale);
#: the last spreads the scores (q x 30) so that the running max moves
#: from k tile to k tile
CASES = (("local_3072", 3072, 2048, 1.0),
         ("causal_3072", 3072, 0, 1.0),
         ("ragged_3000", 3000, 2048, 1.0),
         ("spread_x30", 3072, 2048, 30.0))
SHAPE = {"B": 4, "H": 16, "D": 256}

#: float32 rounding allowed per unit of the scale above: 2^-16 (256
#: units), as the scores sum D <= 256 products and the two row sums run
#: over up to 64 keys a tile and one term per tile
GAMMA = 2.0 ** -16
#: what rounding o to its type adds, relative to |o|: half a step of the
#: last bit, 2^-8 for bfloat16, allowed twice (float32's own rounding lies
#: inside GAMMA)
OUT_STEP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def flash_inputs(gen, B, H, S, D, dtype, q_scale=1.0):
    """Random q (standard normal times q_scale), k, v in `dtype`, on
    `gen`'s device."""
    dev = gen.device
    q, k, v = (torch.randn((B, H, S, D), generator=gen, device=dev)
               for _ in range(3))
    return (q * q_scale).to(dtype), k.to(dtype), v.to(dtype)


def reference(q, k, v, *, causal=True, window=0, scale=None):
    """The plain version on float64 copies, and each element's allowance
    (both float64, (B, H, Sq, Dv)); one batch row at a time, to bound the
    (H, Sq, Sk) temporaries."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    mask = fa.attention_mask(q.shape[2], k.shape[2], causal=causal,
                             window=window, device=q.device)
    wants, allowed = [], []
    for b in range(q.shape[0]):
        qd, kd, vd = (t[b].double() for t in (q, k, v))
        want = fa.flash_attention_plain(qd[None], kd[None], vd[None],
                                        causal=causal, window=window,
                                        scale=scale)[0]
        s = torch.where(mask, torch.einsum("hqd,hkd->hqk", qd, kd) * scale,
                        fa.NEG)
        p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)),
                        0.0)
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        w = p * (1.0 + torch.einsum("hqd,hkd->hqk", qd.abs(), kd.abs())
                 * scale)
        acc = (torch.einsum("hqk,hkd->hqd", w, vd.abs()) +
               w.sum(dim=-1, keepdim=True) * want.abs()) / l
        wants.append(want)
        allowed.append(GAMMA * acc + OUT_STEP[q.dtype] * want.abs())
        del s, p, w
    return torch.stack(wants), torch.stack(allowed)


def flash_error(o, want, allowed) -> float:
    """The largest |o - want| over its allowance (<= 1 when they
    agree)."""
    d = (o.double() - want).abs()
    return (d / allowed.clamp_min(1e-300)).max().item()


#: planted faults: (text of csrc/flash_attention.cu, its replacement)
FAULTS = {
    "window_off_by_one": ("ok = ok && kp > qp - window;",
                          "ok = ok && kp >= qp - window;"),
    "rescale_dropped": ("acc[i][c] *= al;", "acc[i][c] *= 1.f;"),
    "last_tile_skipped": ("kt < kt1; ++kt", "kt < kt1 - 1; ++kt"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = _build.finish_variants(
        _build.start_variants("flash_attention", FAULTS, out_dir),
        "flash_attention_launch", fa._ARGTYPES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    B, H, D = SHAPE["B"], SHAPE["H"], SHAPE["D"]
    caught = {name: [] for name in FAULTS}
    source_ok = True
    for case, S, window, q_scale in CASES:
        q, k, v = flash_inputs(gen, B, H, S, D, torch.bfloat16, q_scale)
        want, allowed = reference(q, k, v, causal=True, window=window)
        for name, fn in fns.items():
            o = fa.launch_with(fn, q, k, v, causal=True, window=window,
                               scale=None)
            err = flash_error(o, want, allowed)
            ok = err <= 1.0
            print(json.dumps({"variant": name, "case": case,
                              "error_over_allowed": err, "ok": ok}),
                  flush=True)
            if name == "source":
                source_ok &= ok
            elif not ok:
                caught[name].append(case)
    missed = [name for name, cases in caught.items() if not cases]
    print(json.dumps({"source_passes": source_ok, "caught_in": caught,
                      "missed": missed,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if source_ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
