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

builds both CUDA sources of the kernel (``flash_attention.ROUTES``) and
copies of each with one planted fault (``FAULTS``: the window one key
too wide, the rescale of the accumulator by exp(m_old - m_new) dropped,
the last k tile skipped; for the sm90 source p_lo dropped, so that p v
multiplies by p rounded to bf16; for the simt source the lo halves of
its TF32 splits dropped, so that each float32 product is one TF32
product, a_hi b_hi) under ``build/``, runs every case of ``CASES``
through each on the card and the cases of ``SIMT_CASES`` through the
simt source's, and prints per variant and case the largest error over
its allowance.  It exits 0 when each source passes every case and every
fault fails at least one.  Needs nvcc and a card.
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
#: cases that the simt route takes through the entry point (float32, and
#: a head dim the sm90 kernel has no instantiation for), at the same B
#: and H: (name, dtype, D, S, window, q scale)
SIMT_CASES = (("f32_local_3072", torch.float32, 256, 3072, 2048, 1.0),
              ("d32_ragged_3000", torch.bfloat16, 32, 3000, 2048, 1.0))

#: float32 rounding allowed per unit of the scale above: 2^-16 (256
#: units), as the scores sum D <= 256 products and the two row sums run
#: over up to 64 keys a tile and one term per tile.  One TF32 product
#: (2^-11 of each operand) misses it; the three-term split (about 2^-21)
#: does not
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


#: planted faults per source (csrc/<source>.cu): {fault: (text, its
#: replacement)}, each text once in its source
FAULTS = {
    "flash_attention": {
        "window_off_by_one": ("ok = ok && kp > qp - window;",
                              "ok = ok && kp >= qp - window;"),
        "rescale_dropped": (
            "acc[n][0] *= al0; acc[n][1] *= al0; acc[n][2] *= al1; "
            "acc[n][3] *= al1;", ""),
        "last_tile_skipped": ("kt < kt1; ++kt", "kt < kt1 - 1; ++kt"),
        "tf32_lo_dropped": (
            "lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));", "lo = 0u;"),
    },
    "flash_attention_sm90": {
        "window_off_by_one": ("ok = ok && kp > qp - window;",
                              "ok = ok && kp >= qp - window;"),
        "rescale_dropped": ("acc[j] *= (j & 2) ? al1 : al0;",
                            "acc[j] *= 1.f;"),
        "last_tile_skipped": ("const int nt = kt1 - kt0;",
                              "const int nt = kt1 - kt0 - 1;"),
        "p_lo_dropped": ("pa - __low2float(hi), pb - __high2float(hi)",
                         "0.f, 0.f"),
    },
}
#: each source's route (``flash_attention.ROUTES``)
SOURCE_ROUTE = {"flash_attention": "simt", "flash_attention_sm90": "sm90"}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {src: _build.start_variants(src, faults, out_dir)
             for src, faults in FAULTS.items()}
    fns = {src: _build.finish_variants(
        procs[src], *fa.ROUTES[SOURCE_ROUTE[src]][1:]) for src in FAULTS}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    B, H, D = SHAPE["B"], SHAPE["H"], SHAPE["D"]
    caught = {src: {name: [] for name in faults}
              for src, faults in FAULTS.items()}
    source_ok = True
    runs = [(case, torch.bfloat16, D, S, window, q_scale, tuple(fns))
            for case, S, window, q_scale in CASES] + \
        [(*case, ("flash_attention",)) for case in SIMT_CASES]
    for case, dtype, Dc, S, window, q_scale, sources in runs:
        q, k, v = flash_inputs(gen, B, H, S, Dc, dtype, q_scale)
        want, allowed = reference(q, k, v, causal=True, window=window)
        for src in sources:
            for name, fn in fns[src].items():
                o = fa.launch_with(fn, q, k, v, causal=True, window=window,
                                   scale=None, route=SOURCE_ROUTE[src])
                err = flash_error(o, want, allowed)
                ok = err <= 1.0
                print(json.dumps({"source": src, "variant": name,
                                  "case": case, "error_over_allowed": err,
                                  "ok": ok}), flush=True)
                if name == "source":
                    source_ok &= ok
                elif not ok:
                    caught[src][name].append(case)
        del q, k, v, want, allowed
    missed = [f"{src}:{name}" for src, faults in caught.items()
              for name, cases in faults.items() if not cases]
    print(json.dumps({"sources_pass": source_ok, "caught_in": caught,
                      "missed": missed,
                      "gpu": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if source_ok and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
