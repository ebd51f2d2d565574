"""Holding ``rglru_scan`` against its plain version, and the faults that
holding must catch.

h_t = a_t h_{t-1} + b_t sums terms whose weights are products of the a's,
so two float32 evaluations of it in different orders (the kernel's
chunks, the plain version's walk) differ by rounding that accumulates
along the recurrence and is largest where a -> 1 (long memory).  Each
element is held against the scale of its own rounding: the same
recurrence run over |b| (``e_t = a_t e_{t-1} + |b_t|``, a bound on |h_t|
and on every partial sum behind it).  ``rglru_allowance`` runs the
recurrence once more over what each step may add, ``GAMMA e_t`` for the
step's own roundings, b's sensitivity to the rounding of exp(2 log_a)
where 1 - exp(2 log_a) cancels, and ``ETA`` for underflow below float32's
subnormals.  The reference is the plain version in float64 on the same
inputs.

    PYTHONPATH=src python -m repro_torch.kernels.rglru_check

builds csrc/rglru_scan.cu and copies of it with one planted fault each
(the carry between chunks dropped, the decay 1 % high, sqrt(1 - a^2)
replaced by 1 - a) under ``build/``, runs every case of ``CASES`` through
each on the card, and prints per variant and case the largest error over
its allowance.  It exits 0 when the source passes every case and every
fault fails at least one.  Needs nvcc and a card.
"""
from __future__ import annotations

import json
import sys

import torch

from . import _build
from . import rglru_scan as rk

#: the card-side cases at the recurrentgemma-9b serve width (B = 4):
#: (name, S, W, gate kind).  Gate kinds: "uniform" log_a ~ -U(0.01, 2),
#: the range of tests/test_kernels.py; "model" the RG-LRU block's own
#: gates, -8 softplus(lam) sigmoid(z) with lam from its initializer;
#: "long" log_a = -10^U(-7, -3) (a -> 1, where sqrt(1 - a^2) cancels);
#: "short" log_a = -10^U(1, 2.5) (a -> 0)
CASES = (("serve", 3072, 4096, "uniform"),
         ("ragged_3000", 3000, 4000, "uniform"),
         ("model_gates", 3072, 4096, "model"),
         ("long_memory", 3072, 4096, "long"),
         ("short_memory", 3072, 4096, "short"))
BATCH = 4

#: what one step of the recurrence may add to an element's error, per
#: unit of its rounding scale e_t: 2^-20 (16 float32 units), for the
#: rounding of a = exp(log_a) (2 ulp), of the multiply-add and of b's
#: sqrt and product
GAMMA = 2.0 ** -20
#: exp(2 log_a) is computed to 2 ulp (2^-23 near 1), so b = sqrt(y) x,
#: y = 1 - exp(2 log_a), may be off by |x| min(2^-11, 2^-23 / sqrt(y))
Y_ERR = 2.0 ** -23
#: what underflow may add per step whatever the scale: float32 rounds
#: below its subnormals (2^-149) with an absolute error up to 2^-150 per
#: operation (a h_{t-1} with a ~ e^-182 is 0 in float32); four of them
ETA = 2.0 ** -148


def rglru_inputs(gen, B, S, W, kind):
    """Random x (float32 standard normal) and log_a of `kind` (see
    ``CASES``) on `gen`'s device."""
    dev = gen.device

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    x = torch.randn((B, S, W), generator=gen, device=dev)
    if kind == "uniform":
        la = -(0.01 + 1.99 * uniform(B, S, W))
    elif kind == "model":
        u = 0.1 + 0.8 * uniform(W)
        lam = torch.log(torch.expm1(-torch.log(u) / 8.0))
        r = torch.sigmoid(torch.randn((B, S, W), generator=gen, device=dev))
        la = -8.0 * torch.nn.functional.softplus(lam) * r
    elif kind == "long":
        la = -torch.pow(10.0, -7.0 + 4.0 * uniform(B, S, W))
    elif kind == "short":
        la = -torch.pow(10.0, 1.0 + 1.5 * uniform(B, S, W))
    else:
        raise ValueError(f"unknown gate kind {kind!r}")
    return x, la


def rglru_allowance(x, log_a):
    """How far a float32 evaluation of the recurrence may lie from the
    exact one, per element (float64, (B, S, W)): the recurrence run over
    GAMMA e_t + |x_t| min(2^-11, Y_ERR / sqrt(y_t)) + ETA, with e_t the
    same recurrence over |b_t|."""
    x, la = x.double(), log_a.double()
    a, b = rk.rglru_coefficients(x, la)
    y = torch.clamp(1.0 - torch.exp(2.0 * la), min=0.0)
    db = x.abs() * torch.clamp(Y_ERR / torch.sqrt(y), max=2.0 ** -11)
    e = torch.zeros_like(b[:, 0])
    err = torch.zeros_like(e)
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        e = a[:, t] * e + b[:, t].abs()
        err = a[:, t] * err + GAMMA * e + db[:, t] + ETA
        out[:, t] = err
    return out


def reference(x, log_a):
    """The plain version in float64 on the same inputs, and the
    allowance."""
    return rk.rglru_scan_plain(x.double(), log_a.double()), \
        rglru_allowance(x, log_a)


def rglru_error(h, want, allowed) -> float:
    """The largest |h - want| over its allowance (<= 1 when they
    agree)."""
    d = (h.double() - want).abs()
    return (d / allowed.clamp_min(1e-300)).max().item()


#: planted faults: (text of csrc/rglru_scan.cu, its replacement)
FAULTS = {
    "carry_dropped": ("Hin[o] = h;", "Hin[o] = 0.f;"),
    "decay_1pct": ("{ return expf(la); }", "{ return expf(la) * 1.01f; }"),
    "one_minus_a": ("sqrtf(fmaxf(1.f - expf(2.f * la), 0.f))",
                    "(1.f - expf(la))"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("rglru_check: needs an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = _build.finish_variants(
        _build.start_variants("rglru_scan", FAULTS, out_dir),
        "rglru_scan_launch", rk._ARGTYPES)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    caught = {name: [] for name in FAULTS}
    source_ok = True
    for case, S, W, kind in CASES:
        x, la = rglru_inputs(gen, BATCH, S, W, kind)
        want, allowed = reference(x, la)
        for name, fn in fns.items():
            err = rglru_error(rk.launch_with(fn, x, la), want, allowed)
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
