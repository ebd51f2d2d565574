"""The per-step evaluation API (port of ``repro/kernels/ops.py``'s
``StepSpec`` / ``StepOutputs`` / ``step_eval`` / node counts).

``StepSpec`` and ``StepOutputs`` are copied from the reference, so one
frozen spec names the same step on both sides.  ``step_eval`` maps a
spec onto kernels by metric and layout:

  availability, packed=False  (R, n_pad) bool tiles  -> pac_eval.pac_eval
  availability, packed=True   (B, W, P) int32 words  -> fused_step.fused_pac_eval
  downtime, packed=False      bool tiles [+ roster + recruit/active]
                                                     -> pac_eval.downtime_eval
  downtime, packed=True       words [+ roster + recruit/active]
                                                     -> fused_step.fused_downtime_eval

``client_latency_step`` is the client-latency layer's post-step op, one
``pac_eval.latency_charge`` call.  The model half (``ops.py:68-100`` of
the reference): ``mlstm_chunkwise`` and ``rglru_scan``, the prefill
recurrences (one kernel launch each on a CUDA tensor), and
``mlstm_step`` and ``rglru_step``, their one-step decode recurrences,
plain PyTorch on both devices as in the reference; ``flash_attention``,
causal / sliding-window attention on (B, H, S, D) through the
``flash_attention`` kernel, which no model path calls.  Each kernel
wrapper dispatches by the tensor's device (CUDA kernel on a CUDA tensor,
plain PyTorch on a CPU tensor).  The reference's numpy/jax/pallas
backend switch has no counterpart here.

The tile tuners (the reference's ``ops.py:127-296`` and ``:755-952``,
re-derived for this card): ``step_eval`` takes ``block_p`` (unpacked: the
rows T of ``downtime_eval.cu``'s tile; packed: the partitions of a
``fused_downtime.cu`` block) and ``block_t`` (packed: the block's
trials).  ``autotune_block_p`` races ``block_p_candidates`` (the row
tiles within a block's 100 KiB of shared memory) and
``autotune_fused_blocks`` ``fused_block_candidates`` (the blocks within
an SM's registers) on the card, each candidate held ``torch.equal`` to
the default tile before it is timed.  ``step_hbm_bytes`` is the two
layouts' traffic per step.  Every tile gives the same bits.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from . import bitpack, fused_step, mlstm_chunk, pac_eval, rglru_scan as _rglru
from . import flash_attention as _flash

STEP_METRICS = ("availability", "downtime")
STEP_REBUILD_MODELS = ("fixed", "reconfig")
#: protocol-zoo engines a downtime StepSpec can additionally evaluate —
#: each adds one int32 row output between nrep and creps
STEP_ENGINES = ("hermes", "spinnaker")


@dataclass(frozen=True)
class StepSpec:
    """Everything the per-step kernel dispatch depends on, in one frozen
    value (hashable: usable as a cache/jit key).

    metric         "availability" (§5.1 PAC + majority baseline) or
                   "downtime" (§6 commit-pause: + leader/nrep outputs)
    rf             replication factor (roster width)
    n_real         real node count; lanes/bits >= n_real are padding
    voters         majority-baseline voter count; None resolves to the
                   paper's 2*(rf-1)+1 for availability and rf for
                   downtime (the quorum-log replica-set vote)
    rebuild_model  "fixed" or "reconfig"; reconfig is what carries a
                   roster into the eval and (with bandwidth contention)
                   folds rebuild node counts into the step
    packed         False: boolean (R, n_pad) tiles.  True: bit-packed
                   (B, W, P) uint32 words (kernels/bitpack.py) — layout
                   only, every output bit-identical
    dupres_ticks / rebuild_steps
                   §6 engine knobs carried for provenance (they shape
                   the step *around* the eval, not the eval itself;
                   kept here so one spec names the whole step)
    engines        protocol-zoo engines riding the downtime eval
                   (subset of STEP_ENGINES).  "hermes" requests the
                   first-rf membership bitmask (repmask; needs rf <= 30
                   so the mask fits a non-negative int32); "spinnaker"
                   requests the electable roster leader (rleader; needs
                   rebuild_model="reconfig" — it elects among the
                   carried roster).  Both extras land between nrep and
                   creps in every kernel body.
    """
    metric: str
    rf: int
    n_real: int
    voters: Optional[int] = None
    rebuild_model: str = "fixed"
    packed: bool = False
    dupres_ticks: int = 0
    rebuild_steps: int = 0
    engines: tuple = ()

    def __post_init__(self):
        if self.metric not in STEP_METRICS:
            raise ValueError(f"unknown step metric {self.metric!r}; "
                             f"expected one of {STEP_METRICS}")
        if self.rebuild_model not in STEP_REBUILD_MODELS:
            raise ValueError(
                f"unknown rebuild_model {self.rebuild_model!r}; "
                f"expected one of {STEP_REBUILD_MODELS}")
        if not 1 <= self.rf <= self.n_real:
            raise ValueError(
                f"rf={self.rf} must be in [1, n_real={self.n_real}]")
        if self.voters is not None and self.voters < 1:
            raise ValueError(f"voters={self.voters} must be >= 1")
        if self.dupres_ticks < 0 or self.rebuild_steps < 0:
            raise ValueError("dupres_ticks / rebuild_steps must be >= 0")
        object.__setattr__(self, "engines", tuple(self.engines))
        for e in self.engines:
            if e not in STEP_ENGINES:
                raise ValueError(f"unknown step engine {e!r}; "
                                 f"expected a subset of {STEP_ENGINES}")
        if len(set(self.engines)) != len(self.engines):
            raise ValueError(f"duplicate step engines: {self.engines}")
        if self.engines and self.metric != "downtime":
            raise ValueError("protocol-zoo engines are downtime-metric "
                             "outputs; availability spec can't request "
                             f"{self.engines}")
        if "hermes" in self.engines and self.rf > 30:
            raise ValueError(f"hermes needs rf <= 30 (membership bitmask "
                             f"in a non-negative int32); got rf={self.rf}")
        if "spinnaker" in self.engines and self.rebuild_model != "reconfig":
            raise ValueError("spinnaker elects among the carried roster; "
                             "it requires rebuild_model='reconfig'")

    @property
    def resolved_voters(self) -> int:
        if self.voters is not None:
            return self.voters
        return 2 * (self.rf - 1) + 1 if self.metric == "availability" \
            else self.rf

    @property
    def fused_kernel(self) -> str:
        """The fused-kernel kind this spec dispatches to (autotune key)."""
        if self.metric == "availability":
            return "fused_pac"
        return "fused_downtime_roster" if self.rebuild_model == "reconfig" \
            else "fused_downtime"

    @property
    def want_repmask(self) -> bool:
        return "hermes" in self.engines

    @property
    def want_rleader(self) -> bool:
        return "spinnaker" in self.engines


class StepOutputs(NamedTuple):
    """step_eval's full output surface; slots a spec doesn't produce are
    None (availability: leader/leader_full/nrep; no recruit: counts;
    engines without hermes/spinnaker: repmask/rleader — and rleader stays
    None on roster-less calls even under a spinnaker spec, since it
    elects among the carried roster)."""
    lark: object
    maj: object
    leader: object = None
    leader_full: object = None
    nrep: object = None
    creps: object = None
    counts: object = None
    repmask: object = None
    rleader: object = None


def _take_extras(outs, want_repmask: bool, want_rleader: bool):
    """Pull the protocol-zoo extras out of a kernel's (lark, qmaj, leader,
    leader_full, nrep, *extras, creps[, counts]) tuple."""
    k = 5
    repmask = rleader = None
    if want_repmask:
        repmask = outs[k]
        k += 1
    if want_rleader:
        rleader = outs[k]
    return repmask, rleader


def rebuild_node_counts(recruit, active, *, n_real: int):
    """Per-node in-flight rebuild counts for the §6 bandwidth-contended
    rebuild model (the reference's ``_rebuild_node_counts_impl``):
    recruit (B, P) int32 node ids (values outside [0, n_real) are
    ignored), active (B, P) bool -> counts (B, n_real) int32.  The
    reduction never crosses trials."""
    return pac_eval.node_count(recruit, active, n_real=n_real)


def step_eval(spec: StepSpec, up, full, *, roster=None, recruit=None,
              active=None, block_p: Optional[int] = None,
              block_t: Optional[int] = None) -> StepOutputs:
    """Evaluate one Monte Carlo step under `spec`.

    Boolean layout (spec.packed=False): up/full are (R, n_pad) bool
    rank-space tiles, roster (R, rf) int32, and outputs are (R,) /
    (R, n_pad).  recruit/active ((B, P) int32/bool) additionally request
    the bandwidth model's node counts (B, n_real), from the same
    ``downtime_eval`` launch.
    Packed layout (spec.packed=True): up/full are (B, W, P) int32 word
    planes (bit b of word k = succession rank 32k+b), roster is the
    engine's carried (B, P, rf) int32 ranks, row outputs are (B, P) and
    creps comes back as (B, W, P) words; one ``fused_downtime_eval``
    launch gives the eval, the roster select and the counts.
    Both layouts give the same bits.

    block_p / block_t: the kernel's tile, typically an autotuner's choice
    (None: the kernel's default).  Unpacked, block_p is the rows of a
    ``downtime_eval.cu`` tile and block_t is not used; packed, (block_t,
    block_p) is a ``fused_downtime.cu`` block's trials and partitions.
    The tile is throughput only; on CPU tensors it is ignored, and on CUDA
    tensors an invalid one raises ValueError before any launch.
    """
    if spec.metric == "downtime" and spec.rebuild_model != "reconfig" \
            and roster is not None:
        raise ValueError("roster is only meaningful for "
                         "rebuild_model='reconfig'")
    if (recruit is None) != (active is None):
        raise ValueError("recruit and active must be passed together")
    if spec.metric == "availability" and recruit is not None:
        raise ValueError("rebuild node counts are a downtime-engine "
                         "output; availability spec can't request them")
    tile = dict(block_t=block_t, block_p=block_p) if spec.packed \
        else dict(block_p=block_p)
    if spec.metric == "availability":
        kernel = fused_step.fused_pac_eval if spec.packed \
            else pac_eval.pac_eval
        lark, maj, creps = kernel(up, full, rf=spec.rf,
                                  voters=spec.resolved_voters,
                                  n_real=spec.n_real, **tile)
        return StepOutputs(lark=lark, maj=maj, creps=creps)

    # rleader elects among the carried roster, so a roster-less call
    # (e.g. the engines' t=0 init eval) simply doesn't produce it
    want_rm = spec.want_repmask
    want_rl = spec.want_rleader and roster is not None
    if spec.packed:
        outs = fused_step.fused_downtime_eval(
            up, full, rf=spec.rf, n_real=spec.n_real, roster=roster,
            recruit=recruit, active=active, want_repmask=want_rm,
            want_rleader=want_rl, **tile)
        ncr = 6 + int(want_rm) + int(want_rl)
        counts = outs[ncr] if recruit is not None else None
        creps = outs[ncr - 1]
    else:
        outs = pac_eval.downtime_eval(
            up, full, rf=spec.rf, n_real=spec.n_real, roster=roster,
            want_repmask=want_rm, want_rleader=want_rl, recruit=recruit,
            active=active, **tile)
        counts = outs[-1] if recruit is not None else None
        creps = outs[-2] if recruit is not None else outs[-1]
    repmask, rleader = _take_extras(outs, want_rm, want_rl)
    return StepOutputs(lark=outs[0], maj=outs[1], leader=outs[2],
                       leader_full=outs[3], nrep=outs[4], creps=creps,
                       counts=counts, repmask=repmask, rleader=rleader)


# ---------------------------------------------------------------------------
# The tile tuners: the row tile (block_p) of the unpacked kernels and the
# (block_t, block_p) block of the packed one, raced on the card
# ---------------------------------------------------------------------------

#: kernels the row-tile tuner races: the §5.1 PAC kernel, the §6 downtime
#: kernel and its roster variant (one kernel body, ``downtime_eval.cu``)
AUTOTUNE_KERNELS = ("pac", "downtime", "downtime_roster")
#: kinds the 2-D tuner races (``StepSpec.fused_kernel``)
FUSED_KERNELS = ("fused_pac", "fused_downtime", "fused_downtime_roster")
#: registers one SM holds, and the most a thread of a named block gets:
#: ``fused_downtime.cu`` compiles those blocks' kernel under
#: ``__maxnreg__(64)``, so 1024 threads fit an SM (the build's ptxas
#: report gives the count each instantiation uses)
SM_REGISTERS, FUSED_REGS_PER_THREAD = 65536, 64


@dataclass(frozen=True)
class AutotuneResult:
    block_p: int
    timings_us: Mapping[int, float]   # candidate -> median µs/launch
    source: str                       # "measured" | "heuristic-fallback"


@dataclass(frozen=True)
class FusedAutotuneResult:
    block_t: int
    block_p: int
    timings_us: Mapping[Tuple[int, int], float]
    source: str                       # "measured" | "heuristic-fallback"


_AUTOTUNE_CACHE: dict = {}


def block_p_candidates(R: int, n_pad: int, *, rf: int = 2,
                       kernel: str = "pac") -> tuple:
    """The row tiles T a (R, n_pad) tile may take (``pac_eval.row_tiles``):
    powers of two from 16 to 128 that divide R and whose three row buffers
    (and, for "downtime_roster", the roster slice) fit the 100 KiB of
    shared memory a block of ``downtime_eval.cu`` gets; 16 alone where
    rows need column passes.  A pure function of the shape; where no tile
    divides R, the kernel's own choice, which the tuner then refuses."""
    return pac_eval.row_tiles(R, n_pad, rf=rf,
                              roster=kernel == "downtime_roster") \
        or (pac_eval.default_row_tile(R, n_pad, rf=rf,
                                      roster=kernel == "downtime_roster"),)


def fused_block_registers(block_t: int, block_p: int) -> int:
    """Registers a (block_t, block_p) block of ``fused_downtime.cu`` may
    hold: its threads times ``FUSED_REGS_PER_THREAD``, the cap its kernel
    is compiled under (the budget ``fused_block_candidates`` keeps within one
    SM's ``SM_REGISTERS``, the Hopper counterpart of the reference's VMEM
    bytes)."""
    return block_t * block_p * FUSED_REGS_PER_THREAD


def fused_block_candidates(B: int, P: int, n_pad: int = 0, *, rf: int = 2,
                           kernel: str = "fused_pac",
                           registers: int = SM_REGISTERS) -> tuple:
    """The (block_t, block_p) pairs a (B, P) packed grid may take: block_p
    a power of two from 32 (a warp, so ``__match_any_sync``'s peers never
    span trials) to 1024 dividing P, block_t a power of two up to 16
    dividing B, within `registers` (``fused_block_registers``; one SM's
    by default, which is also the 1024-thread block limit).  A pure
    function of the shape (n_pad, rf and the kind change no budget: the
    kernel keeps its words in registers, and no shared memory); where P
    has no divisor from 32, the default block, which the tuner refuses."""
    return fused_step.fused_blocks(
        B, P, max_threads=registers // FUSED_REGS_PER_THREAD) \
        or (fused_step.DEFAULT_BLOCK,)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _pattern(rows: int, n_pad: int, dev) -> tuple:
    """The reference tuner's deterministic counter-hash tile (no RNG
    state): up ~93 % of lanes, a fixed latest-copy pattern."""
    idx = (torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
           * n_pad + torch.arange(n_pad, dtype=torch.int64, device=dev))
    up = (idx * 2654435761 % (2 ** 32)) % 97 < 90
    full = (idx * 40503 % (2 ** 32)) % 89 < 30
    return up, full


def _median_us(call, iters: int) -> float:
    """Median µs of `iters` launches of `call()`, each timed by CUDA events
    around it, after a warm launch; the stream sleeps before each so the
    host enqueues the launch before the card reaches it (the time is the
    card's, not the host's)."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        t0.record()
        call()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) * 1e3)
    return statistics.median(times)


def _held(got, want, what: str):
    if len(got) != len(want) or not all(
            torch.equal(g, w) for g, w in zip(got, want)):
        raise RuntimeError(f"{what}: the outputs differ from the default "
                           f"tile's (a kernel fault)")


def race_calls(kernel: str, dims: tuple, n_pad: int, *, rf: int,
               voters: int, n_real: int, device) -> tuple:
    """(call, plain) on the tuners' counter-hash inputs for one of the six
    kinds (``AUTOTUNE_KERNELS`` on (R,) rows, ``FUSED_KERNELS`` on (B, P)
    packed to words): call(tile) runs the wrapper at `tile` (None: the
    default; T, or a (block_t, block_p) pair) and plain() its plain
    version on the same inputs.  The roster kinds carry the identity
    roster, the fused one also the reference tuner's recruit ids and
    active flags."""
    rows = dims[0] if len(dims) == 1 else dims[0] * dims[1]
    up, full = _pattern(rows, n_pad, device)
    if kernel in AUTOTUNE_KERNELS:
        kw = {}
        if kernel == "pac":
            fn, plain = pac_eval.pac_eval, pac_eval.pac_eval_plain
            kw = dict(voters=voters)
        else:
            fn, plain = pac_eval.downtime_eval, pac_eval.downtime_eval_plain
            if kernel == "downtime_roster":
                kw = dict(roster=torch.arange(
                    rf, dtype=torch.int32, device=device).repeat(rows, 1))
        return (lambda tile=None: fn(up, full, rf=rf, n_real=n_real,
                                     block_p=tile, **kw),
                lambda: plain(up, full, rf=rf, n_real=n_real, **kw))
    if kernel not in FUSED_KERNELS:
        raise ValueError(f"unknown autotune kernel {kernel!r}; expected "
                         f"one of {AUTOTUNE_KERNELS + FUSED_KERNELS}")
    B, P = dims
    upw, fullw = (bitpack.pack_words(t.reshape(B, P, n_pad)).movedim(-1, 1)
                  .contiguous() for t in (up, full))
    if kernel == "fused_pac":
        fn, plain = fused_step.fused_pac_eval, fused_step.fused_pac_eval_plain
        kw = dict(voters=voters)
    else:
        fn = fused_step.fused_downtime_eval
        plain = fused_step.fused_downtime_eval_plain
        kw = {}
        if kernel == "fused_downtime_roster":
            recruit = (torch.arange(B * P, dtype=torch.int32, device=device)
                       % (n_real + 1)).reshape(B, P)
            kw = dict(roster=torch.arange(rf, dtype=torch.int32,
                                          device=device).repeat(B, P, 1),
                      recruit=recruit, active=(recruit % 3) != 0)

    def call(tile=None):
        bt, bp = (None, None) if tile is None else tile
        return fn(upw, fullw, rf=rf, n_real=n_real, block_t=bt,
                  block_p=bp, **kw)
    return call, lambda: plain(upw, fullw, rf=rf, n_real=n_real, **kw)


def _race(kernel: str, dims: tuple, n_pad: int, cands, *, rf: int,
          voters: int, n_real: int, iters: int, device) -> dict:
    """{candidate: median µs/launch} of `kernel` on ``race_calls``' inputs,
    each candidate's outputs held ``torch.equal`` to the default tile's
    before it is timed."""
    call, _ = race_calls(kernel, dims, n_pad, rf=rf, voters=voters,
                         n_real=n_real, device=device)
    default = call()
    timings = {}
    for tile in cands:
        _held(call(tile), default, f"{kernel} at tile {tile}")
        timings[tile] = _median_us(lambda: call(tile), iters)
    return timings


def _fastest(timings: dict):
    """The candidate with the least time, ties toward the smaller tile."""
    return min(sorted(timings), key=lambda c: (timings[c], c))


def _check_force(device, force: bool):
    if force and device.type != "cuda":
        raise ValueError("force=True races the kernels on the card; on the "
                         "CPU the plain versions run, which have no tile "
                         "to race")


def autotune_block_p(R: int, n_pad: int, *, rf: int, voters: int,
                     n_real: int, candidates=None, iters: int = 9,
                     measure=None, force: bool = False,
                     kernel: str = "pac", device=None) -> AutotuneResult:
    """Pick the fastest row tile (``block_p``) for an (R, n_pad) Monte
    Carlo tile of `kernel`: "pac" (§5.1), "downtime" (§6) or
    "downtime_roster" (the reconfiguring baseline's variant).

    The reference's determinism contract: the candidate set is a pure
    function of the shape (``block_p_candidates``), each candidate's time
    is the median of `iters` launches on the card after a warm launch,
    ties break toward the smaller tile, and the choice is cached per
    ("block_p", kernel, shape, params, candidates, device name) for the
    process.  Every candidate's outputs are held ``torch.equal`` to the
    default tile's before it is timed (a mismatch raises: a kernel
    fault).  On a `device` whose tensors run the plain versions (the
    CPU) there is no tile to race: without an injected `measure` the
    tuner returns the kernel's own tile (``pac_eval.default_row_tile``)
    as "heuristic-fallback", and `force` raises.  An injected `measure(R,
    n_pad, T)` (tests) bypasses the cache.
    """
    if kernel not in AUTOTUNE_KERNELS:
        raise ValueError(f"unknown autotune kernel {kernel!r}; expected "
                         f"one of {AUTOTUNE_KERNELS}")
    cands = tuple(candidates) if candidates is not None \
        else block_p_candidates(R, n_pad, rf=rf, kernel=kernel)
    if not cands:
        raise ValueError("autotune_block_p needs at least one candidate")
    for bp in cands:
        if R % bp:
            raise ValueError(f"candidate block_p {bp} does not divide R={R}")
    if measure is not None:
        timings = {bp: float(measure(R, n_pad, bp)) for bp in cands}
        return AutotuneResult(block_p=_fastest(timings), timings_us=timings,
                              source="measured")
    dev = resolve_device(device)
    _check_force(dev, force)
    key = ("block_p", kernel, R, n_pad, rf, voters, n_real, cands,
           _device_name(dev))
    if key in _AUTOTUNE_CACHE:
        return _AUTOTUNE_CACHE[key]
    if dev.type != "cuda":
        res = AutotuneResult(
            block_p=pac_eval.default_row_tile(
                R, n_pad, rf=rf, roster=kernel == "downtime_roster"),
            timings_us={}, source="heuristic-fallback")
    else:
        timings = _race(kernel, (R,), n_pad, cands, rf=rf, voters=voters,
                        n_real=n_real, iters=iters, device=dev)
        res = AutotuneResult(block_p=_fastest(timings), timings_us=timings,
                             source="measured")
    _AUTOTUNE_CACHE[key] = res
    return res


def autotune_fused_blocks(B: int, P: int, n_pad: int, *, rf: int,
                          voters: int, n_real: int, candidates=None,
                          iters: int = 9, measure=None, force: bool = False,
                          kernel: str = "fused_pac",
                          device=None) -> FusedAutotuneResult:
    """Pick the fastest (block_t, block_p) block of the packed kernel of
    `kernel` (``FUSED_KERNELS``) for a (B, P) grid of words.

    ``autotune_block_p``'s contract: a candidate set that is a pure
    function of the shape (``fused_block_candidates``), the median of
    `iters` launches after a warm one, ties toward the smaller tile
    (block_t first, then block_p), every candidate held ``torch.equal`` to
    the default block before it is timed, a process cache whose key is
    tagged "fused" and holds the kind, the geometry, the candidates and
    the device name (so it never aliases a row-tile entry), the default
    block (1, 128) as "heuristic-fallback" on the CPU, `force` raising
    there, and an injected `measure(B, P, n_pad, bt, bp)` bypassing the
    cache.
    """
    if kernel not in FUSED_KERNELS:
        raise ValueError(f"unknown fused autotune kernel {kernel!r}; "
                         f"expected one of {FUSED_KERNELS}")
    cands = tuple(candidates) if candidates is not None else \
        fused_block_candidates(B, P, n_pad, rf=rf, kernel=kernel)
    if not cands:
        raise ValueError("autotune_fused_blocks needs at least one "
                         "candidate")
    for bt, bp in cands:
        if B % bt or P % bp:
            raise ValueError(f"candidate ({bt}, {bp}) does not tile "
                             f"(B={B}, P={P})")
    if measure is not None:
        timings = {c: float(measure(B, P, n_pad, *c)) for c in cands}
        best = _fastest(timings)
        return FusedAutotuneResult(block_t=best[0], block_p=best[1],
                                   timings_us=timings, source="measured")
    dev = resolve_device(device)
    _check_force(dev, force)
    key = ("fused", kernel, B, P, n_pad, rf, voters, n_real, cands,
           _device_name(dev))
    if key in _AUTOTUNE_CACHE:
        return _AUTOTUNE_CACHE[key]
    if dev.type != "cuda":
        res = FusedAutotuneResult(
            block_t=fused_step.DEFAULT_BLOCK[0],
            block_p=fused_step.DEFAULT_BLOCK[1], timings_us={},
            source="heuristic-fallback")
    else:
        timings = _race(kernel, (B, P), n_pad, cands, rf=rf, voters=voters,
                        n_real=n_real, iters=iters, device=dev)
        best = _fastest(timings)
        res = FusedAutotuneResult(block_t=best[0], block_p=best[1],
                                  timings_us=timings, source="measured")
    _AUTOTUNE_CACHE[key] = res
    return res


def step_hbm_bytes(spec: StepSpec, B: int, P: int, n_pad: int) -> dict:
    """Device-memory bytes one step's eval moves, each input read once and
    each output written once, in the port's two layouts: the unpacked
    launch on (R = B·P, n_pad) bool tiles (unpadded, a byte a lane) and
    the packed launch on (B, W, P) int32 words.

    Unpacked: up and full read, creps written (3·R·n_pad), with 2 bytes
    of rows (lark, maj) for availability and 11 (lark, qmaj, lfull, leader,
    nrep) for downtime, 4 more per protocol-zoo extra.  Packed: 12·B·W·P
    for the three word planes, the same rows.  The reconfig model adds
    the carried roster (4·R·rf, rf ranks a row, no lane padding) and the
    bandwidth model's in-flight counts, folded into the same launch in
    both layouts (recruit and active read, 5·R; the (B, n_real) int32
    counts written).  At the paper tile (B = 8, P = 4096, n = 155, rf =
    2) these are ``kernels/mc_check.py``'s byte counts: pac_eval
    15,302,656 and fused_pac_eval 2,031,616; fused_downtime_eval
    2,326,528 fixed and 2,757,472 with the roster and the counts.
    """
    R = B * P
    W = bitpack.n_words(n_pad)
    rows = (2 if spec.metric == "availability" else 11) * R \
        + 4 * R * len(spec.engines)
    extra = 0
    if spec.metric == "downtime" and spec.rebuild_model == "reconfig":
        extra = 4 * R * spec.rf + 5 * R + 4 * B * spec.n_real
    unfused = 3 * R * n_pad + rows + extra
    fused = 12 * B * W * P + rows + extra
    return {"unfused_bytes": unfused, "fused_bytes": fused,
            "ratio": unfused / fused}


#: the client-latency layer's post-step op (``core/client_latency.py``,
#: the reference's ``ops.client_latency_step``): one event interval of
#: dirty-key decay with LARK first-touch charges and the closed-form
#: quorum rebuild-wait charges, in the reference's argument order and
#: output shapes — on CUDA tensors one ``latency_charge`` launch, the
#: decay chain included; on CPU tensors its plain version
client_latency_step = pac_eval.latency_charge


#: the model half: the chunkwise mLSTM prefill (one ``mlstm_chunk`` kernel
#: launch on CUDA tensors, its plain version on CPU tensors) and the
#: one-step decode recurrence, plain on both devices as in the reference
mlstm_chunkwise = mlstm_chunk.mlstm_chunkwise
mlstm_step = mlstm_chunk.mlstm_step_plain

#: the RG-LRU recurrence: the prefill scan (one ``rglru_scan`` kernel
#: launch on CUDA tensors, its plain version on CPU tensors) and the
#: one-step decode recurrence, plain on both devices as in the reference
rglru_scan = _rglru.rglru_scan
rglru_step = _rglru.rglru_step_plain

#: causal / sliding-window attention, q, k, v (B, H, S, D) with one head
#: count, as the kernel takes them.  The reference's ``ops.flash_attention``
#: hands that layout to the kernel on the TPU but (B, S, H, D) to its
#: oracle elsewhere; the port keeps the kernel's layout, left-aligned
#: causal mask and zero rows on both devices.
flash_attention = _flash.flash_attention_fwd
