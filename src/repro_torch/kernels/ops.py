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
plain PyTorch on a CPU tensor).  The reference's numpy/jax/pallas backend switch and its
block-size autotuners have no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

from . import fused_step, mlstm_chunk, pac_eval, rglru_scan as _rglru
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
              active=None) -> StepOutputs:
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
    if spec.metric == "availability":
        kernel = fused_step.fused_pac_eval if spec.packed \
            else pac_eval.pac_eval
        lark, maj, creps = kernel(up, full, rf=spec.rf,
                                  voters=spec.resolved_voters,
                                  n_real=spec.n_real)
        return StepOutputs(lark=lark, maj=maj, creps=creps)

    # rleader elects among the carried roster, so a roster-less call
    # (e.g. the engines' t=0 init eval) simply doesn't produce it
    want_rm = spec.want_repmask
    want_rl = spec.want_rleader and roster is not None
    if spec.packed:
        outs = fused_step.fused_downtime_eval(
            up, full, rf=spec.rf, n_real=spec.n_real, roster=roster,
            recruit=recruit, active=active, want_repmask=want_rm,
            want_rleader=want_rl)
        ncr = 6 + int(want_rm) + int(want_rl)
        counts = outs[ncr] if recruit is not None else None
        creps = outs[ncr - 1]
    else:
        outs = pac_eval.downtime_eval(
            up, full, rf=spec.rf, n_real=spec.n_real, roster=roster,
            want_repmask=want_rm, want_rleader=want_rl, recruit=recruit,
            active=active)
        counts = outs[-1] if recruit is not None else None
        creps = outs[-2] if recruit is not None else outs[-1]
    repmask, rleader = _take_extras(outs, want_rm, want_rl)
    return StepOutputs(lark=outs[0], maj=outs[1], leader=outs[2],
                       leader_full=outs[3], nrep=outs[4], creps=creps,
                       counts=counts, repmask=repmask, rleader=rleader)


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
