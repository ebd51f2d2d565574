"""The per-step evaluation API (port of ``repro/kernels/ops.py``'s
``StepSpec`` / ``StepOutputs`` / ``step_eval``, availability metric).

``StepSpec`` and ``StepOutputs`` are copied from the reference, so one
frozen spec names the same step on both sides.  ``step_eval`` maps a
spec onto a kernel by layout:

  packed=False  (R, n_pad) bool rank-space tiles  -> pac_eval.pac_eval
  packed=True   (B, W, P) int32 word planes       -> fused_step.fused_pac_eval

and each kernel wrapper dispatches by the tensor's device (CUDA kernel on
a CUDA tensor, plain PyTorch on a CPU tensor).  The reference's
numpy/jax/pallas backend switch and its block-size autotuners have no
counterpart here.  The §6 downtime metric is still to be ported (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

from . import fused_step, pac_eval

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


def step_eval(spec: StepSpec, up, full) -> StepOutputs:
    """Evaluate one Monte Carlo step under `spec`.

    Boolean layout (spec.packed=False): up/full are (R, n_pad) bool
    rank-space tiles; outputs are lark/maj (R,) and creps (R, n_pad).
    Packed layout (spec.packed=True): up/full are (B, W, P) int32 word
    planes (bit b of word k = succession rank 32k+b); outputs are lark/maj
    (B, P) and creps as (B, W, P) words.  Both layouts give the same bits.
    """
    if spec.metric != "availability":
        raise NotImplementedError(
            f"step_eval metric {spec.metric!r} is not ported yet: the §6 "
            "downtime evaluation is ROADMAP Queue 1 item 5")
    kernel = fused_step.fused_pac_eval if spec.packed else pac_eval.pac_eval
    lark, maj, creps = kernel(up, full, rf=spec.rf,
                              voters=spec.resolved_voters,
                              n_real=spec.n_real)
    return StepOutputs(lark=lark, maj=maj, creps=creps)
