"""Root-cause analysis: cross-correlate streams before remediating.

A detector event says *something* is slow; the controller needs to know
*why* before it can pick the right remediation (paper §4.4's "slow
worker" path, generalized).  A reshard is useless against an input
pipeline stall, and routing around a zone is wrong when the chip — not
the link — is slow.  This layer classifies the event by comparing the
elevation of every stream family around the event time:

  ============ ===================================== ====================
  verdict      signature                             remediation
  ============ ===================================== ====================
  node-failure heartbeat silence (NodeFailure event) rollback + replan
  slow-link    p2p elevated, compute flat            route-around: replan
                                                     with the degraded
                                                     link model
  slow-chip    one worker's fwd/bwd elevated,        route-around: replan
               its p2p flat                          without the pool
  data-stall   data_stall elevated (or step_time     defer: reconfiguring
               up with compute and p2p both flat)    the job cannot help
  unknown      nothing sufficiently elevated         defer, keep watching
  ============ ===================================== ====================

Elevation is measured per stream as ``recent_median / frozen_baseline``
using the detector bank's own robust state, so the verdict and the
triggering event are judged on identical statistics.  The verdict is
threaded into ``manager.transition.TransitionModel.decide`` so the
decision audit records both what happened and why.

A copy of ``repro/telemetry/rca.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, Optional, Tuple

from repro_torch.manager.events import (ClusterEvent, LinkDegraded, NodeFailure,
                                  Straggler)
from repro_torch.telemetry.detectors import DetectorBank

SLOW_CHIP = "slow-chip"
SLOW_LINK = "slow-link"
DATA_STALL = "data-stall"
NODE_FAILURE = "node-failure"
UNKNOWN = "unknown"

# verdict -> remediation the controller should take (the decision table)
REMEDIATION = {
    SLOW_CHIP: "route-around",
    SLOW_LINK: "route-around",
    DATA_STALL: "defer",
    NODE_FAILURE: "rollback-replan",
    UNKNOWN: "defer",
}


@dataclasses.dataclass(frozen=True)
class RootCause:
    """The verdict: what is actually wrong, and how sure we are."""
    kind: str                 # SLOW_CHIP | SLOW_LINK | DATA_STALL | ...
    target: Tuple = ()        # stream key of the offending worker/link
    factor: float = 1.0       # elevation of the dominant signal
    confidence: float = 1.0   # 1.0 clean signature; lower when ambiguous
    evidence: Dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def remediation(self) -> str:
        return REMEDIATION[self.kind]

    def describe(self) -> str:
        tgt = f" @{self.target}" if self.target else ""
        return (f"{self.kind}{tgt} x{self.factor:.2f} "
                f"(conf {self.confidence:.2f}) -> {self.remediation}")


class RootCauseAnalyzer:
    """Classify detector events by cross-stream elevation ratios.

    ``elevation`` is the minimum recent/baseline ratio for a stream family
    to count as "elevated"; ``recent`` is how many trailing per-step
    aggregates form the recent median.  Ratios come from the bus's ring
    buffers plus the bank's frozen baselines, so classification uses
    exactly the data the detectors judged.
    """

    def __init__(self, bank: DetectorBank, elevation: float = 1.25,
                 recent: int = 4):
        self.bank = bank
        self.elevation = elevation
        self.recent = recent

    # --- stream statistics -----------------------------------------------------
    def _ratio(self, metric: str, key: Tuple) -> float:
        """recent_median / baseline for one stream (1.0 = no elevation)."""
        vals = self.bank.bus.values(metric, key)
        if not vals:
            return 1.0
        cur = statistics.median(vals[-self.recent:])
        det = self.bank.detectors.get((metric, key))
        if det is not None and det.baseline > 0:
            base = det.baseline
        elif det is not None and det.median() > 0:
            base = det.median()
        else:
            # no detector state: first half of the buffer is the baseline
            head = vals[:max(len(vals) // 2, 1)]
            base = statistics.median(head)
        return cur / max(base, 1e-12)

    def _family(self, metric: str) -> Dict[Tuple, float]:
        return {key: self._ratio(metric, key)
                for key in self.bank.bus.keys(metric)}

    @staticmethod
    def _peak(ratios: Dict[Tuple, float]) -> Tuple[Tuple, float]:
        if not ratios:
            return (), 1.0
        key = max(sorted(ratios), key=lambda k: ratios[k])
        return key, ratios[key]

    # --- classification --------------------------------------------------------
    def classify(self, event: Optional[ClusterEvent] = None) -> RootCause:
        """Verdict for ``event`` (or for the current stream state)."""
        if isinstance(event, NodeFailure):
            return RootCause(NODE_FAILURE,
                             target=(event.zone, event.acc_type),
                             factor=float("inf"),
                             evidence={"lost": event.lost})

        comp: Dict[Tuple, float] = {}
        for metric in ("fwd_time", "bwd_time"):
            for key, r in self._family(metric).items():
                comp[key] = max(comp.get(key, 1.0), r)
        link = self._family("p2p_time")
        comp_key, comp_r = self._peak(comp)
        link_key, link_r = self._peak(link)
        stall_r = self._ratio("data_stall", ())
        step_r = self._ratio("step_time", ())
        ev = {"compute": comp_r, "link": link_r, "stall": stall_r,
              "step": step_r, "compute_at": comp_key, "link_at": link_key}

        comp_up = comp_r >= self.elevation
        link_up = link_r >= self.elevation
        stall_up = stall_r >= self.elevation

        if isinstance(event, LinkDegraded) and not comp_up:
            return RootCause(SLOW_LINK, target=link_key, factor=link_r,
                             evidence=ev)
        if comp_up and link_up:
            # ambiguous: both families moved — dominant signal wins with
            # reduced confidence (a truly slow link also inflates the
            # *blocked* worker's step, but not its fwd/bwd compute, so a
            # clean instrumentation keeps this branch rare).
            kind = SLOW_CHIP if comp_r >= link_r else SLOW_LINK
            tgt = comp_key if kind == SLOW_CHIP else link_key
            return RootCause(kind, target=tgt,
                             factor=max(comp_r, link_r),
                             confidence=0.5, evidence=ev)
        if comp_up:
            return RootCause(SLOW_CHIP, target=comp_key, factor=comp_r,
                             evidence=ev)
        if link_up:
            return RootCause(SLOW_LINK, target=link_key, factor=link_r,
                             evidence=ev)
        if stall_up or (step_r >= self.elevation):
            # step time (or the stall stream itself) is up while compute
            # and transfers are flat: the input pipeline is starving us.
            return RootCause(DATA_STALL, target=(),
                             factor=max(stall_r, step_r),
                             confidence=1.0 if stall_up else 0.7,
                             evidence=ev)
        return RootCause(UNKNOWN, factor=max(comp_r, link_r, step_r),
                         confidence=0.0, evidence=ev)
