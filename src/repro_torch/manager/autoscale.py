"""Serving autoscaler: replica-count control on cluster events (§4.4 for
the inference fleet).

The training ``Controller`` reacts to events by replanning (pp, mbs, d)
and pricing a transition; the serving fleet's knobs are different —
**how many replicas, of which type, where** — but the control shape is
the same: monitor → replan under the ``ServingObjective`` → adopt or
defer with hysteresis.

Event policy:

* ``NodeFailure`` / ``CapacityDown`` — if the current plan no longer fits
  the surviving capacity, replanning is **mandatory** (the fleet is
  serving with dead replicas); otherwise defer.
* ``CapacityUp`` / ``PriceChange`` — opportunistic: replan, adopt only if
  the new plan's $/token improves on the incumbent by at least
  ``min_gain`` (hysteresis against thrash on noisy spot prices), or if
  the incumbent now violates the SLO.
* ``Straggler`` — a replica is dragging the tail: replan and migrate if
  the fresh plan is at least as cheap (no hysteresis bar — the point is
  to move off the sick node, not to save money).

Every decision lands in ``decisions`` (the audit trail the tests and the
chaos suite read); an optional ``resize_fn`` hook receives
``(old_plan, new_plan, event)`` on every adoption so a launcher can
actually move replicas.

A copy of ``repro/manager/autoscale.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.objectives import ServingObjective
from repro_torch.core.planner.plan import ServingPlan
from repro_torch.core.simulator.serving import ServingSimResult
from repro_torch.manager.events import (CapacityDown, CapacityUp, ClusterEvent,
                                  NodeFailure, PriceChange, Straggler)
from repro_torch.manager.monitor import AvailabilityMonitor


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    min_gain: float = 0.05       # adopt on >= 5% $/token improvement
    replan_horizon_s: float = 120.0
    seed: int = 0


@dataclasses.dataclass
class AutoscaleDecision:
    time_s: float
    event: str                   # event.describe()
    action: str                  # start|scale_up|scale_down|migrate|defer
    reason: str
    n_replicas: int              # fleet size after the decision
    cost_per_token: float


def plan_fits_capacity(plan: ServingPlan, cluster: ClusterSpec) -> bool:
    """Does the placement still fit per-(zone, type) capacity?"""
    need: Dict[tuple, int] = {}
    for r in plan.decode + plan.prefill:
        key = (r.zone, r.gpu_type)
        need[key] = need.get(key, 0) + r.n_chips
    for (zone, acc), n in sorted(need.items()):
        try:
            have = cluster.zone(zone).capacity.get(acc, 0)
        except KeyError:
            return False
        if n > have:
            return False
    return True


class ServingController:
    """Monitor-driven replica autoscaling under a ServingObjective."""

    def __init__(self, planner, objective: ServingObjective,
                 monitor: AvailabilityMonitor,
                 cfg: AutoscaleConfig = AutoscaleConfig(),
                 resize_fn: Optional[Callable] = None):
        self.planner = planner
        self.objective = objective
        self.monitor = monitor
        self.cfg = cfg
        self.resize_fn = resize_fn
        self.current: Optional[ServingSimResult] = None
        self.decisions: List[AutoscaleDecision] = []

    # --- helpers -------------------------------------------------------------
    def _replan(self, cluster: ClusterSpec) -> Optional[ServingSimResult]:
        from repro_torch.core.planner.serving import plan_serving
        res = plan_serving(self.planner, cluster, self.objective,
                           horizon_s=self.cfg.replan_horizon_s,
                           seed=self.cfg.seed)
        return res.best

    def _record(self, t: float, event: str, action: str, reason: str):
        self.decisions.append(AutoscaleDecision(
            time_s=t, event=event, action=action, reason=reason,
            n_replicas=(self.current.plan.n_replicas
                        if self.current is not None else 0),
            cost_per_token=(self.current.cost_per_token
                            if self.current is not None else float("inf"))))

    def _adopt(self, new: ServingSimResult, t: float, event: str,
               reason: str, ev: Optional[ClusterEvent] = None):
        old = self.current
        action = "start"
        if old is not None:
            if new.plan.n_replicas > old.plan.n_replicas:
                action = "scale_up"
            elif new.plan.n_replicas < old.plan.n_replicas:
                action = "scale_down"
            else:
                action = "migrate"
        self.current = new
        if self.resize_fn is not None:
            self.resize_fn(old.plan if old is not None else None,
                           new.plan, ev)
        self._record(t, event, action, reason)

    # --- control -------------------------------------------------------------
    def start(self, t: float = 0.0) -> Optional[ServingSimResult]:
        best = self._replan(self.monitor.current)
        if best is None:
            self._record(t, "start", "defer", "no feasible serving plan")
            return None
        self._adopt(best, t, "start", "initial placement")
        return best

    def handle(self, event: ClusterEvent) -> None:
        cluster = event.cluster if event.cluster is not None \
            else self.monitor.current
        t = event.time_s
        if self.current is None:
            best = self._replan(cluster)
            if best is not None:
                self._adopt(best, t, event.describe(), "first feasible plan",
                            event)
            else:
                self._record(t, event.describe(), "defer", "still no plan")
            return
        if isinstance(event, (NodeFailure, CapacityDown)):
            if plan_fits_capacity(self.current.plan, cluster):
                self._record(t, event.describe(), "defer",
                             "plan unaffected by shrink")
                return
            best = self._replan(cluster)
            if best is None:
                self._record(t, event.describe(), "defer",
                             "no feasible plan on surviving capacity")
                return
            self._adopt(best, t, event.describe(),
                        "mandatory: lost replicas", event)
            return
        if isinstance(event, (CapacityUp, PriceChange)):
            best = self._replan(cluster)
            if best is None:
                self._record(t, event.describe(), "defer", "no candidate")
                return
            incumbent_ok = self.objective.satisfies(self.current)
            gain = best.cost_per_token \
                <= self.current.cost_per_token * (1.0 - self.cfg.min_gain)
            if (self.objective.satisfies(best)
                    and (gain or not incumbent_ok)):
                why = "cheaper $/token" if gain else "restores SLO"
                self._adopt(best, t, event.describe(), why, event)
            else:
                self._record(t, event.describe(), "defer",
                             "hysteresis: gain below threshold")
            return
        if isinstance(event, Straggler):
            best = self._replan(cluster)
            if best is not None and self.objective.satisfies(best) \
                    and best.cost_per_token <= self.current.cost_per_token:
                self._adopt(best, t, event.describe(),
                            "migrate off straggling replica", event)
            else:
                self._record(t, event.describe(), "defer",
                             "no better placement")
            return
        self._record(t, event.describe(), "defer", "event not actionable")

    def run(self, until_s: float) -> None:
        """Poll the monitor up to ``until_s`` and handle every event."""
        if self.current is None:
            self.start(0.0)
        for ev in self.monitor.poll(until_s):
            self.handle(ev)
