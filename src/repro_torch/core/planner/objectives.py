"""User objectives + constraints (paper Fig. 4 inputs).

A copy of ``repro/core/planner/objectives.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.simulator.simulate import SimResult

MAX_THROUGHPUT = "max_throughput"
MIN_COST = "min_cost"
MIN_COST_PER_TOKEN = "min_cost_per_token"


@dataclasses.dataclass(frozen=True)
class Objective:
    kind: str = MAX_THROUGHPUT
    # constraints (paper: budget per iteration / min throughput)
    max_cost_per_iter: Optional[float] = None      # $ per iteration
    min_throughput: Optional[float] = None         # iterations per second

    def satisfies(self, r: SimResult) -> bool:
        if not r.valid:
            return False
        if self.max_cost_per_iter is not None \
                and r.cost_per_iter > self.max_cost_per_iter:
            return False
        if self.min_throughput is not None \
                and r.throughput < self.min_throughput:
            return False
        return True

    def score(self, r: SimResult) -> float:
        """Lower is better."""
        if self.kind == MAX_THROUGHPUT:
            return r.t_iter
        return r.cost_per_iter

    def better(self, a: Optional[SimResult], b: SimResult) -> bool:
        """Is b better than a (both assumed to satisfy constraints)?"""
        if a is None:
            return True
        return self.score(b) < self.score(a)


@dataclasses.dataclass(frozen=True)
class ServingObjective:
    """Serving sibling of :class:`Objective`: minimize $/generated-token
    subject to tail-latency SLOs.  ``SailorPlanner.plan()`` dispatches on
    this type to the serving search; ``satisfies``/``score``/``better``
    take a ``ServingSimResult`` (core/simulator/serving)."""

    kind: str = MIN_COST_PER_TOKEN
    slo_ttft_p99_s: Optional[float] = None     # time-to-first-token, p99
    slo_tpot_p99_s: Optional[float] = None     # time-per-output-token, p99
    max_cost_per_token: Optional[float] = None  # $ per generated token

    def satisfies(self, r) -> bool:
        if not r.valid:
            return False
        if self.slo_ttft_p99_s is not None \
                and r.ttft_p99 > self.slo_ttft_p99_s:
            return False
        if self.slo_tpot_p99_s is not None \
                and r.tpot_p99 > self.slo_tpot_p99_s:
            return False
        if self.max_cost_per_token is not None \
                and r.cost_per_token > self.max_cost_per_token:
            return False
        return True

    def score(self, r) -> float:
        """Lower is better ($ per generated token)."""
        return r.cost_per_token

    def better(self, a, b) -> bool:
        if a is None:
            return True
        return self.score(b) < self.score(a)
