"""Shared scaffolding for baseline planner re-implementations.

Methodology (paper §5.2): every baseline ranks candidate plans with its OWN
internal cost/memory model (reproducing each system's documented
simplifications — that is the point of the comparison), and all plans are
then evaluated under the one Sailor simulator.  ``evaluate_ranked`` walks a
baseline's ranking best-first, counting plans that would OOM (the bold
numbers atop the paper's Fig. 8/9 bars) until the first valid plan.

All baselines receive the paper's fixed topology: 4-chip VMs per GPU type;
they do not co-optimize the resource allocation (that is Sailor's edge).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.objectives import Objective
from repro_torch.core.planner.plan import ParallelPlan
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.core.simulator.simulate import SimResult, simulate


@dataclasses.dataclass
class BaselineResult:
    name: str
    ranked_plans: List[ParallelPlan]          # best-first by internal model
    search_time_s: float
    meta: Dict = dataclasses.field(default_factory=dict)


def evaluate_ranked(result: BaselineResult, profile: JobProfile,
                    cluster: ClusterSpec, objective: Objective,
                    max_tries: int = 200
                    ) -> Tuple[Optional[SimResult], int]:
    """(first plan valid under the Sailor simulator+constraints, #OOM tried)."""
    n_oom = 0
    for plan in result.ranked_plans[:max_tries]:
        res = simulate(profile, plan, cluster)
        if not res.valid:
            n_oom += 1
            continue
        if objective.satisfies(res):
            return res, n_oom
    return None, n_oom


def powers_of_two(n: int) -> List[int]:
    out, v = [], 1
    while v <= n:
        out.append(v)
        v *= 2
    return out


def grid_dpt(n_chips: int, n_layers: int, global_batch: int,
             max_tp: int = 8, max_pp: int = 32):
    """All (dp, pp, tp, mbs) with dp*pp*tp <= n_chips (classic 3D grid)."""
    for tp in powers_of_two(max_tp):
        for pp in [p for p in (1, 2, 4, 8, 16, 32) if p <= min(max_pp, n_layers)]:
            rest = n_chips // (tp * pp)
            for dp in powers_of_two(rest):
                for mbs in (1, 2, 4, 8):
                    if global_batch % (dp * mbs) == 0:
                        yield dp, pp, tp, mbs


def fastest_type(cluster: ClusterSpec) -> str:
    from repro_torch.core.profiler.hw_specs import get_accelerator
    return max(cluster.gpu_types(),
               key=lambda t: get_accelerator(t).peak_flops)


def first_zone_with(cluster: ClusterSpec, gpu_type: str) -> str:
    for z in cluster.zones:
        if z.capacity.get(gpu_type, 0) > 0:
            return z.name
    return cluster.zones[0].name
