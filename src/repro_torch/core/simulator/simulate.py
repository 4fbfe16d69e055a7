"""Simulator facade (paper Fig. 4 component 3).

``simulate(profile, plan, cluster)`` -> SimResult with iteration time,
per-worker peak memory + OOM validity, and $/iteration.  The planner calls
this to rank candidates; the benchmarks call it to evaluate *every*
baseline's plans under one consistent model (the paper's §5.2 methodology).
Timing comes from the event engine (``core/simulator/engine.py``) behind
the ``timing.iteration_time`` facade; pass ``engine_cfg`` to change the
schedule / overlap / calibrated-overhead knobs.

A copy of ``repro/core/simulator/simulate.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner import plan as serving_plan
from repro_torch.core.planner.plan import ParallelPlan
from repro_torch.core.profiler.analytic import JobProfile
from repro_torch.core.simulator import cost as cost_mod
from repro_torch.core.simulator import engine as eng
from repro_torch.core.simulator import memory as mem_mod
from repro_torch.core.simulator import timing as time_mod

# Below this, an iteration time is a degenerate-profile artifact (zero-cost
# calibrated stages), not a prediction: flag the plan instead of dividing.
MIN_ITER_TIME_S = 1e-9


@dataclasses.dataclass
class SimResult:
    plan: ParallelPlan
    valid: bool                  # memory-feasible AND non-degenerate timing
    t_iter: float
    throughput: float            # iterations / second
    samples_per_s: float
    cost_per_iter: float
    cost_comp: float
    cost_comm: float
    peak_mem: List[List[Dict]]   # per stage, per replica
    timing: time_mod.TimingBreakdown
    plan_seq_len: int = 0
    degenerate: bool = False     # timing below MIN_ITER_TIME_S / non-finite
    # fingerprint of the cluster this result was simulated against — lets a
    # consumer (the planner's incumbent revalidation) *verify* a SimResult
    # applies to the cluster at hand instead of trusting the caller.
    cluster_fp: tuple = ()

    @property
    def tokens_per_s(self) -> float:
        return self.samples_per_s * self.plan_seq_len


def simulate(profile: JobProfile, plan: ParallelPlan,
             cluster: ClusterSpec,
             mem_cfg: mem_mod.MemoryModelConfig = mem_mod.DEFAULT_MEM,
             engine_cfg: Optional[eng.EngineConfig] = None) -> SimResult:
    if isinstance(plan, serving_plan.ServingPlan):
        # workload-generic facade: a ServingPlan routes to the serving-mode
        # engine (horizon-based, tail-latency report) instead of forking
        # the caller on plan type; training-only memory streams are zeroed
        # while calibration knobs (fragmentation, overhead) carry over
        from repro_torch.core.simulator import serving as serving_mod
        return serving_mod.simulate_serving(
            profile, plan, cluster,
            mem_cfg=mem_mod.serving_mem_cfg(mem_cfg))
    plan.validate()
    if engine_cfg is not None and \
            (engine_cfg.schedule, engine_cfg.virtual_stages) != \
            (mem_cfg.schedule, mem_cfg.virtual_stages):
        # memory feasibility must be judged under the schedule being timed:
        # interleaving holds more in-flight activations than 1F1B.
        mem_cfg = dataclasses.replace(
            mem_cfg, schedule=engine_cfg.schedule,
            virtual_stages=engine_cfg.virtual_stages)
    mem = mem_mod.plan_memory(profile, plan, mem_cfg)
    valid = all(r["ok"] for row in mem for r in row)
    t = time_mod.iteration_time(profile, plan, cluster, engine_cfg)
    degenerate = not (math.isfinite(t.t_iter)
                      and t.t_iter >= MIN_ITER_TIME_S)
    c = cost_mod.iteration_cost(profile, plan, cluster, t.t_iter)
    if degenerate:
        throughput = samples_per_s = 0.0
        valid = False
    else:
        throughput = 1.0 / t.t_iter
        samples_per_s = plan.global_batch / t.t_iter
    return SimResult(
        plan=plan, valid=valid, t_iter=t.t_iter,
        throughput=throughput,
        samples_per_s=samples_per_s,
        cost_per_iter=c["total"], cost_comp=c["comp"], cost_comm=c["comm"],
        peak_mem=mem, timing=t, plan_seq_len=profile.job.seq_len,
        degenerate=degenerate, cluster_fp=cluster.fingerprint())
