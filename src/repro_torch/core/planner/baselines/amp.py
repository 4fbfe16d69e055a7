"""AMP-like planner [Li+ 2022, arXiv:2210.07297] — heterogeneity-aware cost
model but homogeneous plans and NO memory model.

Paper findings reproduced here: AMP ranks well on homogeneous clusters, but
(a) emits uniform plans that cannot load-balance mixed A100+V100 pools, and
(b) without a memory model it emits many OOM plans (Fig. 8/9 bold counts).
Its internal time estimate averages device speeds across the pool.
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.baselines import common
from repro_torch.core.planner.plan import ParallelPlan, StageConfig, StageReplica, homogeneous_plan
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.core.profiler.hw_specs import get_accelerator


def plan(job: TrainJob, cluster: ClusterSpec) -> common.BaselineResult:
    t0 = time.perf_counter()
    profile = JobProfile(job)
    types = cluster.gpu_types()
    n_total = cluster.total_chips()
    # pool-average speed factor (AMP's heterogeneity awareness)
    weights = {t: cluster.total_chips(t) / n_total for t in types}
    scored = []
    for dp, pp, tp, mbs in common.grid_dpt(n_total, job.cfg.n_layers,
                                           job.global_batch):
        if dp * pp * tp > n_total:
            continue
        # materialize on the mixed pool round-robin (uniform degrees)
        reps_pool = []
        for z in cluster.zones:
            for t, cnt in z.capacity.items():
                reps_pool += [(t, z.name)] * (cnt // tp)
        if len(reps_pool) < dp * pp:
            continue
        stages = []
        per = profile.n_partition_units // pp
        k = 0
        ok = True
        for i in range(pp):
            lo = i * per
            hi = profile.n_partition_units if i == pp - 1 else (i + 1) * per
            reps = []
            for _ in range(dp):
                t, zn = reps_pool[k]
                k += 1
                reps.append(StageReplica(t, tp, zn))
            stages.append(StageConfig(lo, hi, tuple(reps)))
        p = ParallelPlan(tuple(stages), mbs, job.global_batch)
        # internal estimate: 1F1B with pool-AVERAGED speeds per stage
        # (AMP's documented flaw: no straggler modeling) and NO memory check
        units = []
        for st in stages:
            u = 0.0
            for t in types:
                fwd, bwd, _ = profile.stage_cost(st.layer_start,
                                                 st.layer_end, t, tp, mbs)
                u += weights[t] * (fwd + bwd)
            units.append(u)
        est = sum(units) + (p.num_microbatches - 1) * max(units)
        scored.append((est, p))
    scored.sort(key=lambda sp: sp[0])
    return common.BaselineResult(
        name="amp", ranked_plans=[pl for _, pl in scored],
        search_time_s=time.perf_counter() - t0)
