"""Galvatron-like planner [Miao+ VLDB'23] — homogeneous auto-parallelism.

Decision-tree search over (dp, tp, pp) with activation-recompute on/off and
a decent memory model; assumes homogeneous devices and flat bandwidth
(Table 1 row: 3D, no allocation, no heterogeneity, no multi-zone).
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.baselines import common
from repro_torch.core.planner.plan import homogeneous_plan
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.core.profiler.hw_specs import get_accelerator
from repro_torch.core.simulator import memory as mem


def plan(job: TrainJob, cluster: ClusterSpec) -> common.BaselineResult:
    t0 = time.perf_counter()
    gpu = common.fastest_type(cluster)
    zone = common.first_zone_with(cluster, gpu)
    n = cluster.total_chips(gpu)
    acc = get_accelerator(gpu)
    scored = []
    for remat in ("full", "none"):
        job_r = dataclasses.replace(job, remat=remat)
        profile = JobProfile(job_r)
        for dp, pp, tp, mbs in common.grid_dpt(
                n, job.cfg.n_layers, job.global_batch,
                max_tp=acc.chips_per_node):
            if dp * pp * tp > n:
                continue
            p = homogeneous_plan(gpu, zone, pp, dp, tp,
                                 profile.n_partition_units, mbs,
                                 job.global_batch)
            # shared measured peak-bytes kernel (remat-aware per profile)
            if not mem.plan_fits(profile, p):
                continue
            over = 1.0 if remat == "full" else 0.75   # recompute saves bwd
            units = []
            for st in p.stages:
                fwd, bwd, _ = profile.stage_cost(st.layer_start,
                                                 st.layer_end, gpu, tp, mbs)
                units.append(fwd + bwd * over)
            est = sum(units) + (p.num_microbatches - 1) * max(units)
            scored.append((est, p))
    scored.sort(key=lambda sp: sp[0])
    return common.BaselineResult(
        name="galvatron", ranked_plans=[pl for _, pl in scored],
        search_time_s=time.perf_counter() - t0)
