"""Piper-like planner [Tarnawski+ NeurIPS'21] — homogeneous 3D DP.

Per the paper's Table 1: supports 3D parallelism, does NOT recommend the
resource allocation, no heterogeneity, no multi-zone.  Fast (<1s) dynamic
programming over uniform (dp, pp, tp) splits with a compute+p2p internal
model and a reasonable memory model.  Uses only the fastest GPU type.
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.baselines import common
from repro_torch.core.planner.plan import ParallelPlan, homogeneous_plan
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.core.profiler.hw_specs import get_accelerator
from repro_torch.core.simulator import memory as mem


def plan(job: TrainJob, cluster: ClusterSpec) -> common.BaselineResult:
    t0 = time.perf_counter()
    profile = JobProfile(job)
    gpu = common.fastest_type(cluster)
    zone = common.first_zone_with(cluster, gpu)
    n = cluster.total_chips(gpu)
    acc = get_accelerator(gpu)
    scored = []
    for dp, pp, tp, mbs in common.grid_dpt(
            n, job.cfg.n_layers, job.global_batch,
            max_tp=acc.chips_per_node):
        if dp * pp * tp > n:
            continue
        p = homogeneous_plan(gpu, zone, pp, dp, tp,
                             profile.n_partition_units, mbs,
                             job.global_batch)
        # internal model: 1F1B with per-stage times (Piper models the
        # pipeline correctly; its gap vs Sailor is allocation/heterogeneity)
        units = []
        for st in p.stages:
            fwd, bwd, _ = profile.stage_cost(st.layer_start, st.layer_end,
                                             gpu, tp, mbs)
            units.append(fwd + bwd)
        est = sum(units) + (p.num_microbatches - 1) * max(units)
        # memory check (Piper models memory reasonably well): the shared
        # measured peak-bytes kernel, same verdict as simulate()
        if not mem.plan_fits(profile, p):
            continue
        scored.append((est, p))
    scored.sort(key=lambda sp: sp[0])
    return common.BaselineResult(
        name="piper", ranked_plans=[p for _, p in scored],
        search_time_s=time.perf_counter() - t0)
