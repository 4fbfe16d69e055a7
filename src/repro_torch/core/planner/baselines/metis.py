"""Metis-like planner [Um+ ATC'24] — heterogeneous exhaustive search.

Per the paper: accurate-ish runtime/memory estimation, load-balanced layer
partitioning, exhaustive enumeration of device-group combinations — and
therefore search times of HOURS on tens of GPUs; the paper caps it at 300s
and uses the best plan found.  Reproduced: exhaustive enumeration over
(pp, mbs, per-stage gpu-type assignment, tp per stage — including
cross-node TP, which Sailor's H1 forbids), wall-clock capped.
It does not model heterogeneous inter-node bandwidth (28% time error in
Fig. 6), so its internal estimate ignores link classes entirely.
"""
from __future__ import annotations

import itertools
import time
from typing import List

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.baselines import common
from repro_torch.core.planner.plan import ParallelPlan, StageConfig, StageReplica
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.core.profiler.hw_specs import get_accelerator
from repro_torch.core.simulator import memory as mem


def plan(job: TrainJob, cluster: ClusterSpec,
         time_cap_s: float = 300.0) -> common.BaselineResult:
    t0 = time.perf_counter()
    profile = JobProfile(job)
    types = cluster.gpu_types()
    zone_of = {t: common.first_zone_with(cluster, t) for t in types}
    avail = {t: cluster.total_chips(t) for t in types}
    scored = []
    n_units = profile.n_partition_units
    capped = False
    for pp in (1, 2, 4, 8, 16):
        if pp > job.cfg.n_layers:
            continue
        per = n_units // pp
        bounds = [i * per for i in range(pp)] + [n_units]
        for mbs in (1, 2, 4, 8):
            # exhaustive: per-stage (type, tp) assignment, incl. tp>node
            opts = [(t, tp) for t in types
                    for tp in (1, 2, 4, 8, 16)]
            for assign in itertools.product(opts, repeat=pp):
                if time.perf_counter() - t0 > time_cap_s:
                    capped = True
                    break
                used = {}
                for t, tp in assign:
                    used[t] = used.get(t, 0) + tp
                # uniform dp across stages given leftover capacity
                d_max = min(avail[t] // u for t, u in used.items())
                for dp in common.powers_of_two(max(d_max, 0)):
                    if job.global_batch % (dp * mbs) != 0:
                        continue
                    stages = tuple(
                        StageConfig(bounds[i], bounds[i + 1],
                                    tuple(StageReplica(assign[i][0],
                                                       assign[i][1],
                                                       zone_of[assign[i][0]])
                                          for _ in range(dp)))
                        for i in range(pp))
                    p = ParallelPlan(stages, mbs, job.global_batch)
                    est = 0.0
                    units = []
                    for i in range(pp):
                        t, tp = assign[i]
                        fwd, bwd, _ = profile.stage_cost(
                            bounds[i], bounds[i + 1], t, tp, mbs)
                        units.append(fwd + bwd)
                    est = (sum(units)
                           + (p.num_microbatches - 1) * max(units))
                    # Metis memory check (roughly accurate): routed through
                    # the shared peak-bytes kernel like every other planner
                    if not mem.plan_fits(profile, p):
                        continue
                    scored.append((est, p))
            if capped:
                break
        if capped:
            break
    scored.sort(key=lambda sp: sp[0])
    return common.BaselineResult(
        name="metis", ranked_plans=[pl for _, pl in scored],
        search_time_s=time.perf_counter() - t0,
        meta={"time_capped": capped})
