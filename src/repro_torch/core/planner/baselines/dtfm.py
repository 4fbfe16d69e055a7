"""DTFM-like planner [Yuan+ 2023 'Decentralized training of foundation
models'] — geo-distributed 2D partitioner.

Per the paper: DTFM does NOT choose parallelism degrees — it takes (dp, pp)
grids as input and assigns device groups to zones minimizing its
communication cost function; the paper drives it by exhaustively generating
all homogeneous 2D plans ("DTFM-exhaustive").  Its cost function ranks by
time spent in DP+PP *communication only* (no compute, no memory model) —
the suboptimality Fig. 10 shows.  Uses the fastest GPU type across zones.
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.baselines import common
from repro_torch.core.planner.plan import ParallelPlan, StageConfig, StageReplica
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile, TrainJob
from repro_torch.core.simulator import network


def plan(job: TrainJob, cluster: ClusterSpec) -> common.BaselineResult:
    t0 = time.perf_counter()
    profile = JobProfile(job)
    gpu = common.fastest_type(cluster)
    zones = [z for z in cluster.zones if z.capacity.get(gpu, 0) > 0]
    n = sum(z.capacity[gpu] for z in zones)
    n_units = profile.n_partition_units
    scored = []
    for pp in (1, 2, 4, 8, 16):
        if pp > job.cfg.n_layers:
            continue
        per = n_units // pp
        bounds = [i * per for i in range(pp)] + [n_units]
        for dp in common.powers_of_two(n // pp):
            for mbs in (1, 2, 4):
                if job.global_batch % (dp * mbs) != 0:
                    continue
                # zone assignment: fill zones stage-by-stage (their greedy
                # partition keeps PP groups zone-local where possible)
                caps = {z.name: z.capacity[gpu] for z in zones}
                stages = []
                ok = True
                for i in range(pp):
                    reps = []
                    for _ in range(dp):
                        zn = max(caps, key=lambda k: caps[k])
                        if caps[zn] < 1:
                            ok = False
                            break
                        caps[zn] -= 1
                        reps.append(StageReplica(gpu, 1, zn))
                    if not ok:
                        break
                    stages.append(StageConfig(bounds[i], bounds[i + 1],
                                              tuple(reps)))
                if not ok:
                    continue
                p = ParallelPlan(tuple(stages), mbs, job.global_batch)
                # DTFM cost fn: zone assignment ranked by communication;
                # a crude uniform compute term keeps the (d, p) outer
                # choice sane (their flaw is the *geo* cost function, not
                # ignorance of compute altogether)
                per = profile.stage_cost(bounds[0], bounds[1], gpu, 1, mbs)
                est = (per[0] + per[1]) * pp * p.num_microbatches
                act = profile.boundary_bytes(mbs)
                for i in range(pp - 1):
                    for d in range(dp):
                        link = cluster.link_between(
                            stages[i].replicas[d].zone,
                            stages[i + 1].replicas[d].zone)
                        est += network.p2p_time(link, act) \
                            * p.num_microbatches
                for i in range(pp):
                    zs = stages[i].zones()
                    link = cluster.links["intra-zone"] if len(zs) == 1 else \
                        max((cluster.link_between(a, b)
                             for a in zs for b in zs if a != b),
                            key=lambda l: 1 / l.beta)
                    est += network.all_reduce_time(
                        link, profile.stage_params(
                            bounds[i], bounds[i + 1]) * DTYPE_BYTES, dp)
                scored.append((est, p))
    scored.sort(key=lambda sp: sp[0])
    return common.BaselineResult(
        name="dtfm", ranked_plans=[pl for _, pl in scored],
        search_time_s=time.perf_counter() - t0)
