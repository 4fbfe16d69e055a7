"""FlashFlex-like planner [Yan+ 2024] — heterogeneous, fast, theoretical.

Per the paper: short runtime but "relies on the theoretical performance of
GPUs" (69% iteration-time error) and uses low TP/microbatch sizes, and its
memory estimation is uniform across stages.  Reproduced: stages are sized
proportional to peak TFLOPS (not profiled throughput), tp in {1,2},
mbs in {1,2}, memory checked with a uniform per-stage model.
"""
from __future__ import annotations

import time
from typing import List

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.baselines import common
from repro_torch.core.planner.plan import ParallelPlan, StageConfig, StageReplica
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.core.profiler.hw_specs import get_accelerator


def plan(job: TrainJob, cluster: ClusterSpec) -> common.BaselineResult:
    t0 = time.perf_counter()
    profile = JobProfile(job)
    types = sorted(cluster.gpu_types(),
                   key=lambda t: -get_accelerator(t).peak_flops)
    zone_of = {t: common.first_zone_with(cluster, t) for t in types}
    n_units = profile.n_partition_units
    scored = []
    for pp in (2, 4, 8, 16):
        if pp > job.cfg.n_layers or pp % len(types) != 0:
            continue
        # assign stage groups to types, layers proportional to peak FLOPS
        flops = [get_accelerator(t).peak_flops for t in types]
        tot = sum(cluster.total_chips(t) * f for t, f in zip(types, flops))
        stages_per_type = pp // len(types)
        for tp in (1, 2):
            for mbs in (1, 2):
                avail = {t: cluster.total_chips(t) for t in types}
                d_max = min(avail[t] // (tp * stages_per_type) for t in types)
                for dp in common.powers_of_two(max(d_max, 0)):
                    if job.global_batch % (dp * mbs) != 0:
                        continue
                    # layer split proportional to type share of peak FLOPS
                    shares = [cluster.total_chips(t) * f / tot
                              for t, f in zip(types, flops)]
                    bounds = [0]
                    for t, sh in zip(types, shares):
                        span = max(1, round(sh * n_units))
                        for k in range(stages_per_type):
                            bounds.append(min(
                                bounds[-1] + max(1, span // stages_per_type),
                                n_units - (pp - len(bounds))))
                    bounds = bounds[:pp] + [n_units]
                    for k in range(1, pp + 1):
                        bounds[k] = max(bounds[k], bounds[k - 1] + 1)
                    bounds[-1] = n_units
                    stages = []
                    for i in range(pp):
                        t = types[min(i // stages_per_type, len(types) - 1)]
                        stages.append(StageConfig(
                            bounds[i], bounds[i + 1],
                            tuple(StageReplica(t, tp, zone_of[t])
                                  for _ in range(dp))))
                    p = ParallelPlan(tuple(stages), mbs, job.global_batch)
                    # theoretical-FLOPs internal estimate (no efficiency!)
                    est = 0.0
                    for i, st in enumerate(stages):
                        t = st.replicas[0].gpu_type
                        fl = sum(profile._layer_flops_per_token(k)
                                 for k in profile.layer_kinds()
                                 [st.layer_start:st.layer_end])
                        est = max(est, 3 * fl * mbs * job.seq_len
                                  / (get_accelerator(t).peak_flops * tp))
                    est *= p.num_microbatches
                    # uniform memory check (their flaw): stage-0 only
                    st = stages[0]
                    m = (profile.stage_params(st.layer_start, st.layer_end)
                         * 14 / tp)
                    if m > get_accelerator(  # lint: disable=mem-feasibility
                            st.replicas[0].gpu_type).mem_bytes:
                        continue
                    scored.append((est, p))
    scored.sort(key=lambda sp: sp[0])
    return common.BaselineResult(
        name="flashflex", ranked_plans=[pl for _, pl in scored],
        search_time_s=time.perf_counter() - t0)
