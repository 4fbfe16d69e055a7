"""Varuna-like planner [Athlur+ EuroSys'22] — 2D (DP x PP) exhaustive with a
leaky memory model.

Per the paper: Varuna only supports 2D parallelism and "overlooks
significant memory sources (optimizer, communication)" — reproduced by a
memory model that only counts parameters + one microbatch of activations
(mul_factor 2 instead of 14), so its top-ranked plans frequently OOM
(§5.2.1: Varuna failed to produce a valid plan)."""
from __future__ import annotations

import time

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.baselines import common
from repro_torch.core.planner.plan import homogeneous_plan
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile, TrainJob
from repro_torch.core.profiler.hw_specs import get_accelerator


def plan(job: TrainJob, cluster: ClusterSpec) -> common.BaselineResult:
    t0 = time.perf_counter()
    profile = JobProfile(job)
    gpu = common.fastest_type(cluster)
    zone = common.first_zone_with(cluster, gpu)
    n = cluster.total_chips(gpu)
    acc = get_accelerator(gpu)
    scored = []
    for pp in (1, 2, 4, 8, 16, 32):
        if pp > job.cfg.n_layers:
            continue
        for dp in common.powers_of_two(n // pp):
            for mbs in (1, 2, 4, 8):
                if job.global_batch % (dp * mbs) != 0:
                    continue
                p = homogeneous_plan(gpu, zone, pp, dp, 1,
                                     profile.n_partition_units, mbs,
                                     job.global_batch)
                # Varuna's leaky memory model: params*2 + one micro of acts
                oom = False
                units = []
                for st in p.stages:
                    m = (profile.stage_params(st.layer_start, st.layer_end) * 2
                         + profile.stage_act_store(st.layer_start,
                                                   st.layer_end, mbs))
                    # raw capacity on purpose: reproducing Varuna's own
                    # leaky feasibility check, not ours
                    if m > acc.mem_bytes:  # lint: disable=mem-feasibility
                        oom = True
                    fwd, bwd, _ = profile.stage_cost(
                        st.layer_start, st.layer_end, gpu, 1, mbs)
                    units.append(fwd + bwd)
                if oom:
                    continue
                est = sum(units) + (p.num_microbatches - 1) * max(units)
                scored.append((est, p))
    scored.sort(key=lambda sp: sp[0])
    return common.BaselineResult(
        name="varuna", ranked_plans=[pl for _, pl in scored],
        search_time_s=time.perf_counter() - t0)
