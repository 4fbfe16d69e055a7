"""Monetary cost per iteration (paper §4.3):  C_iter = C_comp + C_comm.

C_comp = sum_i (N_i * price_i) * T_iter  over all chips in the plan.
C_comm = sum_zone-pairs bytes_ij * egress_price_ij, counting pipeline p2p
(activations fwd + gradients bwd, per microbatch, per replica) and any DP
all-reduce rings that cross zone boundaries (ring traffic crosses the
boundary twice per direction).

A copy of ``repro/core/simulator/cost.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.plan import ParallelPlan
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile


def compute_cost(plan: ParallelPlan, cluster: ClusterSpec,
                 t_iter: float) -> float:
    total_rate = 0.0
    for st in plan.stages:
        for rep in st.replicas:
            z = cluster.zone(rep.zone)
            total_rate += rep.n_chips * z.price_per_sec(rep.gpu_type)
    return total_rate * t_iter


def comm_cost(profile: JobProfile, plan: ParallelPlan,
              cluster: ClusterSpec) -> float:
    from repro_torch.core.simulator.timing import boundary_route

    cost = 0.0
    # pipeline p2p across zones: fwd activation + bwd gradient per
    # microbatch, following the explicit sender->receiver routing (stages
    # may have unequal replica counts).  Under an adaptive assignment each
    # chain ships its OWN microbatch size/count; uniform plans reduce to
    # the plan-nominal values on every chain.
    for i in range(plan.pp - 1):
        for d in range(plan.stages[i].dp):
            z_a = plan.stages[i].replicas[d].zone
            recv = boundary_route(plan, i, d)
            z_b = plan.stages[i + 1].replicas[recv].zone
            price = cluster.egress_price(z_a, z_b)
            if price > 0:
                act = profile.boundary_bytes(plan.replica_mbs(d))
                cost += 2 * act * plan.replica_n_micro(d) * price
    # DP sync rings crossing zones: 2 x per-shard payload per boundary
    # crossing (hierarchical sync sends each replica's own shard, not the
    # largest shard over every link)
    for i, st in enumerate(plan.stages):
        zones = st.zones()
        if len(zones) > 1:
            params = profile.stage_params(st.layer_start, st.layer_end)
            worst = max(cluster.egress_price(a, b)
                        for a in zones for b in zones if a != b)
            for rep in st.replicas:
                shard = params / rep.tp * DTYPE_BYTES
                cost += 2 * 2 * shard * worst / st.dp
    return cost


def iteration_cost(profile: JobProfile, plan: ParallelPlan,
                   cluster: ClusterSpec, t_iter: float) -> Dict[str, float]:
    comp = compute_cost(plan, cluster, t_iter)
    comm = comm_cost(profile, plan, cluster)
    return {"comp": comp, "comm": comm, "total": comp + comm}
