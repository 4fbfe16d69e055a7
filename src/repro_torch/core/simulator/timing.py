"""Iteration-time model (paper §4.3): event-engine facade + analytic limit.

``iteration_time()`` is the facade every consumer ranks plans through
(``simulate()`` -> planner search, warm-start replanner, transition model).
It now runs the discrete-event engine in ``core/simulator/engine.py`` —
per-microbatch fwd/bwd/p2p/collective events on per-worker compute and link
resources, with compute/comm overlap and hierarchical cross-zone DP sync —
instead of the closed-form 1F1B formula

    T_iter = max_d(T_pp_d) + max_i(T_sync_i) + T_update

which serializes all communication onto the critical path.  The closed form
is kept as :func:`closed_form_iteration_time`: it is the analytic limit of
the engine with overlap disabled (asserted in ``tests/test_engine.py``) and
the comparison baseline in ``benchmarks/simulator_accuracy.py``.

Heterogeneity enters through (a) per-replica GPU types / TP degrees
changing stage compute times, (b) zone placement changing link classes for
p2p and DP sync, and (c) per-stage replica counts: boundary traffic is
routed through an explicit sender->receiver mapping, so adjacent stages
with unequal DP degrees fan in/out instead of indexing out of range.

A copy of ``repro/core/simulator/timing.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.plan import ParallelPlan
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile
from repro_torch.core.simulator import engine as eng
from repro_torch.core.simulator import network


@dataclasses.dataclass
class TimingBreakdown:
    t_iter: float
    t_pp: float                 # max over pipelines (last backward end)
    t_sync: float               # exposed (non-overlapped) DP sync time
    t_update: float
    straggler_stage: int
    straggler_pipeline: int
    per_stage_fwd_bwd: List[float]
    p2p: List[float]
    source: str = "engine"      # "engine" | "closed-form"
    n_tasks: int = 0            # events simulated (0 for closed form)


def _stage_time(profile: JobProfile, plan: ParallelPlan, stage_idx: int,
                replica_idx: int,
                mbs: Optional[int] = None) -> Dict[str, float]:
    """Per-microbatch cost of one stage replica — at that replica chain's
    OWN microbatch size under an adaptive assignment (``mbs=None`` resolves
    it via ``plan.replica_mbs``, which is the plan-nominal size for uniform
    plans, keeping them byte-identical)."""
    st = plan.stages[stage_idx]
    rep = st.replicas[replica_idx]
    if mbs is None:
        mbs = plan.replica_mbs(replica_idx)
    fwd, bwd, upd = profile.stage_cost(
        st.layer_start, st.layer_end, rep.gpu_type, rep.tp, mbs)
    return {"fwd": fwd, "bwd": bwd, "update": upd}


# --- boundary routing (uneven per-stage DP) -----------------------------------

def boundary_route(plan: ParallelPlan, stage_idx: int,
                   sender_idx: int) -> int:
    """Receiver replica of ``stages[stage_idx + 1]`` for ``sender_idx``.

    Block mapping: with unequal replica counts the dp_a senders fan their
    traffic onto dp_b receivers contiguously, so every pair exists (no
    ``IndexError`` when dp_b < dp_a, no silent wrong-zone pairing when
    dp_b > dp_a)."""
    dp_a = plan.stages[stage_idx].dp
    dp_b = plan.stages[stage_idx + 1].dp
    return sender_idx * dp_b // dp_a


def _p2p_time(profile: JobProfile, plan: ParallelPlan, cluster: ClusterSpec,
              stage_idx: int, replica_idx: int,
              mbs: Optional[int] = None) -> float:
    """Activation transfer stage i -> i+1 for one microbatch (sized at the
    sending chain's own mbs under an adaptive assignment)."""
    if stage_idx >= plan.pp - 1:
        return 0.0
    z_a = plan.stages[stage_idx].replicas[replica_idx].zone
    recv = boundary_route(plan, stage_idx, replica_idx)
    z_b = plan.stages[stage_idx + 1].replicas[recv].zone
    link = cluster.link_between(z_a, z_b)
    if mbs is None:
        mbs = plan.replica_mbs(replica_idx)
    return network.p2p_time(link, profile.boundary_bytes(mbs))


def _chain_replicas(plan: ParallelPlan, start_idx: int) -> List[int]:
    """Replica index at every stage of the pipeline chain that begins at
    ``stages[0].replicas[start_idx]``, following the boundary routing."""
    out = [start_idx]
    for s in range(plan.pp - 1):
        out.append(boundary_route(plan, s, out[-1]))
    return out


# --- DP sync (hierarchical, alpha-aware, per-shard) ---------------------------

def _stage_sync_times(profile: JobProfile, plan: ParallelPlan,
                      cluster: ClusterSpec, stage_idx: int,
                      n_buckets: int = 1,
                      bucket_bytes: float = 0.0) -> List[float]:
    """Per-bucket DP all-reduce seconds for one stage (empty if dp <= 1).

    Fixes three closed-form bugs:

    * Replicas clustered into zones use the two-level
      :func:`network.hierarchical_all_reduce_time` (reduce-scatter inside
      the fast intra-zone domain, cross-zone ring of the 1/k_fast shard,
      all-gather back) — the model Sailor's H5 heuristic depends on —
      instead of one flat ring over the slowest link.
    * The cross-zone bottleneck link is picked by the actual transfer time
      of the bytes that cross it (``alpha + n/beta``), not by ``1/beta``
      alone, which inverts the ranking for small gradient buckets.
    * With heterogeneous per-replica TP the payload is per shard:
      ``params / tp_r`` for replica ``r``, and the stage sync time is the
      true bottleneck over replicas — not one impossible ring carrying the
      *largest* shard over the *slowest* link irrespective of where either
      lives.
    """
    st = plan.stages[stage_idx]
    d = st.dp
    if d <= 1:
        return []
    params = profile.stage_params(st.layer_start, st.layer_end)
    # DDP-style bucket sizing: each bucket pays the ring latency term, so
    # small payloads collapse to a single bucket instead of multiplying it
    if bucket_bytes > 0:
        max_payload = params / min(r.tp for r in st.replicas) * DTYPE_BYTES
        n_buckets = max(1, min(n_buckets, int(max_payload // bucket_bytes)))
    groups = collections.Counter(r.zone for r in st.replicas)
    zones = sorted(groups)
    fast = cluster.links["intra-zone"]
    worst = 0.0
    for tp, zone in sorted({(r.tp, r.zone) for r in st.replicas}):
        nbytes = params / tp * DTYPE_BYTES / n_buckets
        if len(zones) == 1:
            t = network.all_reduce_time(fast, nbytes, d)
        else:
            k_fast = groups[zone]
            # bytes this replica's zone leader pushes across the WAN:
            cross = nbytes / max(k_fast, 1)
            slow = max((cluster.link_between(zone, z)
                        for z in zones if z != zone),
                       key=lambda l: l.time(cross))
            t = network.hierarchical_all_reduce_time(
                fast, slow, nbytes, k_fast, len(zones))
        if t > worst:
            worst = t
    return [worst] * n_buckets


def sync_time(profile: JobProfile, plan: ParallelPlan,
              cluster: ClusterSpec, stage_idx: int) -> float:
    """Serial DP gradient all-reduce time across one stage's replicas."""
    buckets = _stage_sync_times(profile, plan, cluster, stage_idx, 1)
    return buckets[0] if buckets else 0.0


# --- closed form (analytic limit, comparison baseline) ------------------------

def pipeline_time(profile: JobProfile, plan: ParallelPlan,
                  cluster: ClusterSpec, replica_idx: int) -> Dict:
    """Closed-form 1F1B time of one DP replica chain (at that chain's own
    microbatch size/count under an adaptive assignment)."""
    n_micro = plan.replica_n_micro(replica_idx)
    chain = _chain_replicas(plan, replica_idx)
    per_stage = []
    p2ps = []
    for i in range(plan.pp):
        t = _stage_time(profile, plan, i, chain[i])
        p2p = _p2p_time(profile, plan, cluster, i, chain[i])
        per_stage.append(t["fwd"] + t["bwd"])
        p2ps.append(p2p)
    warmup_cooldown = sum(per_stage) + 2 * sum(p2ps)
    steady_unit = max(s + 2 * p for s, p in zip(per_stage, p2ps))
    straggler_stage = max(range(plan.pp),
                          key=lambda i: per_stage[i] + 2 * p2ps[i])
    t_pp = warmup_cooldown + max(n_micro - 1, 0) * steady_unit
    return {"t_pp": t_pp, "per_stage": per_stage, "p2p": p2ps,
            "straggler_stage": straggler_stage, "steady_unit": steady_unit}


def closed_form_iteration_time(profile: JobProfile, plan: ParallelPlan,
                               cluster: ClusterSpec) -> TimingBreakdown:
    """The pre-engine analytic model: no overlap, serial sync after drain.

    Retained because it is the analytic limit of the event engine on
    homogeneous no-overlap plans and the accuracy baseline the engine is
    gated against (``benchmarks/simulator_accuracy.py``)."""
    n_chains = plan.stages[0].dp
    pls = [pipeline_time(profile, plan, cluster, d) for d in range(n_chains)]
    worst = max(range(n_chains), key=lambda d: pls[d]["t_pp"])
    t_pp = pls[worst]["t_pp"]
    syncs = [sync_time(profile, plan, cluster, i) for i in range(plan.pp)]
    t_sync = max(syncs) if syncs else 0.0
    t_update = 0.0
    for i, st in enumerate(plan.stages):
        for rep in st.replicas:
            _, _, upd = profile.stage_cost(
                st.layer_start, st.layer_end, rep.gpu_type, rep.tp, plan.mbs)
            t_update = max(t_update, upd)
    return TimingBreakdown(
        t_iter=t_pp + t_sync + t_update,
        t_pp=t_pp, t_sync=t_sync, t_update=t_update,
        straggler_stage=pls[worst]["straggler_stage"],
        straggler_pipeline=worst,
        per_stage_fwd_bwd=pls[worst]["per_stage"],
        p2p=pls[worst]["p2p"],
        source="closed-form")


# --- the event-engine facade --------------------------------------------------

def _engine_spec_uniform(profile: JobProfile, plan: ParallelPlan,
                         cluster: ClusterSpec, cfg: eng.EngineConfig
                         ) -> Tuple[eng.PipelineSpec, List[int], int, int]:
    """Build a deduplicated PipelineSpec for uniform-dp plans.

    Identical DP chains are collapsed to one representative each (chains
    only interact through the DP sync, whose readiness is the max over the
    representatives), so cost is independent of the DP degree."""
    P = plan.pp
    classes: Dict[Tuple, int] = {}
    reps: List[int] = []          # original replica index per class
    for d in range(plan.dp):
        chain = _chain_replicas(plan, d)
        key = tuple(plan.stages[s].replicas[chain[s]] for s in range(P))
        if key not in classes:
            classes[key] = len(reps)
            reps.append(d)
    n_cls = len(reps)
    M = max(plan.num_microbatches, 1)
    m_eff = min(M, cfg.exact_cap(P))

    cost = {}
    chain_of = [_chain_replicas(plan, d) for d in reps]
    for c, chain in enumerate(chain_of):
        for s in range(P):
            t = _stage_time(profile, plan, s, chain[s])
            cost[(s, c)] = eng.WorkerCost(t["fwd"], t["bwd"], t["update"])

    nbytes = profile.boundary_bytes(plan.mbs)

    def p2p(sa: int, sb: int, ra: int, rb: int) -> float:
        z_a = plan.stages[sa].replicas[chain_of[ra][sa]].zone
        z_b = plan.stages[sb].replicas[chain_of[rb][sb]].zone
        return network.p2p_time(cluster.link_between(z_a, z_b), nbytes)

    n_buckets = max(1, cfg.dp_buckets) if cfg.overlap_comm else 1
    sync = [_stage_sync_times(profile, plan, cluster, s, n_buckets,
                              cfg.bucket_bytes if cfg.overlap_comm else 0.0)
            for s in range(P)]
    spec = eng.PipelineSpec(
        n_stages=P, n_replicas=(n_cls,) * P, cost=cost,
        total_micro=m_eff * n_cls,
        assign=lambda s, m: m // m_eff,
        p2p=p2p, sync=sync)
    return spec, reps, M, m_eff


def _engine_spec_adaptive(profile: JobProfile, plan: ParallelPlan,
                          cluster: ClusterSpec, cfg: eng.EngineConfig
                          ) -> Tuple[eng.PipelineSpec, List[int],
                                     List[int], List[int]]:
    """PipelineSpec for adaptive (uniform-dp) plans.

    Chains deduplicate by (hardware chain, mbs, n_micro) class; every
    worker of a class runs fwd/bwd at that class's OWN microbatch size and
    the class contributes its own microbatch count to the global stream —
    the existing ``assign(stage, m)`` routing handles the resulting uneven
    per-replica counts natively.  Returns (spec, representative chain per
    class, full per-class counts, exactly-simulated per-class counts)."""
    P = plan.pp
    classes: Dict[Tuple, int] = {}
    reps: List[int] = []          # original chain index per class
    for d in range(plan.dp):
        chain = _chain_replicas(plan, d)
        key = (tuple(plan.stages[s].replicas[chain[s]] for s in range(P)),
               plan.replica_mbs(d), plan.replica_n_micro(d))
        if key not in classes:
            classes[key] = len(reps)
            reps.append(d)
    chain_of = [_chain_replicas(plan, d) for d in reps]
    cap = cfg.exact_cap(P)
    Ms = [max(plan.replica_n_micro(d), 1) for d in reps]
    m_effs = [min(m, cap) for m in Ms]
    offsets = [0]
    for me in m_effs:
        offsets.append(offsets[-1] + me)

    cost = {}
    bytes_of = []
    for c, d in enumerate(reps):
        b = plan.replica_mbs(d)
        bytes_of.append(profile.boundary_bytes(b))
        for s in range(P):
            t = _stage_time(profile, plan, s, chain_of[c][s], mbs=b)
            cost[(s, c)] = eng.WorkerCost(t["fwd"], t["bwd"], t["update"])

    def p2p(sa: int, sb: int, ra: int, rb: int) -> float:
        z_a = plan.stages[sa].replicas[chain_of[ra][sa]].zone
        z_b = plan.stages[sb].replicas[chain_of[rb][sb]].zone
        return network.p2p_time(cluster.link_between(z_a, z_b),
                                bytes_of[ra])

    n_buckets = max(1, cfg.dp_buckets) if cfg.overlap_comm else 1
    sync = [_stage_sync_times(profile, plan, cluster, s, n_buckets,
                              cfg.bucket_bytes if cfg.overlap_comm else 0.0)
            for s in range(P)]
    spec = eng.PipelineSpec(
        n_stages=P, n_replicas=(len(reps),) * P, cost=cost,
        total_micro=offsets[-1],
        assign=lambda s, m: bisect.bisect_right(offsets, m) - 1,
        p2p=p2p, sync=sync)
    return spec, reps, Ms, m_effs


def _class_period(spec: eng.PipelineSpec, cfg: eng.EngineConfig,
                  c: int) -> float:
    """Steady cycle time of ONE chain class: its bottleneck stage's busy
    time per microbatch (plus its own link channels under overlap) — the
    per-class analogue of ``engine._steady_period`` used to extend the
    exact window by that class's remainder microbatches."""
    ov = cfg.per_task_overhead_s
    period = 0.0
    for s in range(spec.n_stages):
        busy = (spec.cost[(s, c)].fwd + spec.cost[(s, c)].bwd + 2 * ov
                + eng._worker_recv(spec, cfg, s, c))
        if busy > period:
            period = busy
    if cfg.overlap_comm:
        for s in range(spec.n_stages - 1):
            t = spec.p2p(s, s + 1, c, c) + ov
            if t > period:
                period = t
    return period


def _engine_spec_uneven(profile: JobProfile, plan: ParallelPlan,
                        cluster: ClusterSpec, cfg: eng.EngineConfig
                        ) -> Tuple[eng.PipelineSpec, int, int]:
    """Full per-replica spec for plans with unequal per-stage DP.

    Returns (spec, total global microbatches, exactly-simulated count):
    like the uniform path, the exact window is capped and the remainder
    extends via the steady-state period (:func:`_uneven_period`)."""
    P = plan.pp
    dps = [st.dp for st in plan.stages]
    total = max(plan.global_batch // plan.mbs, 1)
    total_eff = min(total, cfg.exact_cap(P) * max(dps))
    cost = {}
    for s, st in enumerate(plan.stages):
        for r in range(st.dp):
            t = _stage_time(profile, plan, s, r)
            cost[(s, r)] = eng.WorkerCost(t["fwd"], t["bwd"], t["update"])
    nbytes = profile.boundary_bytes(plan.mbs)

    def p2p(sa: int, sb: int, ra: int, rb: int) -> float:
        z_a = plan.stages[sa].replicas[ra].zone
        z_b = plan.stages[sb].replicas[rb].zone
        return network.p2p_time(cluster.link_between(z_a, z_b), nbytes)

    n_buckets = max(1, cfg.dp_buckets) if cfg.overlap_comm else 1
    sync = [_stage_sync_times(profile, plan, cluster, s, n_buckets,
                              cfg.bucket_bytes if cfg.overlap_comm else 0.0)
            for s in range(P)]
    spec = eng.PipelineSpec(
        n_stages=P, n_replicas=tuple(dps), cost=cost,
        total_micro=total_eff,
        assign=lambda s, m: m * dps[s] // total_eff,
        p2p=p2p, sync=sync)
    return spec, total, total_eff


def _uneven_period(spec: eng.PipelineSpec, cfg: eng.EngineConfig) -> float:
    """Steady-state cycle time per *global* microbatch of an uneven-DP
    spec: each stage spreads the stream over its dp_s replicas, so a
    worker's share of one global microbatch is busy/dp_s; link channels
    likewise carry load_c/total of the stream."""
    ov = cfg.per_task_overhead_s
    total = spec.total_micro
    period = 0.0
    for (s, r), c in spec.cost.items():
        busy = (c.fwd + c.bwd + 2 * ov
                + eng._worker_recv(spec, cfg, s, r))
        period = max(period, busy / spec.n_replicas[s])
    if cfg.overlap_comm:
        loads: Dict[Tuple[int, int, int], int] = {}
        for m in range(total):
            for s in range(spec.n_stages - 1):
                key = (s, spec.assign(s, m), spec.assign(s + 1, m))
                loads[key] = loads.get(key, 0) + 1
        for (s, ra, rb), n in loads.items():
            period = max(period,
                         (spec.p2p(s, s + 1, ra, rb) + ov) * n / total)
    return period


def iteration_time(profile: JobProfile, plan: ParallelPlan,
                   cluster: ClusterSpec,
                   engine_cfg: Optional[eng.EngineConfig] = None
                   ) -> TimingBreakdown:
    """Event-driven iteration time; same facade the closed form exposed."""
    cfg = engine_cfg or eng.DEFAULT_ENGINE
    if plan.staleness > 0 and cfg.sync_lag != plan.staleness:
        # bounded-staleness plans run the engine in lagged-sync mode: the
        # AR tail leaves the critical path and is re-charged below as the
        # stall the k-step window cannot hide
        cfg = dataclasses.replace(cfg, sync_lag=plan.staleness)
    P = plan.pp
    uniform = len({st.dp for st in plan.stages}) == 1
    adaptive = plan.assignment is not None
    if adaptive:
        spec, reps, Ms, m_effs = _engine_spec_adaptive(
            profile, plan, cluster, cfg)
        res = eng.run_pipeline(spec, cfg)
        shift = max((((Ms[c] - m_effs[c]) * _class_period(spec, cfg, c))
                     for c in range(len(reps)) if Ms[c] > m_effs[c]),
                    default=0.0)
    elif uniform:
        spec, reps, M, m_eff = _engine_spec_uniform(
            profile, plan, cluster, cfg)
        res = eng.run_pipeline(spec, cfg)
        shift = (M - m_eff) * res.period if M > m_eff else 0.0
    else:
        spec, total, total_eff = _engine_spec_uneven(
            profile, plan, cluster, cfg)
        reps = list(range(plan.stages[0].dp))
        res = eng.run_pipeline(spec, cfg)
        shift = ((total - total_eff) * _uneven_period(spec, cfg)
                 if total > total_eff else 0.0)

    t_iter = res.t_total + shift + cfg.fixed_overhead_s
    t_pp = res.t_pp + shift
    t_sync = max((max(0.0, res.sync_end[s] - res.bwd_end[s])
                  for s in range(P)), default=0.0)
    if plan.staleness > 0:
        # t_iter is the compute-only makespan (the engine decoupled the AR
        # tail); the tail may hide under up to k subsequent iterations of
        # compute — only the excess stalls the pipeline.
        stall = max(0.0, t_sync - plan.staleness * t_iter)
        t_iter += stall
        t_sync = stall
    t_update = max(c.upd for c in spec.cost.values())

    # straggler: worker class with the largest steady-state busy time
    stage_busy = [max(res.busy_per_micro.get((s, r), 0.0)
                      for r in range(spec.n_replicas[s]))
                  for s in range(P)]
    straggler_stage = max(range(P), key=lambda s: stage_busy[s])
    # chain whose last backward lands latest (uniform: map class -> replica)
    if uniform or adaptive:
        cls_end = [max((res.busy_per_micro.get((s, c), 0.0)
                        for s in range(P)))
                   for c in range(spec.n_replicas[0])]
        straggler_cls = max(range(len(cls_end)), key=lambda c: cls_end[c])
        straggler_pipeline = reps[straggler_cls]
        chain = _chain_replicas(plan, straggler_pipeline)
    else:
        straggler_pipeline = 0
        chain = _chain_replicas(plan, 0)
    per_stage = []
    p2ps = []
    for s in range(P):
        t = _stage_time(profile, plan, s, chain[s])
        per_stage.append(t["fwd"] + t["bwd"])
        p2ps.append(_p2p_time(profile, plan, cluster, s, chain[s]))
    return TimingBreakdown(
        t_iter=t_iter, t_pp=t_pp, t_sync=t_sync, t_update=t_update,
        straggler_stage=straggler_stage,
        straggler_pipeline=straggler_pipeline,
        per_stage_fwd_bwd=per_stage, p2p=p2ps,
        source="engine", n_tasks=res.n_tasks)
