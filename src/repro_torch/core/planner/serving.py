"""Serving-plan search: min $/token under latency SLOs (ServingObjective).

The training search walks (pp, mbs, d); serving plans have different
dimensions — **replica count**, **GPU type/TP per replica**, and
**prefill/decode disaggregation** — but the same two-phase shape:

* **Phase 1 — enumerate + rank.**  For every (zone, type) pool the
  memory model picks the smallest TP whose params + paged-KV residency
  fit usable HBM (Frenzy-style memory-aware type/count selection; routes
  through ``serving_stage_peak_bytes`` → the shared ``stage_peak_bytes``
  kernel).  An analytic replica-seconds-per-request model then sizes
  homogeneous counts {n, n+1, ceil(1.25 n)} against the diurnal *peak*
  request rate at a target utilization, builds a greedy cheapest-first
  heterogeneous mix, and adds disaggregated variants (decode pool on the
  best $/decode-token type, prefill pool on the best $/prefill type).
  Candidates are ranked by estimated $/token.
* **Phase 2 — simulate a top-K frontier.**  The ranked walk pays
  ``simulate_serving`` for the top K and keeps extending past K until a
  plan satisfies the objective (SLO + budget), mirroring the training
  frontier's never-return-nothing rule.

A copy of ``repro/core/planner/serving.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner import heuristics as H
from repro_torch.core.planner.objectives import ServingObjective
from repro_torch.core.planner.plan import ServingPlan, StageReplica
from repro_torch.core.simulator import memory as mem
from repro_torch.core.simulator.serving import (ServingSimResult, TrafficModel,
                                          simulate_serving)

TARGET_UTIL = 0.8          # size pools for rho <= 0.8 at the diurnal peak
SIM_HORIZON_S = 120.0      # phase-2 evaluation window (starts at the peak)
SIM_TOP_K = 4              # serving sims cost seconds; keep the frontier tight


@dataclasses.dataclass(frozen=True)
class _ReplicaOption:
    """One way to build a replica: a (zone, type, tp) with derived rates."""
    zone: str
    gpu_type: str
    tp: int
    max_replicas: int          # capacity // tp in that pool
    price_per_s: float         # whole replica (tp chips)
    req_per_s_unified: float   # request rate incl. the prefill stall
    req_per_s_decode: float    # decode-only (disaggregated) request rate
    req_per_s_prefill: float   # prefill-only request rate

    def cost_per_token(self, max_new: int, unified: bool) -> float:
        rate = self.req_per_s_unified if unified else self.req_per_s_decode
        toks = rate * max_new
        return self.price_per_s / toks if toks > 0 else math.inf


def _round_to_page(n: int, page: int) -> int:
    return max(-(-int(n) // page), 1) * page


def replica_options(planner, cluster: ClusterSpec) -> List[_ReplicaOption]:
    """Memory-gated replica shapes for every (zone, type) pool."""
    job, profile = planner.job, planner.profile
    cfg = job.cfg
    L = profile.n_partition_units
    mem_cfg = mem.serving_mem_cfg(planner.mem_cfg)
    slots, page = job.decode_batch, job.page_size
    kv_full = mem.kv_cache_bytes(cfg, slots, job.max_ctx, page)
    kv_one = mem.kv_cache_bytes(cfg, 1, job.max_ctx, page)
    ctx_avg = _round_to_page(job.prompt_len + job.max_new_tokens // 2, page)
    dsteps = max(job.max_new_tokens - 1, 1)
    out: List[_ReplicaOption] = []
    for z in cluster.zones:
        for g in sorted(z.capacity):
            cap = z.capacity[g]
            if cap < 1:
                continue
            opts = H.tp_options(g)
            # Frenzy-style: smallest TP whose params + KV residency fit;
            # prefer the full continuous batch resident, fall back to a
            # single request (heavier preemption but still serves).
            tp = mem.min_tp_for_serving(profile, 0, L, slots, g, opts,
                                        kv_full, mem_cfg)
            if tp is None:
                tp = mem.min_tp_for_serving(profile, 0, L, slots, g, opts,
                                            kv_one, mem_cfg)
            if tp is None or tp > cap:
                continue
            t_step = profile.stage_decode_time(0, L, g, tp, slots, ctx_avg)
            t_pref = profile.stage_prefill_time(0, L, g, tp, 1)
            # replica-seconds per request: the prefill stalls every slot,
            # a decode step advances all `slots` rows at once
            rs_unified = t_pref + dsteps * t_step / slots
            rs_decode = dsteps * t_step / slots
            out.append(_ReplicaOption(
                zone=z.name, gpu_type=g, tp=tp, max_replicas=cap // tp,
                price_per_s=tp * z.price_per_sec(g),
                req_per_s_unified=1.0 / max(rs_unified, 1e-12),
                req_per_s_decode=1.0 / max(rs_decode, 1e-12),
                req_per_s_prefill=1.0 / max(t_pref, 1e-12)))
    return out


def _take(options: List[_ReplicaOption], counts: Dict[int, int]
          ) -> Tuple[StageReplica, ...]:
    reps: List[StageReplica] = []
    for i, n in counts.items():
        o = options[i]
        reps.extend(StageReplica(o.gpu_type, o.tp, o.zone)
                    for _ in range(n))
    return tuple(reps)


def _mk_plan(job, decode, prefill=()) -> ServingPlan:
    return ServingPlan(decode=decode, prefill=tuple(prefill),
                       decode_batch=job.decode_batch,
                       page_size=job.page_size, max_ctx=job.max_ctx)


def enumerate_candidates(planner, cluster: ClusterSpec,
                         peak_rps: float
                         ) -> List[Tuple[float, ServingPlan]]:
    """(estimated $/token, plan) candidates, unsorted."""
    job = planner.job
    options = replica_options(planner, cluster)
    if not options:
        return []
    need_rps = peak_rps / TARGET_UTIL
    cands: List[Tuple[float, ServingPlan]] = []

    price_of = {(o.zone, o.gpu_type, o.tp): o.price_per_s for o in options}

    def est(reps: Tuple[StageReplica, ...], rate_req: float) -> float:
        price = sum(price_of[(r.zone, r.gpu_type, r.tp)] for r in reps)
        served = min(rate_req, peak_rps) * job.max_new_tokens
        return price / served if served > 0 else math.inf

    # homogeneous pools, {n, n+1, ceil(1.25n)} replicas
    for i, o in enumerate(options):
        n0 = max(int(math.ceil(need_rps / o.req_per_s_unified)), 1)
        for n in sorted({n0, n0 + 1, int(math.ceil(1.25 * n0))}):
            if n > o.max_replicas:
                continue
            reps = _take(options, {i: n})
            rate = n * o.req_per_s_unified
            cands.append((est(reps, rate), _mk_plan(job, reps)))

    # greedy cheapest-first heterogeneous mix across pools
    order = sorted(range(len(options)),
                   key=lambda i: (options[i].cost_per_token(
                       job.max_new_tokens, unified=True), i))
    counts: Dict[int, int] = {}
    rate = 0.0
    for i in order:
        o = options[i]
        while counts.get(i, 0) < o.max_replicas and rate < need_rps:
            counts[i] = counts.get(i, 0) + 1
            rate += o.req_per_s_unified
        if rate >= need_rps:
            break
    if counts and len(counts) > 1:
        reps = _take(options, counts)
        cands.append((est(reps, rate), _mk_plan(job, reps)))

    # disaggregated: decode pool on the best $/decode-token types,
    # prefill pool on the best $/prefill-request type
    dec_order = sorted(range(len(options)),
                       key=lambda i: (options[i].cost_per_token(
                           job.max_new_tokens, unified=False), i))
    pre_order = sorted(range(len(options)),
                       key=lambda i: (options[i].price_per_s
                                      / options[i].req_per_s_prefill, i))
    for di in dec_order[:2]:
        do = options[di]
        nd = max(int(math.ceil(need_rps / do.req_per_s_decode)), 1)
        if nd > do.max_replicas:
            continue
        for pi in pre_order[:2]:
            po = options[pi]
            np_ = max(int(math.ceil(need_rps / po.req_per_s_prefill)), 1)
            budget = po.max_replicas - (nd if pi == di else 0)
            if np_ > budget:
                continue
            dec = _take(options, {di: nd})
            pre = _take(options, {pi: np_})
            rate = min(nd * do.req_per_s_decode, np_ * po.req_per_s_prefill)
            price = nd * do.price_per_s + np_ * po.price_per_s
            served = min(rate, peak_rps) * job.max_new_tokens
            e = price / served if served > 0 else math.inf
            cands.append((e, _mk_plan(job, dec, pre)))
    return cands


def plan_serving(planner, cluster: ClusterSpec,
                 objective: ServingObjective,
                 horizon_s: float = SIM_HORIZON_S, seed: int = 0):
    """Entry point for ``SailorPlanner.plan()`` with a ServingObjective.
    Returns the training search's ``PlanResult`` shape with ``best`` a
    :class:`ServingSimResult`."""
    from repro_torch.core.planner.search import PlanResult
    t_start = time.perf_counter()
    job = planner.job
    traffic = TrafficModel.from_job(job, seed=seed)
    cands = enumerate_candidates(planner, cluster, traffic.peak_rps)
    cands.sort(key=lambda c: (c[0], c[1].n_chips))
    # drop exact duplicates (same replica multiset) keeping best estimate
    seen: Dict[Tuple, float] = {}
    uniq: List[Tuple[float, ServingPlan]] = []
    for e, p in cands:
        key = (tuple(sorted((r.gpu_type, r.tp, r.zone) for r in p.decode)),
               tuple(sorted((r.gpu_type, r.tp, r.zone) for r in p.prefill)))
        if key in seen:
            continue
        seen[key] = e
        uniq.append((e, p))

    top_k = min(planner.sim_top_k or SIM_TOP_K, SIM_TOP_K)
    best: Optional[ServingSimResult] = None
    n_eval = n_oom = 0
    scores: Dict[int, float] = {}
    for rank, (e, p) in enumerate(uniq):
        if rank >= top_k and best is not None \
                and objective.satisfies(best):
            break
        r = simulate_serving(planner.profile, p, cluster, traffic=traffic,
                             horizon_s=horizon_s, seed=seed)
        n_eval += 1
        if r.oom:
            n_oom += 1
        if not r.valid:
            continue
        scores[rank] = objective.score(r)
        if objective.satisfies(r) and (
                best is None or not objective.satisfies(best)
                or objective.better(best, r)):
            best = r
        elif best is None:
            best = r                  # SLO-violating fallback, never None
        elif not objective.satisfies(best) and objective.better(best, r):
            best = r
    return PlanResult(
        best=best, search_time_s=time.perf_counter() - t_start,
        n_candidates=len(uniq), n_evaluated=n_eval, n_oom=n_oom,
        stats={"estimates": [e for e, _ in uniq],
               "scores": scores,
               "plans": [p for _, p in uniq],
               "peak_rps": traffic.peak_rps})


def naive_homogeneous_serving(planner, cluster: ClusterSpec,
                              horizon_s: float = SIM_HORIZON_S,
                              seed: int = 0) -> Optional[ServingSimResult]:
    """Cost-blind baseline the benchmark compares against: put every
    replica on the single most plentiful (zone, type) pool, sized by the
    same utilization rule — no $/token ranking, no disaggregation, no
    heterogeneous mix."""
    job = planner.job
    traffic = TrafficModel.from_job(job, seed=seed)
    options = replica_options(planner, cluster)
    if not options:
        return None
    o = max(options, key=lambda o: (o.max_replicas, o.zone))
    need_rps = traffic.peak_rps / TARGET_UTIL
    n = min(max(int(math.ceil(need_rps / o.req_per_s_unified)), 1),
            o.max_replicas)
    reps = tuple(StageReplica(o.gpu_type, o.tp, o.zone) for _ in range(n))
    return simulate_serving(planner.profile, _mk_plan(job, reps), cluster,
                            traffic=traffic, horizon_s=horizon_s,
                            seed=seed)
