"""Sailor planner: outer search loop (paper §4.2).

Two-phase candidate-frontier search:

* **Phase 1 — enumerate + DP-rank.**  (pp, mbs, d) candidates are walked in
  a deterministic order (pp ascending, mbs ascending, d per H3/H4), each
  solved with the DP solver against a **cross-candidate memo**
  (``dp_solver.CandidateMemo``: per-(pp, split) pseudo-type tables, stage
  parameter counts and link constants are computed once and shared across
  every mbs/d — and across warm replans).  Survivors carry the DP's own
  ``est_time``/``est_cost``.
* **Phase 2 — simulate a top-K frontier.**  Survivors (DP solutions and
  warm-reuse candidates, ranked together — reuse entries by their previous
  simulated score) are walked in rank order and only the ``sim_top_k``
  best pay the event-driven ``simulate()``; the walk extends past K until
  a constraint-satisfying plan is found, and if the whole frontier comes
  back invalid the search re-runs exhaustively, so an OOM-heavy frontier
  degrades to the old simulate-everything scan instead of returning
  nothing.  Candidates past the cut are still materialized into the
  result's candidate pool with their (flagged) DP estimates — warm
  replans repair incumbents and reuse candidates from that pool.  With
  ``use_heuristics=False`` (or ``sim_top_k=None``) every survivor is
  simulated — the exhaustive reference the frontier invariant is pinned
  against in ``tests/test_planner.py``.

Pruning bounds are est-to-est and therefore exact w.r.t. frontier
membership: once the frontier holds K survivors, a candidate whose
capacity-free lower bound exceeds the K-th best estimate cannot enter the
frontier.  Bounds derived from a *simulated* incumbent keep a x1.1 slack
(the simulator's extra terms).  An ``incumbent`` passed in must prove (via
``SimResult.cluster_fp``) that it was simulated against *this* cluster, or
it is re-simulated (rehomed if needed) before it may seed any bound — a
SimResult produced on a different cluster/price-book says nothing about
this one.

H3/H4 early exit (within one (pp, mbs) group, ``use_heuristics=True``):
the d-walk stops when a candidate's DP estimate is strictly worse than the
best estimate seen in the group; plateaus (equal estimates) continue, and
invalid candidates — lb-pruned, capacity-infeasible, or DP-empty — neither
update the group best nor stop the walk.  Warm-reuse candidates skip the DP
entirely and do not participate (fresh and reuse paths see the same walk).

See DESIGN.md §10 for the full design (frontier invariant, pruning-bound
soundness, slowest-last materialization).

A copy of ``repro/core/planner/search.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner import heuristics as H
from repro_torch.core.planner.dp_solver import (CandidateMemo, DPSolver,
                                          StageChoice)
from repro_torch.core.planner.objectives import (MAX_THROUGHPUT, MIN_COST,
                                           Objective, ServingObjective)
from repro_torch.core.planner.plan import (ParallelPlan, StageConfig, StageReplica,
                                     adaptive_plan)
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.core.simulator import memory as mem_mod
from repro_torch.core.simulator.simulate import SimResult, simulate


@dataclasses.dataclass
class PlanResult:
    best: Optional[SimResult]
    search_time_s: float
    n_candidates: int            # DP invocations
    n_evaluated: int             # full simulator evaluations
    n_oom: int                   # candidates rejected by the memory model
    stats: Dict


def plan_footprint(plan: ParallelPlan) -> frozenset:
    """The (zone, gpu_type) pools a materialized plan draws chips from.
    A capacity change in a disjoint pool cannot invalidate the plan."""
    return frozenset((r.zone, r.gpu_type)
                     for s in plan.stages for r in s.replicas)


def plan_fits(plan: ParallelPlan, cluster: ClusterSpec) -> bool:
    """Does the cluster still have the chips this plan is placed on?"""
    used: Dict[Tuple[str, str], int] = {}
    for s in plan.stages:
        for r in s.replicas:
            used[(r.zone, r.gpu_type)] = used.get((r.zone, r.gpu_type), 0) \
                + r.tp
    for (zn, t), n in used.items():
        try:
            if n > cluster.zone(zn).capacity.get(t, 0):
                return False
        except KeyError:
            return False
    return True


def rehome_plan(plan: ParallelPlan,
                cluster: ClusterSpec) -> Optional[ParallelPlan]:
    """Re-place a plan's replicas onto ``cluster``, keeping the region-level
    structure (stage splits, per-replica gpu_type/tp, region) and only
    redistributing across each region's zones (H6).  Because link classes
    and prices are region-level, a rehomed plan keeps the original's
    simulated time/cost — this is how a warm replan repairs a previous
    winner whose exact zone placement no longer fits.  Returns None when
    some region no longer has the chips."""
    if plan_fits(plan, cluster):
        return plan
    zone_used: Dict[Tuple[str, str], int] = {}
    stages = []
    for s in plan.stages:
        reps: List[StageReplica] = []
        for r in s.replicas:
            try:
                region = cluster.zone(r.zone).region
            except KeyError:
                return None
            zones = sorted(cluster.zones_in_region(region),
                           key=lambda z: -sum(z.capacity.values()))
            placed = False
            for z in zones:
                used = zone_used.get((z.name, r.gpu_type), 0)
                if used + r.tp <= z.capacity.get(r.gpu_type, 0):
                    zone_used[(z.name, r.gpu_type)] = used + r.tp
                    reps.append(StageReplica(r.gpu_type, r.tp, z.name))
                    placed = True
                    break
            if not placed:
                return None
        stages.append(StageConfig(s.layer_start, s.layer_end, tuple(reps)))
    # replace() keeps every other plan dimension — mbs, global_batch, an
    # adaptive assignment, the staleness mode — intact through the rehome.
    return dataclasses.replace(plan, stages=tuple(stages))


def _materialize(profile: JobProfile, choices: List[StageChoice],
                 regions: List[str], cluster: ClusterSpec,
                 splits, mbs: int, d: int) -> ParallelPlan:
    """Turn DP choices into a concrete plan with zone placement (H6:
    fill zones of the chosen region in capacity order)."""
    stages = []
    zone_used: Dict[Tuple[str, str], int] = {}
    for (lo, hi), choice in zip(splits, choices):
        region = regions[choice.region_idx]
        zones = sorted(cluster.zones_in_region(region),
                       key=lambda z: -sum(z.capacity.values()))
        reps: List[StageReplica] = []
        for gpu_type, tp, n in sorted(choice.counts):
            for _ in range(n):
                placed = False
                for z in zones:
                    used = zone_used.get((z.name, gpu_type), 0)
                    if used + tp <= z.capacity.get(gpu_type, 0):
                        zone_used[(z.name, gpu_type)] = used + tp
                        reps.append(StageReplica(gpu_type, tp, z.name))
                        placed = True
                        break
                if not placed:   # H6 pooled capacity guaranteed this fits
                    z = zones[0]
                    zone_used[(z.name, gpu_type)] = \
                        zone_used.get((z.name, gpu_type), 0) + tp
                    reps.append(StageReplica(gpu_type, tp, z.name))
        # Slowest-last replica ordering: replica i of this stage pairs with
        # replica i of the next (timing._chain_replicas / boundary_route),
        # so sorting every stage fastest-first aligns fast chains with fast
        # chains and slow with slow — the pairing the engine's straggler
        # model is calibrated on.  Lexicographic gpu_type order (the old
        # behavior) paired replicas by type *name*, which for heterogeneous
        # stages mixed fast and slow workers into every chain.
        speed: Dict[Tuple[str, int], float] = {}
        for r in reps:
            if (r.gpu_type, r.tp) not in speed:
                f, b, _ = profile.stage_cost(lo, hi, r.gpu_type, r.tp, mbs)
                speed[(r.gpu_type, r.tp)] = f + b
        reps.sort(key=lambda r: (speed[(r.gpu_type, r.tp)],
                                 r.gpu_type, r.tp, r.zone))
        stages.append(StageConfig(lo, hi, tuple(reps)))
    return ParallelPlan(stages=tuple(stages), mbs=mbs,
                        global_batch=profile.job.global_batch)


@dataclasses.dataclass
class _Candidate:
    """Phase-1 survivor: a DP solution (or warm-reuse plan) awaiting
    simulation, ranked by its estimate."""
    seq: int                            # deterministic enumeration index
    key3: Tuple[int, int, int]          # (pp, mbs, d)
    est_time: float
    est_cost: float
    choices: Optional[List[StageChoice]]    # DP survivors
    splits: Optional[List[Tuple[int, int]]]
    plan: Optional[ParallelPlan] = None     # warm-reuse candidates
    reused: bool = False


class SailorPlanner:
    def __init__(self, job: TrainJob,
                 mem_cfg: mem_mod.MemoryModelConfig = mem_mod.DEFAULT_MEM,
                 max_pp: int = 16, frontier_keep: int = 8,
                 max_combos: int = 64, use_heuristics: bool = True,
                 engine_cfg=None, sim_top_k: Optional[int] = 12,
                 memo: Optional[CandidateMemo] = None,
                 share_tables: bool = True, state_beam: int = 512,
                 pool_slack: float = 1.0,
                 audit: Optional[str] = None,
                 auditor=None,
                 adaptive: bool = True,
                 staleness: int = 0):
        self.job = job
        self.profile = JobProfile(job)
        if engine_cfg is not None:
            # feasibility (H2 precompute AND final simulate check) must be
            # judged under the schedule candidates will be timed with —
            # interleaving holds more in-flight activations than 1F1B.
            mem_cfg = dataclasses.replace(
                mem_cfg, schedule=engine_cfg.schedule,
                virtual_stages=engine_cfg.virtual_stages)
        self.mem_cfg = mem_cfg
        self.engine_cfg = engine_cfg
        self.tp_table = H.TPTable(self.profile, mem_cfg)
        self.max_pp = max_pp
        self.frontier_keep = frontier_keep
        self.max_combos = max_combos
        self.use_heuristics = use_heuristics
        self.sim_top_k = sim_top_k
        self.state_beam = state_beam
        # the est-frontier bound is exact for *this* search, but pruning
        # everything beyond it leaves the warm-replan candidate pool
        # holding only capacity-maximal plans (useless after a shrink):
        # with pool_slack > 1, candidates within that factor of the
        # frontier/incumbent bounds are still DP-solved and materialized
        # into stats["plans"], just never simulated.  Cold/one-shot
        # searches keep the default 1.0 (exact pruning, fastest);
        # ``manager.replan.IncrementalReplanner`` — whose pool feeds
        # incumbent repair, certification and candidate reuse — widens it.
        self.pool_slack = pool_slack
        # cross-candidate memo: shared by every DP solve of every plan()
        # call on this planner (warm replans inherit it via the long-lived
        # planner held by manager.replan.IncrementalReplanner).
        self.memo = memo if memo is not None \
            else CandidateMemo(self.profile, enabled=share_tables)
        # opt-in post-plan static audit (repro_torch.analysis): None (off),
        # "warn" (findings recorded in stats["audit"] + warning) or "error"
        # (an audit with error findings raises analysis.AuditError).
        # ``auditor`` is any callable (plan, cluster) -> Report; defaults
        # to the structural ``analysis.audit.plan_audit``.
        if audit not in (None, "warn", "error"):
            raise ValueError(f"audit must be None|'warn'|'error', "
                             f"got {audit!r}")
        self.audit = audit
        self.auditor = auditor
        # adaptive-vs-uniform and bounded-staleness sync as searched plan
        # dimensions: phase 1 ranks candidates by the better of the uniform
        # and adaptive DP estimates; phase 2 simulates the throughput-
        # proportional BatchAssignment variant of each frontier plan (and,
        # with staleness > 0, the lagged-sync variant on cross-zone DP
        # groups) and adopts it only when strictly better.  adaptive=False
        # + staleness=0 reproduces the uniform-only search exactly.
        self.adaptive = adaptive
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        self.staleness = staleness
        self._tp_sel_cache: Dict = {}

    # -------------------------------------------------------------------------
    def plan(self, cluster: ClusterSpec, objective: Objective, *,
             incumbent: Optional[SimResult] = None,
             reuse: Optional[Dict[Tuple[int, int, int], ParallelPlan]] = None,
             reuse_scores: Optional[Dict[Tuple[int, int, int], float]] = None,
             changed_pools: Optional[frozenset] = None,
             pp_allow: Optional[frozenset] = None,
             mbs_allow: Optional[frozenset] = None) -> PlanResult:
        """Search ``cluster`` for the best plan under ``objective``.

        Warm-start hooks (used by ``repro.manager.replan``):

        * ``incumbent`` — a SimResult from a previous search.  Unless its
          ``cluster_fp`` proves it was simulated against *this* cluster
          (capacity and prices are both in the fingerprint), its plan is
          re-simulated here (rehomed first if its exact zone placement no
          longer fits) before it may seed ``best`` — a result simulated
          against a different capacity/price-book must never drive the
          pruning bounds, it could silently suppress the true optimum.  A
          stale incumbent that no longer fits or no longer satisfies the
          objective is dropped (``stats["incumbent_dropped"]``).
        * ``reuse`` — ``{(pp, mbs, d): plan}`` materialized winners from a
          previous search.  When a candidate's cached plan has a resource
          footprint disjoint from ``changed_pools`` (the (zone, type) pools
          whose capacity shrank since that search), shrinking elsewhere only
          removed options the plan never used — the cached plan is still
          that candidate's optimum and the DP solve is skipped: the
          candidate enters the phase-2 frontier directly, where the top-K
          get re-simulated and the rest carry their cached score forward
          (still exact under the reuse preconditions — capacity never
          enters ``simulate()``).  ``reuse_scores`` (the previous search's
          ``stats["scores"]``) ranks reused candidates in the frontier;
          without it they sort ahead of DP survivors.
          Callers must not pass ``reuse`` when any pool *grew*: new
          capacity could beat any cached solution.
        * ``pp_allow`` / ``mbs_allow`` — restrict the outer search to these
          pipeline degrees / microbatch sizes (the warm replanner passes a
          neighborhood of the previous optimum after small deltas; plan
          shape rarely jumps on a small capacity change, and the caller
          falls back to an unrestricted search when the restricted one
          finds nothing).

        A :class:`ServingObjective` dispatches to the serving search
        (replica count / disaggregation dimensions instead of pp/mbs/d);
        the warm-start hooks above are training-only.
        """
        if isinstance(objective, ServingObjective):
            from repro_torch.core.planner import serving as serving_search
            return serving_search.plan_serving(self, cluster, objective)
        result = self._search(cluster, objective, incumbent=incumbent,
                              reuse=reuse, reuse_scores=reuse_scores,
                              changed_pools=changed_pools,
                              pp_allow=pp_allow, mbs_allow=mbs_allow)
        if result.best is None and self.use_heuristics \
                and self.sim_top_k is not None:
            # the top-K frontier found nothing valid (e.g. every survivor
            # OOMed in simulation while the est-frontier bounds pruned the
            # slower-but-feasible candidates away): degrade to the
            # exhaustive scan, as the old loop would have.
            t0 = time.perf_counter()
            fb = self._search(cluster, objective, incumbent=incumbent,
                              reuse=reuse, reuse_scores=reuse_scores,
                              changed_pools=changed_pools,
                              pp_allow=pp_allow, mbs_allow=mbs_allow,
                              exhaustive=True)
            result = dataclasses.replace(
                fb,
                search_time_s=result.search_time_s
                + (time.perf_counter() - t0),
                stats={**fb.stats, "frontier_fallback": True})
        return self._post_plan_audit(result, cluster)

    def _post_plan_audit(self, result: PlanResult,
                         cluster: ClusterSpec) -> PlanResult:
        """Opt-in static audit of the winning plan (``audit=`` ctor arg).
        ``warn`` records the report in ``stats["audit"]`` (and warns);
        ``error`` raises :class:`repro_torch.analysis.audit.AuditError` so a
        caller cannot commit an unauditable plan by accident."""
        if self.audit is None or result.best is None:
            return result
        from repro_torch.analysis import audit as audit_mod
        auditor = self.auditor or audit_mod.plan_audit
        report = auditor(result.best.plan, cluster)
        result.stats["audit"] = report.to_dict()
        if not report.ok:
            if self.audit == "error":
                raise audit_mod.AuditError(report)
            import warnings
            warnings.warn(f"plan audit failed (audit='warn'): "
                          f"{report.render()}", stacklevel=3)
        return result

    def _search(self, cluster: ClusterSpec, objective: Objective, *,
                incumbent: Optional[SimResult] = None,
                reuse=None, reuse_scores=None,
                changed_pools: Optional[frozenset] = None,
                pp_allow: Optional[frozenset] = None,
                mbs_allow: Optional[frozenset] = None,
                exhaustive: bool = False) -> PlanResult:
        t0 = time.perf_counter()
        regions, region_caps = H.region_pools(cluster)
        total_chips = cluster.total_chips()
        n_cand = n_eval = n_oom = 0
        memo0 = dict(self.memo.stats)
        stats: Dict = {"dp_combos": 0, "memo_hits": 0, "reused": 0,
                       "lb_pruned": 0, "incumbent": incumbent is not None,
                       "plans": {}, "scores": {}, "est_keys": set(),
                       "d_enumerated": 0,
                       "frontier_size": 0, "frontier_simulated": 0}
        if changed_pools is None:
            changed_pools = frozenset()
        cluster_types = cluster.gpu_types()
        prices = self._price_table(cluster, regions, cluster_types)

        budget = objective.max_cost_per_iter
        floor_t = (1.0 / objective.min_throughput
                   if objective.min_throughput else None)
        decreasing = objective.kind == MAX_THROUGHPUT   # H3 vs H4

        # ---- incumbent revalidation (never trust a foreign SimResult) ----
        best: Optional[SimResult] = None
        if incumbent is not None:
            if incumbent.cluster_fp == cluster.fingerprint() \
                    and plan_fits(incumbent.plan, cluster) \
                    and incumbent.valid and objective.satisfies(incumbent):
                # verifiably simulated against *this* cluster (capacity AND
                # prices are in the fingerprint) — no re-simulation needed
                best = incumbent
            else:
                inc_plan = rehome_plan(incumbent.plan, cluster)
                res = None
                if inc_plan is not None:
                    res = simulate(self.profile, inc_plan, cluster,
                                   self.mem_cfg, self.engine_cfg)
                    n_eval += 1
                if res is not None and res.valid \
                        and objective.satisfies(res):
                    best = res
                else:
                    stats["incumbent_dropped"] = True
                    stats["incumbent"] = False

        # ---- Phase 1: enumerate + DP-rank into the candidate frontier ----
        sim_all = exhaustive or not self.use_heuristics \
            or self.sim_top_k is None
        top_k = None if sim_all else max(1, self.sim_top_k)
        frontier: List[_Candidate] = []
        # max-heap (negated) of the K best rank estimates seen so far; the
        # K-th best is an exact cut for frontier membership by estimate.
        kth_heap: List[float] = []

        def kth_bound() -> Optional[float]:
            if top_k is None or len(kth_heap) < top_k:
                return None
            return -kth_heap[0]

        def note_rank(v: float) -> None:
            if top_k is None:
                return
            if len(kth_heap) < top_k:
                heapq.heappush(kth_heap, -v)
            elif v < -kth_heap[0]:
                heapq.heapreplace(kth_heap, -v)

        seq = 0
        for pp in H.pp_candidates(self.job.cfg.n_layers, total_chips,
                                  self.max_pp):
            if pp_allow is not None and pp not in pp_allow:
                continue
            splits = H.balanced_split(self.profile, pp)
            for mbs in H.mbs_candidates(self.job.global_batch):
                if mbs_allow is not None and mbs not in mbs_allow:
                    continue
                tp_sel = self._tp_selection(pp, splits, mbs, cluster_types)
                if tp_sel is None:
                    n_oom += 1
                    continue
                max_d = self._max_d(pp, tp_sel, region_caps, mbs)
                if max_d == 0:
                    continue
                # capacity-free minimum per-stage compute time: the basis of
                # the lower-bound prune below (no resource assignment can
                # make a stage faster than its fastest (type, tp) option).
                min_t = [min(sum(self.profile.stage_cost(lo, hi, t, tp, mbs)
                                 [:2])
                             for t, tps in sel.items() for tp in tps)
                         for (lo, hi), sel in zip(splits, tp_sel)]
                d_list = H.dp_candidates(self.job.global_batch, mbs, max_d,
                                         decreasing)
                stats["d_enumerated"] += len(d_list)
                min_chips_per_replica = sum(
                    min(min(tps) for tps in sel.values()) for sel in tp_sel)
                group_best_est: Optional[float] = None
                for d in d_list:
                    if d * min_chips_per_replica > total_chips:
                        continue             # cannot fit even the cheapest mix
                    key3 = (pp, mbs, d)
                    cached = reuse.get(key3) if reuse else None
                    if cached is not None and \
                            plan_footprint(cached).isdisjoint(changed_pools) \
                            and plan_fits(cached, cluster):
                        # still this candidate's optimum: skip the DP, rank
                        # by the previous simulated score (phase 2
                        # re-simulates).  Not part of the H3/H4 walk.
                        seq += 1
                        stats["reused"] += 1
                        prev = (reuse_scores or {}).get(key3,
                                                        float("-inf"))
                        frontier.append(_Candidate(
                            seq=seq, key3=key3, est_time=prev, est_cost=prev,
                            choices=None, splits=None, plan=cached,
                            reused=True))
                        continue
                    # lower-bound prune: even with unlimited capacity this
                    # (pp, mbs, d) cannot run an iteration faster than
                    # warmup + steady on its fastest per-stage options.
                    # Bounds: the K-th best DP estimate (exact, est-to-est),
                    # the re-simulated incumbent (x1.1 slack for the
                    # simulator's extra terms), the throughput floor.
                    n_micro = self.job.global_batch // (d * mbs)
                    lb_time = sum(min_t) + (n_micro - 1) * max(min_t)
                    tb: Optional[float] = None
                    if objective.kind == MAX_THROUGHPUT:
                        # frontier/incumbent bounds are widened by
                        # pool_slack: a candidate beyond the top-K cut but
                        # within the slack is still solved for the warm-
                        # replan pool; the throughput floor stays strict
                        # (a candidate that cannot satisfy the constraint
                        # is useless even as a warm start).
                        kth = kth_bound()
                        cands = [kth * self.pool_slack
                                 if kth is not None else None]
                        if best is not None:
                            cands.append(best.t_iter * 1.1
                                         * self.pool_slack)
                        if floor_t is not None:
                            cands.append(floor_t * 1.1)
                        tb = min((c for c in cands if c is not None),
                                 default=None)
                    elif floor_t is not None:
                        # MIN_COST: a candidate that cannot meet the
                        # throughput floor can never satisfy the constraint
                        tb = floor_t * 1.1
                    if tb is not None and lb_time > tb:
                        stats["lb_pruned"] += 1
                        continue
                    n_cand += 1
                    budget_eff = budget
                    if objective.kind == MIN_COST:
                        # frontier/incumbent cost bounds act as the budget
                        # (reuses the §4.2.3 machinery)
                        kth = kth_bound()
                        for c in (kth * self.pool_slack
                                  if kth is not None else None,
                                  best.cost_per_iter * 1.1
                                  if best is not None else None):
                            if c is not None:
                                budget_eff = min(budget_eff or 1e30, c)
                    solver = DPSolver(
                        self.profile, cluster, splits, mbs, d, tp_sel,
                        regions, region_caps, budget=budget_eff,
                        frontier_keep=self.frontier_keep,
                        max_combos=self.max_combos,
                        time_bound=tb, memo=self.memo, prices=prices,
                        state_beam=self.state_beam)
                    part = solver.best(
                        kind=("cost" if objective.kind == MIN_COST
                              else "time"),
                        max_time=floor_t)
                    stats["dp_combos"] += solver.stats["combos"]
                    stats["memo_hits"] += solver.stats["memo_hits"]
                    if part is None:
                        continue    # gap: group best untouched, walk goes on
                    est_t = part.est_time(solver.n_micro)
                    if self.adaptive and d > 1:
                        # rank by the better of the uniform and adaptive
                        # estimates: a heterogeneous mix whose straggler
                        # max looks slow may win once phase 2 rebalances
                        # its per-replica microbatches
                        est_t = min(est_t, solver.adaptive_est_time(part))
                    est_c = part.rate * est_t
                    seq += 1
                    frontier.append(_Candidate(
                        seq=seq, key3=key3, est_time=est_t, est_cost=est_c,
                        choices=solver.decode(part), splits=list(splits)))
                    rank = est_c if objective.kind == MIN_COST else est_t
                    note_rank(rank)
                    # H3/H4 early exit: stop the d-walk when the estimate is
                    # strictly worse than the group's best (plateaus and
                    # invalid-candidate gaps continue — identical semantics
                    # on fresh and warm paths, which skip the walk entirely).
                    if self.use_heuristics:
                        if group_best_est is not None \
                                and rank > group_best_est * (1 + 1e-12):
                            break
                        if group_best_est is None or rank < group_best_est:
                            group_best_est = rank

        # ---- Phase 2: simulate the ranked frontier ----
        stats["frontier_size"] = len(frontier)
        ranked = sorted(frontier, key=self._rank_key(objective))
        n_sim = 0
        for cand in ranked:
            if top_k is not None and n_sim >= top_k and best is not None:
                # past the frontier: keep the materialized plan + its DP
                # estimate in the candidate pool anyway — warm replans
                # repair incumbents / reuse candidates from this pool, and
                # after a shrink the top-K (capacity-maximal) plans rarely
                # still fit, so the smaller-footprint tail is what keeps
                # replans warm.  Materializing is cheap; only simulate()
                # is not (re-simulation happens on reuse).
                plan = cand.plan if cand.plan is not None else _materialize(
                    self.profile, cand.choices, regions, cluster,
                    cand.splits, cand.key3[1], cand.key3[2])
                stats["plans"].setdefault(cand.key3, plan)
                score = (cand.est_cost if objective.kind == MIN_COST
                         else cand.est_time)
                if score != float("-inf"):   # reuse entry w/o reuse_scores
                    stats["scores"].setdefault(cand.key3, score)
                if not cand.reused:
                    # DP estimate, not a simulated score: flagged so the
                    # replanner's incumbent repair tries simulated-score
                    # entries first (estimates are systematically
                    # optimistic).  Reused tail candidates keep their
                    # previous *simulated* score, which the reuse
                    # preconditions (no growth, no reprice, same
                    # objective, footprint-disjoint shrink) keep exact —
                    # capacity never enters simulate().
                    stats["est_keys"].add(cand.key3)
                continue
            if cand.plan is not None:
                plan = cand.plan
            else:
                plan = _materialize(self.profile, cand.choices, regions,
                                    cluster, cand.splits, cand.key3[1],
                                    cand.key3[2])
            res = simulate(self.profile, plan, cluster, self.mem_cfg,
                           self.engine_cfg)
            n_eval += 1
            n_sim += 1
            stats["frontier_simulated"] += 1
            if not res.valid:
                n_oom += 1
                continue
            stats["plans"][cand.key3] = plan
            stats["scores"][cand.key3] = objective.score(res)
            if objective.satisfies(res) and objective.better(best, res):
                best = res
            for vplan in self._plan_variants(plan):
                vres = simulate(self.profile, vplan, cluster, self.mem_cfg,
                                self.engine_cfg)
                n_eval += 1
                stats["variants_simulated"] = \
                    stats.get("variants_simulated", 0) + 1
                if not vres.valid:
                    continue
                # the stored score ranks this candidate on warm replans:
                # it must reflect the best variant-included quality, or a
                # candidate that only wins via its adaptive variant would
                # rank (and get cut) by its weaker uniform score on the
                # warm path while the fresh path keeps it — diverging
                # fresh/warm top-K sets.
                vsc = objective.score(vres)
                if vsc < stats["scores"][cand.key3]:
                    stats["scores"][cand.key3] = vsc
                if objective.satisfies(vres) \
                        and objective.better(best, vres):
                    best = vres
                    stats["variant_adopted"] = vplan.describe()
        for k, v in self.memo.stats.items():
            stats[f"shared_{k}"] = v - memo0.get(k, 0)
        return PlanResult(
            best=best,
            search_time_s=time.perf_counter() - t0,
            n_candidates=n_cand, n_evaluated=n_eval, n_oom=n_oom,
            stats=stats)

    def _plan_variants(self, plan: ParallelPlan) -> List[ParallelPlan]:
        """Adaptive-assignment / bounded-staleness variants of one phase-2
        plan — the extra searched dimensions.  Variants are only *proposed*
        here; phase 2 simulates each and adopts it solely when strictly
        better under the objective, so uniform plans can never lose."""
        out: List[ParallelPlan] = []
        bases = [plan]
        if self.adaptive and plan.assignment is None and plan.dp > 1 \
                and len({s.dp for s in plan.stages}) == 1:
            rates = self.profile.chain_rates(plan)
            lo = min(rates)
            if lo > 0.0 and max(rates) > lo * 1.01:
                ap = adaptive_plan(plan, rates)
                if ap is not None:
                    out.append(ap)
                    bases.append(ap)
        if self.staleness > 0 and plan.staleness == 0:
            # lagged sync only pays where the DP all-reduce crosses zones
            if any(s.dp > 1 and len(s.zones()) > 1 for s in plan.stages):
                out.extend(dataclasses.replace(p, staleness=self.staleness)
                           for p in bases)
        return out

    # -------------------------------------------------------------------------
    @staticmethod
    def _rank_key(objective: Objective):
        """Deterministic frontier order: estimate per the objective,
        constraint-violating estimates last, enumeration index as the
        tie-break.  Reused candidates carry one previous *objective score*
        in both est fields (a cost for MIN_COST, a t_iter otherwise) — the
        units only match the objective's own metric, so the cross-metric
        infeasibility checks must not be applied to them (their previous
        run already satisfied the same objective, which is a precondition
        for reuse)."""
        budget = objective.max_cost_per_iter
        floor_t = (1.0 / objective.min_throughput
                   if objective.min_throughput else None)

        def key(c: _Candidate):
            if objective.kind == MIN_COST:
                infeas = not c.reused and floor_t is not None \
                    and c.est_time > floor_t
                return (1 if infeas else 0, c.est_cost, c.seq)
            infeas = not c.reused and budget is not None \
                and c.est_cost > budget
            return (1 if infeas else 0, c.est_time, c.seq)
        return key

    def _price_table(self, cluster: ClusterSpec, regions: List[str],
                     types: List[str]) -> Dict[Tuple[int, str], float]:
        """Min $/chip-sec per (region_idx, type), shared by every DP solve
        of this call (the per-solver rebuild scanned all zones for every
        (pp, mbs, d) candidate)."""
        prices: Dict[Tuple[int, str], float] = {}
        for ri, rname in enumerate(regions):
            zones = cluster.zones_in_region(rname)
            for t in types:
                prices[(ri, t)] = min(
                    (z.price_per_sec(t) for z in zones), default=0.0)
        return prices

    def _tp_selection(self, pp: int, splits, mbs: int, types: List[str]
                      ) -> Optional[List[Dict[str, List[int]]]]:
        """H2 + scaling: per stage/type, the minimum feasible TP and up to
        two larger powers of two (paper: "memory constraints and scaling
        heuristics") — larger TP trades chips for stage speed, which is how
        heterogeneous pipelines load-balance fast and slow stages."""
        cache_key = (pp, mbs, tuple(types))
        hit = self._tp_sel_cache.get(cache_key)
        if hit is not None:
            return hit or None           # () encodes a cached negative
        out: List[Dict[str, List[int]]] = []
        for i, (lo, hi) in enumerate(splits):
            sel: Dict[str, List[int]] = {}
            for t in types:
                tp = self.tp_table.min_tp(pp, i, lo, hi, mbs, t)
                if tp is not None:
                    opts = [tp]
                    node = H.tp_options(t)[-1]
                    # scaling heuristic: keep a larger TP only if it buys a
                    # real speedup (>=1.25x) — else it just burns chips.
                    while len(opts) < 3 and opts[-1] * 2 <= node:
                        cur, nxt = opts[-1], opts[-1] * 2
                        f0, b0, _ = self.profile.stage_cost(lo, hi, t, cur, mbs)
                        f1, b1, _ = self.profile.stage_cost(lo, hi, t, nxt, mbs)
                        if (f0 + b0) / max(f1 + b1, 1e-12) < 1.25:
                            break
                        opts.append(nxt)
                    sel[t] = opts
            if not sel:
                self._tp_sel_cache[cache_key] = ()
                return None              # no type can host this stage
            out.append(sel)
        self._tp_sel_cache[cache_key] = out
        return out

    def _max_d(self, pp: int, tp_sel, region_caps, mbs: int) -> int:
        """Optimistic upper bound on D (H5: each stage's D replicas live in
        one region): min over stages of the best region's replica capacity,
        clamped to ``global_batch // mbs`` (larger D leaves zero
        microbatches, so the old ``global_batch`` clamp admitted an
        O(global_batch) scan).  Infeasible D values simply produce no DP
        combos and fall through."""
        per_stage = []
        for sel in tp_sel:
            cap = 0
            for pool in region_caps:
                cap = max(cap, sum(pool.get(t, 0) // min(tps)
                                   for t, tps in sel.items()))
            per_stage.append(cap)
        if not per_stage or min(per_stage) == 0:
            return 0
        return min(min(per_stage), self.job.global_batch // mbs)


def plan_for(cfg, cluster: ClusterSpec, objective: Objective,
             seq_len: int, global_batch: int, **kw) -> PlanResult:
    job = TrainJob(cfg=cfg, seq_len=seq_len, global_batch=global_batch)
    return SailorPlanner(job, **kw).plan(cluster, objective)
