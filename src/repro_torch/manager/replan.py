"""Incremental replanning with a warm-start cache (paper §4.2/§4.4).

Sailor re-invokes the planner on *every* availability change, so replan
latency is on the critical path of reconfiguration.  Layered reuse makes
the common replan much cheaper than a cold search:

1. **Exact hit** — results are cached by ``ClusterSpec.fingerprint()``
   (capacity + effective prices).  Fluctuating availability revisits the
   same states constantly (Fig. 2's random walk), so a change back to a
   previously-planned cluster returns instantly.
2. **Certification** — shrinking capacity only removes options, so the
   previous optimum lower-bounds the new one; if a repaired previous
   candidate lands within ``certify_eps`` of it, that candidate is
   returned without searching at all (chain-capped so the bound cannot
   drift across consecutive certifications).
3. **Incumbent seeding** — the best previous candidate that (rehomed onto
   the new cluster) still fits is re-simulated and passed to the search
   as the incumbent, so branch-&-bound time/budget pruning bites from the
   first candidate instead of only after a good plan is found.
4. **Candidate reuse** — for shrink-only deltas, per-(pp, mbs, d) winners
   from the previous search whose resource footprint is disjoint from the
   shrunk pools are re-simulated instead of re-solved (removing capacity a
   plan never used cannot change that candidate's optimum); see
   ``SailorPlanner.plan``'s ``reuse=`` hook.  The previous scores ride
   along (``reuse_scores=``) so reused candidates rank correctly in the
   planner's phase-2 simulation frontier.
5. **Neighborhood restriction** — after a small delta (<= 25 % of total
   capacity) the outer search only visits (pp, mbs) near the previous
   optimum, falling back to the full space if nothing valid is found.

Invalidation: a grown pool disables (4); any price move disables (2) and
(4) — cheaper chips can shift the optimal region or push optimal cost
below the previous bound.  On top of everything the single long-lived
``SailorPlanner`` keeps its availability-independent tables warm across
replans: the H2 ``TPTable``, the profiler's per-layer cost cache, and the
cross-candidate ``CandidateMemo`` (per-(pp, split) pseudo-type tables and
link constants shared by every DP solve — warm replans inherit it, so
their DP phase skips the table builds entirely; hit counts surface in
``result.stats["shared_pseudo_hits"]``).

Every returned ``PlanResult`` carries the cache outcome in
``result.stats``: ``cache`` is ``"hit"`` / ``"warm"`` / ``"cold"``, plus
``certified``, ``restricted``, ``reused`` (candidates that skipped the
DP) and ``incumbent``.

A copy of ``repro/manager/replan.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.objectives import Objective
from repro_torch.core.planner.search import (PlanResult, SailorPlanner,
                                       plan_fits, plan_footprint,
                                       rehome_plan)
from repro_torch.core.simulator.simulate import SimResult, simulate
from repro_torch.core.profiler.analytic import TrainJob


class IncrementalReplanner:
    """Plan cache + warm-start wrapper around one ``SailorPlanner``.

    ``certify_eps`` bounds the suboptimality a certified (search-skipping)
    replan may accept; ``max_certified_chain`` forces a full search after
    that many consecutive certifications so the bound cannot drift
    unboundedly (each certification is relative to the previous result).
    ``repair_tries`` caps how many cached candidates are rehomed/simulated
    while hunting for an incumbent.
    """

    def __init__(self, job: TrainJob, objective: Objective,
                 max_cache: int = 64, certify_eps: float = 0.05,
                 max_certified_chain: int = 5, repair_tries: int = 8,
                 **planner_kw):
        self.job = job
        self.objective = objective
        # widen the planner's candidate pool: replans repair incumbents,
        # certify, and reuse candidates out of stats["plans"], so the
        # search keeps (DP-solves and materializes, without simulating)
        # candidates within 2.5x of its frontier bound — small-footprint
        # plans that become the warm start after a capacity shrink.
        planner_kw.setdefault("pool_slack", 2.5)
        self.planner = SailorPlanner(job, **planner_kw)
        self.max_cache = max_cache
        self.certify_eps = certify_eps
        self.max_certified_chain = max_certified_chain
        self.repair_tries = repair_tries
        self._cache: Dict[Tuple, PlanResult] = {}        # fingerprint -> res
        self._last: Optional[Tuple[ClusterSpec, PlanResult]] = None
        self._last_obj: Optional[Objective] = None       # obj behind _last
        self._chain = 0                                  # certifications
        self.stats = {"replans": 0, "exact_hits": 0, "certified": 0,
                      "warm": 0, "cold": 0}

    # -------------------------------------------------------------------------
    def replan(self, cluster: ClusterSpec,
               objective: Optional[Objective] = None) -> PlanResult:
        """Plan for ``cluster``; warm-started from the previous replan where
        sound.  ``objective`` overrides the default for this call only
        (e.g. a PriceChange-triggered switch to min-cost); overridden calls
        bypass the exact-hit cache, which is keyed for the default."""
        t0 = time.perf_counter()
        self.stats["replans"] += 1
        obj = objective if objective is not None else self.objective
        fp = cluster.fingerprint()
        if objective is None:
            hit = self._cache.get(fp)
            if hit is not None:
                self.stats["exact_hits"] += 1
                out = dataclasses.replace(
                    hit, search_time_s=time.perf_counter() - t0,
                    stats={**hit.stats, "cache": "hit"})
                self._last = (cluster, hit)
                self._last_obj = obj
                return out

        incumbent = reuse = reuse_scores = None
        changed = frozenset()
        shrink_only = False
        # cached candidates were optimal *for the objective they were
        # solved under*; a different objective this call (or last call)
        # voids every optimality-based shortcut — only incumbent seeding
        # (a mere feasible bound) survives.
        same_obj = self._last_obj == obj
        if self._last is not None:
            prev_cluster, prev = self._last
            delta = prev_cluster.capacity_diff(cluster)
            grew = any(n > o for o, n in delta.values())
            # any price move invalidates cached-candidate optimality (the
            # optimum may shift regions) and the shrink-only bound (cheaper
            # chips can push the optimal cost *below* the previous one).
            repriced = bool(prev_cluster.price_diff(cluster))
            shrink_only = bool(delta) and not grew and not repriced \
                and same_obj
            if not grew and not repriced and same_obj:
                reuse = prev.stats.get("plans") or None
                reuse_scores = prev.stats.get("scores") or None
                changed = frozenset(delta)
            incumbent = self._repair_incumbent(prev, cluster, obj)

        if shrink_only and incumbent is not None \
                and self._chain < self.max_certified_chain \
                and not self._last[1].stats.get("restricted", False):
            # (a restricted-search result was never proven optimal, so it
            # cannot serve as the lower bound the certification relies on)
            prev_best = self._last[1].best
            if prev_best is not None and obj.score(incumbent) <= \
                    obj.score(prev_best) * (1.0 + self.certify_eps):
                # Shrinking capacity can only remove options, so the
                # previous optimum bounds the new one from below; an
                # incumbent within certify_eps of it is within certify_eps
                # of the new optimum — skip the search entirely.
                self._chain += 1
                self.stats["certified"] += 1
                result = PlanResult(
                    best=incumbent,
                    search_time_s=time.perf_counter() - t0,
                    n_candidates=0, n_evaluated=1, n_oom=0,
                    stats={**self._last[1].stats, "cache": "warm",
                           "certified": True, "incumbent": True,
                           "reused": 0, "restricted": False})
                if objective is None:
                    self._store(fp, result)
                self._last = (cluster, result)
                self._last_obj = obj
                return result

        self._chain = 0
        warm = incumbent is not None or reuse is not None
        pp_allow = mbs_allow = None
        if same_obj and self._last is not None \
                and self._last[1].best is not None \
                and self._small_delta(self._last[0], cluster):
            # small delta: plan shape rarely jumps — search a (pp, mbs)
            # neighborhood of the previous optimum first.
            prev_plan = self._last[1].best.plan
            p0, m0 = prev_plan.pp, prev_plan.mbs
            pp_allow = frozenset({max(1, p0 - 1), p0, p0 + 1, 2 * p0,
                                  max(1, p0 // 2)})
            mbs_allow = frozenset({max(1, m0 // 2), m0, 2 * m0})
            warm = True
        restricted = pp_allow is not None
        result = self.planner.plan(cluster, obj, incumbent=incumbent,
                                   reuse=reuse, reuse_scores=reuse_scores,
                                   changed_pools=changed,
                                   pp_allow=pp_allow, mbs_allow=mbs_allow)
        if restricted and (result.best is None
                           or result.stats.get("frontier_simulated",
                                               result.n_evaluated) == 0):
            # the neighborhood produced no valid candidate at all (best, if
            # set, is just the seeded incumbent; frontier_simulated counts
            # candidate simulations only, excluding the incumbent's own
            # revalidation) — widen to the full space
            restricted = False
            result = self.planner.plan(cluster, obj, incumbent=incumbent,
                                       reuse=reuse,
                                       reuse_scores=reuse_scores,
                                       changed_pools=changed)
        result = dataclasses.replace(
            result, search_time_s=time.perf_counter() - t0,
            stats={**result.stats, "cache": "warm" if warm else "cold",
                   "certified": False, "restricted": restricted})
        self.stats["warm" if warm else "cold"] += 1
        if objective is None:
            self._store(fp, result)
        self._last = (cluster, result)
        self._last_obj = obj
        return result

    # -------------------------------------------------------------------------
    def _small_delta(self, prev_cluster: ClusterSpec,
                     cluster: ClusterSpec, frac: float = 0.25) -> bool:
        """Did total capacity move by <= ``frac``?  Beyond that the optimal
        plan shape can jump arbitrarily and the neighborhood restriction
        would be guessing."""
        old = max(1, prev_cluster.total_chips())
        return abs(cluster.total_chips() - old) / old <= frac

    def _repair_incumbent(self, prev: PlanResult, cluster: ClusterSpec,
                          obj: Objective) -> Optional[SimResult]:
        """Best previously-seen candidate that (rehomed) still fits the new
        cluster, tried in previous-score order — rehoming preserves the
        region-level structure, so the first few tries cover the best
        feasible cached plan in practice."""
        plans = prev.stats.get("plans") or {}
        scores = prev.stats.get("scores") or {}
        # simulated scores first: est-scored pool entries (never simulated,
        # systematically optimistic DP estimates) must not burn the repair
        # budget ahead of validated candidates.
        est_keys = prev.stats.get("est_keys") or set()
        order = sorted(plans, key=lambda k: (k in est_keys,
                                             scores.get(k, float("inf"))))
        best: Optional[SimResult] = None
        tried = 0
        for key in order:
            if tried >= self.repair_tries:
                break
            rehomed = rehome_plan(plans[key], cluster)
            if rehomed is None:
                continue
            tried += 1
            # same memory model + engine schedule as the planner's own
            # evaluations, so a repaired incumbent's feasibility verdict
            # (schedule-aware in-flight counts, usable-HBM gate) can never
            # disagree with the search it seeds.
            res = simulate(self.planner.profile, rehomed, cluster,
                           self.planner.mem_cfg, self.planner.engine_cfg)
            if res.valid and obj.satisfies(res) and \
                    (best is None or obj.better(best, res)):
                best = res
                break                # score order: first feasible is best
        return best

    def _store(self, fp: Tuple, result: PlanResult) -> None:
        if len(self._cache) >= self.max_cache:
            self._cache.pop(next(iter(self._cache)))
        self._cache[fp] = result

    @property
    def last_result(self) -> Optional[PlanResult]:
        return self._last[1] if self._last else None


__all__ = ["IncrementalReplanner", "plan_fits", "plan_footprint"]
