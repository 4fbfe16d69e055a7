"""Per-stage resource assignment via dynamic programming (paper Listing 1).

For a fixed (P, layer split, mbs, D, per-type TP options), choose for every
stage the multiset of D replicas — how many replicas on each (GPU type, TP)
"pseudo-type", in which region — minimizing estimated iteration time under
an optional budget.

    T_iter_est = sum_i(t_i + 2 p2p_i)                (warmup + cooldown)
               + (N_micro - 1) * max_i(t_i + 2 p2p_i) (steady / straggler)
               + max_i(t_sync_i)                      (DP sync bottleneck)

Structure: a *prefix* beam DP over stages.  States after stage ``i`` are
grouped by (remaining capacity, region of stage i) — H5's monotone
stage->region assignment means regions before the current one are dead and
regions after it untouched, so only the current region's remaining pool is
live state.  The combination operators are sums and maxes, so optimal
substructure only holds over a Pareto frontier of partial solutions
(warmup_sum, steady_max, sync_max, $rate, last-stage time); each group
keeps a bounded Pareto front (``frontier_keep``) — the "reuse of
intermediate results" the paper credits for its speed, exact up to the
frontier bound.  On top of that a deterministic global beam
(``state_beam``, best optimistic-completion estimates first) bounds the
per-level state count, which is what holds the solve at thousand-chip
clusters; the beam only truncates when a level outgrows it, so small
instances stay exact (pinned against brute force in tests).

Because the prefix carries its accumulated warmup/steady, the incumbent
bound (``time_bound``) prunes with the *whole* partial pipeline plus a
capacity-free lower bound of the remaining stages — far stronger than
bounding one stage at a time — and the budget constraint (§4.2.3) prunes
with the realized prefix straggler directly, replacing the paper's
assume/solve/re-solve fixpoint loop (lines 17-32 of Listing 1) with a
single monotone-safe pass.

A copy of ``repro/core/planner/dp_solver.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile
from repro_torch.core.simulator import network


@dataclasses.dataclass(frozen=True)
class StageChoice:
    region_idx: int
    counts: Tuple[Tuple[str, int, int], ...]  # ((gpu_type, tp, n_replicas),)


@dataclasses.dataclass(frozen=True)
class Partial:
    """Pareto node for stages i..P-1."""
    warmup: float
    steady: float
    sync: float
    rate: float                              # $/s of chips in these stages
    choices: Tuple                           # internal rep; decoded at end

    def est_time(self, n_micro: int) -> float:
        return self.warmup + max(n_micro - 1, 0) * self.steady + self.sync

    def est_cost(self, n_micro: int) -> float:
        return self.rate * self.est_time(n_micro)


class CandidateMemo:
    """Cross-candidate tables shared by every ``DPSolver`` of one search.

    The outer loop creates one solver per (pp, mbs, d) candidate; before
    this memo each solver rebuilt its per-stage pseudo-type tables (one
    ``stage_cost`` aggregation per (stage, type, tp)), parameter counts and
    link-time constants from scratch — identical work for every ``d`` of a
    (pp, mbs) group, and again on every warm replan.  Everything in here
    depends only on the job profile and the link catalog, NOT on capacity
    or prices, so the long-lived ``SailorPlanner`` owns one instance and
    replans inherit it (``manager/replan.py``).  Capacity-dependent state
    (combo enumeration, the DP memo itself) stays per-solver.

    ``enabled=False`` recomputes every lookup — the benchmark's proxy for
    the pre-memo cost profile (``benchmarks/search_time.py``).
    """

    def __init__(self, profile: JobProfile, enabled: bool = True):
        self.profile = profile
        self.enabled = enabled
        self._pseudo: Dict = {}          # (splits, mbs, tp_sel sig) -> tables
        self._params: Dict = {}          # splits -> [params per stage]
        self._link: Dict = {}            # (kind, LinkSpec, nbytes[, d]) -> s
        self.stats = {"pseudo_builds": 0, "pseudo_hits": 0}

    @staticmethod
    def tp_sel_key(tp_sel: Sequence[Dict[str, List[int]]]) -> Tuple:
        return tuple(tuple((t, tuple(tps)) for t, tps in sorted(s.items()))
                     for s in tp_sel)

    def params_stage(self, splits: Tuple[Tuple[int, int], ...]) -> List[int]:
        hit = self._params.get(splits) if self.enabled else None
        if hit is None:
            hit = [self.profile.stage_params(lo, hi) for lo, hi in splits]
            self._params[splits] = hit
        return hit

    def pseudo_tables(self, splits: Tuple[Tuple[int, int], ...], mbs: int,
                      tp_sel: Sequence[Dict[str, List[int]]],
                      base_types: Sequence[str]
                      ) -> List[List[Tuple[int, int, float]]]:
        """Per-stage pseudo-type options ``(type_idx, tp, fwd+bwd seconds)``,
        sorted fastest-first with a deterministic (time, type, tp) key."""
        key = (splits, mbs, self.tp_sel_key(tp_sel))
        if self.enabled:
            hit = self._pseudo.get(key)
            if hit is not None:
                self.stats["pseudo_hits"] += 1
                return hit
        self.stats["pseudo_builds"] += 1
        tables = []
        for i, (lo, hi) in enumerate(splits):
            opts = []
            for t, tps in tp_sel[i].items():
                ti = base_types.index(t)
                for tp in tps:
                    fwd, bwd, _ = self.profile.stage_cost(lo, hi, t, tp, mbs)
                    opts.append((ti, tp, fwd + bwd))
            opts.sort(key=lambda o: (o[2], o[0], o[1]))
            tables.append(opts)
        if self.enabled:
            self._pseudo[key] = tables
        return tables

    def p2p(self, link, nbytes: int) -> float:
        key = ("p2p", link, nbytes)
        hit = self._link.get(key) if self.enabled else None
        if hit is None:
            hit = network.p2p_time(link, nbytes)
            self._link[key] = hit
        return hit

    def all_reduce(self, link, nbytes: float, d: int) -> float:
        key = ("ar", link, nbytes, d)
        hit = self._link.get(key) if self.enabled else None
        if hit is None:
            hit = network.all_reduce_time(link, nbytes, d)
            self._link[key] = hit
        return hit


class DPSolver:
    def __init__(self, profile: JobProfile, cluster: ClusterSpec,
                 splits: Sequence[Tuple[int, int]], mbs: int, d: int,
                 tp_sel: Sequence[Dict[str, List[int]]],
                 regions: Sequence[str],
                 region_caps: Sequence[Dict[str, int]],
                 budget: Optional[float] = None,
                 frontier_keep: int = 4, max_combos: int = 24,
                 time_bound: Optional[float] = None,
                 memo: Optional[CandidateMemo] = None,
                 prices: Optional[Dict[Tuple[int, str], float]] = None,
                 state_beam: int = 512):
        self.profile = profile
        self.cluster = cluster
        self.splits = list(splits)
        self.pp = len(splits)
        self.mbs = mbs
        self.d = d
        self.tp_sel = list(tp_sel)
        self.regions = list(regions)
        self.budget = budget
        self.keep = frontier_keep
        self.max_combos = max_combos
        # branch & bound: a prefix whose optimistic completion already
        # exceeds this bound cannot win.  The caller pre-applies any slack
        # (x1.1 for bounds derived from simulated results; none for exact
        # est-to-est frontier bounds).
        self.time_bound = time_bound
        self.n_micro = profile.job.global_batch // (d * mbs)
        # deterministic cap on per-level prefix states: exact while levels
        # fit (every small/benchmark grid), quality-ordered truncation at
        # geo scale (stats["beam_truncated"] reports when it engaged).
        self.state_beam = state_beam
        self.stats = {"combos": 0, "memo_hits": 0, "budget_rounds": 0,
                      "states": 0, "beam_truncated": 0}

        # ---- flat capacity vector: one slot per (region, base type) ----
        self.base_types = sorted({t for sel in tp_sel for t in sel})
        self.slot = {(ri, t): ri * len(self.base_types) + k
                     for ri in range(len(self.regions))
                     for k, t in enumerate(self.base_types)}
        caps0 = [0] * (len(self.regions) * len(self.base_types))
        for ri, pool in enumerate(region_caps):
            for t, n in pool.items():
                if t in self.base_types:
                    caps0[self.slot[(ri, t)]] = n
        self.caps0 = tuple(caps0)

        # ---- shared cross-candidate tables (see CandidateMemo) ----
        self.shared = memo if memo is not None else CandidateMemo(profile)
        splits_key = tuple(self.splits)
        self._params_stage = self.shared.params_stage(splits_key)
        self._pseudo = self.shared.pseudo_tables(
            splits_key, mbs, self.tp_sel, self.base_types)

        # ---- prices: min $/chip-sec per (region, type); cluster-dependent,
        # so built per plan() call and passed in (or computed here when the
        # solver is used standalone) ----
        if prices is None:
            prices = {}
            for ri, rname in enumerate(self.regions):
                zones = cluster.zones_in_region(rname)
                for t in self.base_types:
                    prices[(ri, t)] = min(
                        (z.price_per_sec(t) for z in zones), default=0.0)
        self._price = prices
        self._price_row = [[self._price[(ri, t)] for t in self.base_types]
                           for ri in range(len(self.regions))]
        self._cat: Dict = {}
        self._sync_local: Dict = {}

        nbytes = profile.boundary_bytes(mbs)
        self._p2p_intra = self.shared.p2p(cluster.links["intra-zone"], nbytes)
        self._p2p_inter = self.shared.p2p(
            cluster.links["inter-region"], nbytes)
        self._combo_cache: Dict = {}

        # ---- saturating-capacity state reduction (exact) ----
        # Stages i..P-1 can consume at most d * max_tp chips of each type,
        # so any remaining capacity above that bound is interchangeable:
        # clamping the memo key to the bound collapses the state space from
        # O(chips) per slot to O(d * max_tp) without changing any result.
        # This is what holds the DP at thousand-chip clusters, where the
        # raw capacity vector used to make every state unique.
        nt = len(self.base_types)
        max_tp = [[0] * nt for _ in range(self.pp)]
        for i, opts in enumerate(self._pseudo):
            for ti, tp, _ in opts:
                if tp > max_tp[i][ti]:
                    max_tp[i][ti] = tp
        suffix = [[0] * nt for _ in range(self.pp + 1)]
        for i in range(self.pp - 1, -1, -1):
            for k in range(nt):
                suffix[i][k] = suffix[i + 1][k] + d * max_tp[i][k]
        n_slots = len(self.caps0)
        self._need = [tuple(suffix[i][s % nt] for s in range(n_slots))
                      for i in range(self.pp + 1)]
        # H5 region monotonicity makes most of the capacity vector dead
        # weight in the memo key: stages are placed in non-decreasing region
        # order, so at (stage i, region_lo) every region < region_lo can
        # never be consumed again (zero its slots) and every region >
        # region_lo is still untouched.  Canonicalizing the key this way
        # collapses the cross-region state product into a per-region sum —
        # the reduction that holds the DP at multi-region geo scale.
        self._zero_head = [(0,) * (ri * nt)
                           for ri in range(len(self.regions) + 1)]

    # --- stage-local quantities --------------------------------------------------
    def _sync(self, i: int, tp_min: int) -> float:
        if self.d <= 1:
            return 0.0
        key = (i, tp_min)
        hit = self._sync_local.get(key)
        if hit is None:
            nbytes = self._params_stage[i] / tp_min * DTYPE_BYTES
            hit = self.shared.all_reduce(
                self.cluster.links["intra-zone"], nbytes, self.d)
            self._sync_local[key] = hit
        return hit

    # --- combo generation (Listing 1 generate_combos) ------------------------------
    # combo rep: (region_idx, ((pseudo_pos, n), ...), t_i, tp_min,
    #             chips_by_slot, $rate)
    def _catalog(self, i: int):
        """Capacity-independent combo catalog for stage ``i``.

        Pure combos and cross-type pair templates are fixed per stage; the
        only capacity-dependent piece of a mix is the fast-type share
        ``na``, and "biggest share first-feasible" has the closed form
        ``na = min(avail_a, d - 1)`` (valid iff ``na >= d - avail_b``) —
        so ``_combos`` is a linear scan with O(1) work per row instead of
        the old quadratic generate-and-dedup per DP state."""
        hit = self._cat.get(i)
        if hit is not None:
            return hit
        pseudo = self._pseudo[i]
        nt = len(self.base_types)
        d = self.d
        pure = []
        for pos, (ti, tp, t) in enumerate(pseudo):
            consume = [0] * nt
            consume[ti] = d * tp
            pure.append((((pos, d),), ti, d * tp, t, tp, tuple(consume)))
        pairs = []
        for a, (ta, tpa, t_a) in enumerate(pseudo):
            for b in range(a + 1, len(pseudo)):
                tb, tpb, t_b = pseudo[b]
                if ta == tb:
                    continue
                pairs.append((a, b, ta, tpa, tb, tpb,
                              t_a if t_a > t_b else t_b,
                              tpa if tpa < tpb else tpb))
        hit = (pure, pairs)
        self._cat[i] = hit
        return hit

    def _combos(self, i: int, caps: Tuple[int, ...], region_lo: int):
        key = (i, caps, region_lo)
        hit = self._combo_cache.get(key)
        if hit is not None:
            self.stats["memo_hits"] += 1
            return hit
        out = []
        nt = len(self.base_types)
        d = self.d
        pure, pairs = self._catalog(i)
        for ri in range(region_lo, len(self.regions)):
            off = ri * nt
            base = caps[off:off + nt]
            price = self._price_row[ri]
            # 1) pure combos (never truncated away)
            for parts, ti, chips, t_i, tp, consume in pure:
                if base[ti] >= chips:
                    out.append((ri, parts, t_i, tp, consume,
                                price[ti] * chips))
            # 2) two-pseudo mixes across different base types, biggest
            #    fast-type share first
            for a, b, ta, tpa, tb, tpb, t_mx, tp_mn in pairs:
                if len(out) >= self.max_combos:
                    break
                avail_a = base[ta] // tpa
                if avail_a == 0:
                    continue
                na = avail_a if avail_a < d - 1 else d - 1
                if na < 1 or na < d - base[tb] // tpb:
                    continue
                nb = d - na
                consume = [0] * nt
                consume[ta] += na * tpa
                consume[tb] += nb * tpb
                out.append((ri, ((a, na), (b, nb)), t_mx, tp_mn,
                            tuple(consume),
                            price[ta] * na * tpa + price[tb] * nb * tpb))
        self.stats["combos"] += len(out)
        self._combo_cache[key] = out
        return out

    def _canon(self, caps: Tuple[int, ...], i: int,
               region_lo: int) -> Tuple[int, ...]:
        """Canonical capacity key for states entering stage ``i``: dead
        regions (< region_lo, H5 monotonicity) zeroed, live slots clamped
        to what stages i..P-1 can still consume (saturating reduction) —
        both exact state merges."""
        need = self._need[i]
        off_lo = region_lo * len(self.base_types)
        if off_lo:
            return self._zero_head[region_lo] + tuple(
                c if c < n else n
                for c, n in zip(caps[off_lo:], need[off_lo:]))
        return tuple(c if c < n else n for c, n in zip(caps, need))

    # --- prefix beam DP ----------------------------------------------------------
    # State after stage i: (warmup, steady, sync, rate, last_t, caps,
    # last_ri, choices) where ``steady`` is the max unit over stages 0..i-1
    # (stage i's unit is pending until its outgoing boundary is known) and
    # ``caps`` is the canonical remaining capacity.  Plain tuples — the hot
    # loop creates millions of nodes and tuple packing is several times
    # cheaper than dataclass construction; ``best`` wraps the winner back
    # into :class:`Partial` for the public API.
    def solve(self, hard_budget: Optional[float] = None) -> List[Tuple]:
        """Complete-solution Pareto frontier (bounded by ``frontier_keep``)
        as (warmup, steady, sync, rate, choices) tuples.  ``hard_budget``
        enables monotone-safe inline budget pruning (a prefix is dropped
        only when even its optimistic completion exceeds the budget)."""
        nt = len(self.base_types)
        pp = self.pp
        # n1 must match _est_time's max(n_micro - 1, 0): with a 1 floor the
        # n_micro == 1 case (first d of every max-throughput group) would
        # add a steady term the true estimate does not contain, turning the
        # "optimistic" completion into an over-estimate and unsoundly
        # pruning candidates that actually beat the bound.
        n1 = max(self.n_micro - 1, 0)
        # time_bound arrives pre-slacked by the caller (the outer search
        # adds x1.1 only to bounds derived from *simulated* results;
        # est-to-est frontier bounds are exact) — no extra margin here.
        bound = self.time_bound
        # capacity-free per-stage minima for optimistic completion bounds
        min_t = [min(t for _, _, t in opts) if opts else float("inf")
                 for opts in self._pseudo]
        rem_sum = [0.0] * (pp + 1)
        rem_max = [0.0] * (pp + 1)
        for i in range(pp - 1, -1, -1):
            rem_sum[i] = rem_sum[i + 1] + min_t[i]
            rem_max[i] = rem_max[i + 1] if rem_max[i + 1] > min_t[i] \
                else min_t[i]

        states: List[Tuple] = [
            (0.0, 0.0, 0.0, 0.0, 0.0, self._canon(self.caps0, 0, 0), 0, ())]
        for i in range(pp):
            first = i == 0
            nxt: Dict[Tuple, List[Tuple]] = {}
            n_out = 0
            for warmup, steady, sync, rate, last_t, caps, last_ri, choices \
                    in states:
                for ri, parts, t_i, tp_min, consume, rate_i in self._combos(
                        i, caps, last_ri):
                    if first:
                        unit_prev = 0.0
                        nw = t_i
                    else:
                        p2p = (self._p2p_intra if ri == last_ri
                               else self._p2p_inter)
                        unit_prev = last_t + 2 * p2p
                        nw = warmup + 2 * p2p + t_i
                    ns = steady if steady > unit_prev else unit_prev
                    sync_i = self._sync(i, tp_min)
                    ny = sync if sync > sync_i else sync_i
                    nr = rate + rate_i
                    # optimistic completion: remaining stages at their
                    # capacity-free fastest, pending units at least t_i /
                    # the remaining minima.
                    opt_steady = max(ns, t_i, rem_max[i + 1])
                    opt_time = nw + rem_sum[i + 1] + n1 * opt_steady + ny
                    if bound is not None and opt_time > bound:
                        continue             # cannot beat the incumbent
                    if hard_budget is not None \
                            and nr * opt_time > hard_budget:
                        continue
                    new_caps = list(caps)
                    off = ri * nt
                    for k in range(nt):
                        new_caps[off + k] -= consume[k]
                    ccaps = self._canon(tuple(new_caps), i + 1, ri) \
                        if i + 1 < pp else ()
                    node = (nw, ns, ny, nr, t_i, ccaps, ri,
                            choices + ((ri, parts),))
                    group = nxt.setdefault((ccaps, ri), [])
                    dominated = False
                    for q in group:
                        if (q[0] <= nw and q[1] <= ns and q[2] <= ny
                                and q[3] <= nr and q[4] <= t_i):
                            dominated = True
                            break
                    if not dominated:
                        group.append(node)
                        n_out += 1
            self.stats["states"] += n_out
            # bounded Pareto front per (caps, region) group ...
            okey = self._opt_key(n1, rem_sum[i + 1], rem_max[i + 1])
            level: List[Tuple] = []
            for group in nxt.values():
                if len(group) > self.keep:
                    group.sort(key=okey)
                    group = self._pareto(group)
                level.extend(group)
            # ... plus a deterministic global beam on optimistic estimates
            if len(level) > self.state_beam:
                level.sort(key=okey)
                del level[self.state_beam:]
                self.stats["beam_truncated"] += 1
            states = level
            if not states:
                return []
        completes = [(w, s if s > lt else lt, y, r, ch)
                     for w, s, y, r, lt, _, _, ch in states]
        return self._prune(completes)

    def _opt_key(self, n1: int, rem_s: float, rem_m: float):
        """Deterministic state order: optimistic completion time (from the
        precomputed remaining-stage minima), then the capacity key and
        choices as tie-breaks (no insertion-order dependence)."""
        def key(p):
            w, s, y, r, lt = p[0], p[1], p[2], p[3], p[4]
            opt_steady = max(s, lt, rem_m)
            return (w + rem_s + n1 * opt_steady + y, r, p[5], p[7])
        return key

    def _pareto(self, group: List[Tuple]) -> List[Tuple]:
        """First ``keep`` non-dominated states of a pre-sorted group."""
        out = [group[0]]
        for p in group[1:]:
            dominated = False
            for q in out:
                if (q[0] <= p[0] and q[1] <= p[1] and q[2] <= p[2]
                        and q[3] <= p[3] and q[4] <= p[4]):
                    dominated = True
                    break
            if not dominated:
                out.append(p)
                if len(out) >= self.keep:
                    break
        return out

    def _prune(self, frontier: List[Tuple]) -> List[Tuple]:
        if not frontier:
            return frontier
        n1 = max(self.n_micro - 1, 0)
        frontier.sort(key=lambda p: (p[0] + n1 * p[1] + p[2], p[3], p[4]))
        out: List[Tuple] = [frontier[0]]
        for p in frontier[1:]:
            dominated = False
            for q in out:
                if (q[0] <= p[0] and q[1] <= p[1]
                        and q[2] <= p[2] and q[3] <= p[3]):
                    dominated = True
                    break
            if not dominated:
                out.append(p)
                if len(out) >= self.keep:
                    break
        return out

    # --- decode internal choices to StageChoice ------------------------------------
    def adaptive_est_time(self, partial: Partial) -> float:
        """Optimistic iteration time of this candidate under an adaptive
        per-replica :class:`~repro.core.planner.plan.BatchAssignment`.

        Uniform microbatching makes each stage's steady unit the straggler
        max over its replica mix; throughput-proportional sizing is work-
        conserving, so the per-global-microbatch unit drops to the harmonic
        form ``d / sum_j(n_j / t_j)`` over the stage's replica options.
        Under the linear-time model the rebalance equalizes every
        replica's per-micro time at that same unit, so the warmup's
        per-stage straggler terms are replaced by the stage units too
        (p2p terms unchanged).  Each unit is clamped at the stage
        straggler max and the steady at the uniform steady, so the
        estimate never exceeds ``est_time`` — an admissible rank key for
        the adaptive variant phase 2 simulates."""
        if self.d <= 1:
            return partial.est_time(self.n_micro)
        steady = 0.0
        warmup = partial.warmup
        for i, (_ri, parts) in enumerate(partial.choices):
            pseudo = self._pseudo[i]
            inv = 0.0
            tmax = 0.0
            for pos, n in parts:
                t = pseudo[pos][2]
                if t > tmax:
                    tmax = t
                if t > 0.0:
                    inv += n / t
            unit = self.d / inv if inv > 0.0 else 0.0
            if unit > tmax:
                unit = tmax
            warmup -= tmax - unit
            if unit > steady:
                steady = unit
        steady = min(steady, partial.steady)
        n1 = max(self.n_micro - 1, 0)
        return warmup + n1 * steady + partial.sync

    def decode(self, partial: Partial) -> List[StageChoice]:
        out = []
        for i, (ri, parts) in enumerate(partial.choices):
            pseudo = self._pseudo[i]
            counts = []
            for pos, n in parts:
                ti, tp, _ = pseudo[pos]
                counts.append((self.base_types[ti], tp, n))
            out.append(StageChoice(region_idx=ri,
                                   counts=tuple(sorted(counts))))
        return out

    # --- entry with budget loop (§4.2.3) ------------------------------------------
    def _est_time(self, p: Tuple) -> float:
        return p[0] + max(self.n_micro - 1, 0) * p[1] + p[2]

    def _est_cost(self, p: Tuple) -> float:
        return p[3] * self._est_time(p)

    def _select(self, front: List[Tuple], kind: str,
                max_time: Optional[float]) -> Optional[Tuple]:
        if max_time is not None:
            ok = [p for p in front if self._est_time(p) <= max_time]
            front = ok or front          # fall back: simulator re-checks
        if not front:
            return None
        if kind == "cost":
            return min(front, key=self._est_cost)
        return front[0]

    def _wrap(self, p: Optional[Tuple]) -> Optional[Partial]:
        return None if p is None else Partial(*p)

    def best(self, kind: str = "time",
             max_time: Optional[float] = None) -> Optional[Partial]:
        if self.budget is None:
            return self._wrap(self._select(self.solve(), kind, max_time))
        if kind == "cost":
            # budget here is only the incumbent-prune bound; the simulator
            # re-validates — solve unconstrained and prefer in-budget
            # solutions, falling back to the cheapest over-budget one.
            front = self.solve()
            ok = [p for p in front if self._est_cost(p) <= self.budget]
            return self._wrap(self._select(ok or front, kind, max_time))
        # throughput objective under a hard budget: the prefix DP prunes
        # with its realized straggler directly (a prefix is dropped only
        # when even its optimistic completion exceeds the budget), so one
        # budget-aware pass replaces the paper's straggler fixpoint loop.
        self.stats["budget_rounds"] += 1
        front = self.solve(hard_budget=self.budget)
        front = [p for p in front if self._est_cost(p) <= self.budget]
        return self._wrap(self._select(front, kind, max_time))
