"""Parallelization-plan data model (paper §4.2).

A plan is: P pipeline stages, a (uniform) data-parallel degree D, and for
every stage the D replicas — each replica a ``(gpu_type, tp, zone)`` tuple
(heterogeneity lives here: replicas of one stage may use different
GPU types/TP degrees, and stages may sit in different regions) — plus the
microbatch size.  The same object feeds the simulator, the benchmarks, and
the launcher bridge (``to_runtime_plan``).

A copy of ``repro/core/planner/plan.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple


class PlanError(ValueError):
    """A plan failed structural validation.

    Typed (not a bare ``assert``) so the check survives ``python -O`` and
    callers — the planner's audit hook, the CLI, the manager — can report
    the violation instead of crashing.
    """


@dataclasses.dataclass(frozen=True)
class StageReplica:
    gpu_type: str
    tp: int
    zone: str

    @property
    def n_chips(self) -> int:
        return self.tp


@dataclasses.dataclass(frozen=True)
class StageConfig:
    layer_start: int
    layer_end: int              # exclusive
    replicas: Tuple[StageReplica, ...]

    @property
    def n_layers(self) -> int:
        return self.layer_end - self.layer_start

    @property
    def dp(self) -> int:
        return len(self.replicas)

    @property
    def n_chips(self) -> int:
        return sum(r.n_chips for r in self.replicas)

    def zones(self) -> List[str]:
        return sorted({r.zone for r in self.replicas})


@dataclasses.dataclass(frozen=True)
class ReplicaBatch:
    """Microbatch workload of one DP replica chain: ``n_micro`` microbatches
    of ``mbs`` sequences each per iteration."""
    mbs: int
    n_micro: int

    @property
    def samples(self) -> int:
        return self.mbs * self.n_micro


@dataclasses.dataclass(frozen=True)
class BatchAssignment:
    """Per-DP-replica microbatch assignment (adaptive microbatching).

    Entry ``d`` applies to replica chain ``d`` of *every* pipeline stage
    (plans carrying an assignment must have uniform per-stage DP, which is
    what the planner emits).  Conservation is exact —
    ``sum(b_d * n_d) == global_batch`` — and the unbiased gradient weight of
    chain ``d`` is ``w_d = b_d * n_d / B`` so the combined update equals the
    full-batch mean gradient (Tyagi & Sharma, arXiv:2305.12213).
    """
    replicas: Tuple[ReplicaBatch, ...]

    @property
    def dp(self) -> int:
        return len(self.replicas)

    @property
    def total_samples(self) -> int:
        return sum(r.samples for r in self.replicas)

    @property
    def max_mbs(self) -> int:
        return max(r.mbs for r in self.replicas)

    @property
    def max_n_micro(self) -> int:
        return max(r.n_micro for r in self.replicas)

    def weights(self) -> Tuple[float, ...]:
        """Unbiased per-replica gradient weights ``w_d = b_d * n_d / B``."""
        b = self.total_samples
        return tuple(r.samples / b for r in self.replicas)

    def is_uniform(self) -> bool:
        return len({(r.mbs, r.n_micro) for r in self.replicas}) <= 1

    def validate(self, global_batch: int) -> None:
        if not self.replicas:
            raise PlanError("empty batch assignment")
        for d, r in enumerate(self.replicas):
            if r.mbs < 1 or r.n_micro < 1:
                raise PlanError(
                    f"replica {d}: mbs={r.mbs} n_micro={r.n_micro} "
                    "(both must be >= 1)")
        if self.total_samples != global_batch:
            raise PlanError(
                f"assignment covers {self.total_samples} samples, "
                f"global_batch={global_batch} (conservation must be exact)")

    @classmethod
    def uniform(cls, dp: int, mbs: int, n_micro: int) -> "BatchAssignment":
        return cls(replicas=tuple(ReplicaBatch(mbs, n_micro)
                                  for _ in range(dp)))

    @classmethod
    def proportional(cls, rates: Sequence[float], global_batch: int,
                     n_micro: int, max_mbs: int = 0
                     ) -> Optional["BatchAssignment"]:
        """Throughput-proportional sizing with exact conservation.

        Every chain runs the same ``n_micro`` microbatches (keeping the
        1F1B pipeline depth aligned across the DP group) but chain ``d``'s
        microbatch size ``b_d`` is apportioned proportional to ``rates[d]``
        (samples/s) by largest remainder, each at least 1, summing exactly
        to ``global_batch // n_micro``.  Returns None when no integral
        assignment exists (``global_batch`` not divisible by ``n_micro``,
        fewer per-micro samples than chains, or a ``max_mbs`` cap that
        cannot hold the apportionment).
        """
        dp = len(rates)
        if dp < 1 or n_micro < 1 or global_batch % n_micro != 0:
            return None
        per_micro = global_batch // n_micro
        if per_micro < dp:
            return None
        total_rate = float(sum(rates))
        if total_rate <= 0.0:
            return None
        quotas = [per_micro * float(r) / total_rate for r in rates]
        sizes = [max(1, int(q)) for q in quotas]
        rem = per_micro - sum(sizes)
        if rem < 0:
            # floors + the >=1 clamps overshot: shave the largest sizes.
            order = sorted(range(dp), key=lambda d: (-sizes[d], d))
            i = 0
            while rem < 0:
                d = order[i % dp]
                if sizes[d] > 1:
                    sizes[d] -= 1
                    rem += 1
                i += 1
        else:
            # hand out the remainder by largest fractional part.
            order = sorted(range(dp),
                           key=lambda d: (-(quotas[d] - int(quotas[d])), d))
            for i in range(rem):
                sizes[order[i % dp]] += 1
        if max_mbs > 0 and max(sizes) > max_mbs:
            return None
        asg = cls(replicas=tuple(ReplicaBatch(b, n_micro) for b in sizes))
        asg.validate(global_batch)
        return asg


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    stages: Tuple[StageConfig, ...]
    mbs: int                    # microbatch size (sequences)
    global_batch: int
    # Adaptive microbatching (None => the classic uniform plan; every
    # consumer treats uniform plans byte-identically to before the field
    # existed).  ``mbs`` stays the *nominal* (largest per-replica) size so
    # memory gates and TP pre-computation remain conservative.
    assignment: Optional[BatchAssignment] = None
    # Bounded-staleness DP sync: a replica may apply updates lagging up to
    # ``staleness`` steps behind the freshest gradient, hiding high-latency
    # DP all-reduce edges behind compute.  0 == fully synchronous.
    staleness: int = 0

    @property
    def pp(self) -> int:
        return len(self.stages)

    @property
    def dp(self) -> int:
        return self.stages[0].dp

    @property
    def num_microbatches(self) -> int:
        if self.assignment is not None:
            return self.assignment.max_n_micro
        return self.global_batch // (self.dp * self.mbs)

    @property
    def adaptive(self) -> bool:
        return self.assignment is not None

    def replica_mbs(self, d: int) -> int:
        """Microbatch size of DP replica chain ``d`` (uniform: ``mbs``)."""
        if self.assignment is None:
            return self.mbs
        return self.assignment.replicas[d].mbs

    def replica_n_micro(self, d: int) -> int:
        """Microbatch count of DP replica chain ``d``."""
        if self.assignment is None:
            return self.num_microbatches
        return self.assignment.replicas[d].n_micro

    def grad_weights(self) -> Tuple[float, ...]:
        """Per-chain gradient weights ``w_d = b_d * n_d / B`` (uniform:
        ``1/dp`` each) — the unbiased combine weights for the DP update."""
        if self.assignment is None:
            return tuple(1.0 / self.dp for _ in range(self.dp))
        return self.assignment.weights()

    @property
    def n_chips(self) -> int:
        return sum(s.n_chips for s in self.stages)

    def chips_by_type(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for s in self.stages:
            for r in s.replicas:
                out[r.gpu_type] = out.get(r.gpu_type, 0) + r.n_chips
        return out

    def validate(self) -> None:
        if not self.stages:
            raise PlanError("empty plan")
        if self.staleness < 0:
            raise PlanError(f"staleness={self.staleness} (must be >= 0)")
        if self.assignment is not None:
            # Adaptive plans require uniform per-stage DP: the assignment
            # keys work by replica *chain*, which only exists when every
            # stage has the same replica count.
            dps = {s.dp for s in self.stages}
            if dps != {self.assignment.dp}:
                raise PlanError(
                    f"adaptive assignment over {self.assignment.dp} chains "
                    f"but stage dp degrees are {sorted(dps)} "
                    "(uniform dp required)")
            self.assignment.validate(self.global_batch)
            if self.mbs < self.assignment.max_mbs:
                raise PlanError(
                    f"nominal mbs={self.mbs} below the largest per-replica "
                    f"microbatch {self.assignment.max_mbs} (nominal must "
                    "cover the peak so memory gates stay conservative)")
            return
        if self.global_batch % (self.dp * self.mbs) != 0:
            raise PlanError(
                f"global_batch={self.global_batch} not divisible by "
                f"dp*mbs={self.dp}*{self.mbs}")
        # Sailor's own planner emits uniform DP per stage (paper H), but
        # externally built plans may fan boundary traffic in/out between
        # stages of unequal DP degree — the simulator routes them through
        # timing.boundary_route.  Each stage must still tile the global
        # microbatch stream evenly.
        total = self.global_batch // self.mbs
        for s in self.stages:
            if total % s.dp != 0:
                raise PlanError(
                    f"{total} microbatches do not tile stage dp={s.dp}")

    def describe(self) -> str:
        head = (f"P={self.pp} D={self.dp} mbs={self.mbs} "
                f"n_micro={self.num_microbatches} chips={self.n_chips}")
        if self.assignment is not None:
            head += " adaptive[" + ",".join(
                f"{r.mbs}x{r.n_micro}" for r in self.assignment.replicas) \
                + "]"
        if self.staleness:
            head += f" staleness={self.staleness}"
        lines = [head]
        for i, s in enumerate(self.stages):
            kinds: Dict[Tuple[str, int, str], int] = {}
            for r in s.replicas:
                key = (r.gpu_type, r.tp, r.zone)
                kinds[key] = kinds.get(key, 0) + 1
            desc = ", ".join(f"{n}x({g},tp={t},{z})"
                             for (g, t, z), n in sorted(kinds.items()))
            lines.append(f"  stage{i} L[{s.layer_start}:{s.layer_end}) {desc}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """A serving placement: N decode replicas (each a full model copy at
    some TP on some GPU type in some zone) plus, when prefill/decode are
    disaggregated, a separate pool of prefill replicas that stream freshly
    built KV pages to the decoders.  The serving sibling of
    :class:`ParallelPlan` — replica *count* and the disaggregation split
    are the plan dimensions the serving planner searches over, instead of
    pp/dp/mbs."""

    decode: Tuple[StageReplica, ...]         # one entry per decode replica
    prefill: Tuple[StageReplica, ...] = ()   # empty => unified replicas
    decode_batch: int = 8                    # continuous-batching slots
    page_size: int = 16                      # paged-KV page, tokens
    max_ctx: int = 1024                      # per-request context budget

    @property
    def disaggregated(self) -> bool:
        return len(self.prefill) > 0

    @property
    def n_replicas(self) -> int:
        return len(self.decode)

    @property
    def n_chips(self) -> int:
        return (sum(r.n_chips for r in self.decode)
                + sum(r.n_chips for r in self.prefill))

    def chips_by_type(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for r in self.decode + self.prefill:
            out[r.gpu_type] = out.get(r.gpu_type, 0) + r.n_chips
        return out

    def zones(self) -> List[str]:
        return sorted({r.zone for r in self.decode + self.prefill})

    def validate(self) -> None:
        if not self.decode:
            raise PlanError("serving plan needs at least one decode replica")
        if self.decode_batch < 1 or self.page_size < 1 or self.max_ctx < 1:
            raise PlanError(
                f"decode_batch={self.decode_batch} page_size={self.page_size}"
                f" max_ctx={self.max_ctx} (all must be >= 1)")

    def describe(self) -> str:
        def pool(tag: str, reps: Tuple[StageReplica, ...]) -> str:
            kinds: Dict[Tuple[str, int, str], int] = {}
            for r in reps:
                key = (r.gpu_type, r.tp, r.zone)
                kinds[key] = kinds.get(key, 0) + 1
            desc = ", ".join(f"{n}x({g},tp={t},{z})"
                             for (g, t, z), n in sorted(kinds.items()))
            return f"  {tag}: {desc}"
        lines = [f"serving R={self.n_replicas}"
                 f"{' disagg' if self.disaggregated else ''} "
                 f"slots={self.decode_batch} page={self.page_size} "
                 f"ctx={self.max_ctx} chips={self.n_chips}",
                 pool("decode", self.decode)]
        if self.prefill:
            lines.append(pool("prefill", self.prefill))
        return "\n".join(lines)


def homogeneous_plan(gpu_type: str, zone: str, pp: int, dp: int, tp: int,
                     n_layers: int, mbs: int, global_batch: int
                     ) -> ParallelPlan:
    """Uniform plan helper (what homogeneous baselines emit)."""
    per = n_layers // pp
    bounds = [i * per for i in range(pp)] + [n_layers]
    stages = tuple(
        StageConfig(bounds[i], bounds[i + 1],
                    tuple(StageReplica(gpu_type, tp, zone)
                          for _ in range(dp)))
        for i in range(pp))
    return ParallelPlan(stages=stages, mbs=mbs, global_batch=global_batch)


def adaptive_plan(plan: ParallelPlan, rates: Sequence[float],
                  max_mbs: int = 0) -> Optional[ParallelPlan]:
    """Adaptive variant of a uniform plan, sized from per-chain throughputs.

    Keeps the plan's microbatch count per chain and apportions the
    per-microbatch samples proportional to ``rates`` (one entry per DP
    chain).  ``mbs`` is raised to the largest per-replica size so the
    nominal stays the conservative memory bound.  Returns None when the
    plan already is adaptive, has dp<2 or non-uniform per-stage dp, or no
    integral assignment exists.
    """
    if plan.assignment is not None or plan.dp < 2:
        return None
    if len({s.dp for s in plan.stages}) != 1:
        return None
    if len(rates) != plan.dp:
        return None
    n_micro = plan.num_microbatches
    if n_micro < 1:
        return None
    asg = BatchAssignment.proportional(rates, plan.global_batch,
                                       n_micro, max_mbs=max_mbs)
    if asg is None or asg.is_uniform():
        return None
    return dataclasses.replace(plan, mbs=max(plan.mbs, asg.max_mbs),
                               assignment=asg)
