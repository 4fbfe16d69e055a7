"""Collective auditor: diff the program's collectives against the priced
plan (counterpart of ``repro/analysis/audit.py``).

The simulator promises the planner that a stage's comm cost is what
``network.py``/``timing.py`` charged.  The collective record of the
port's step (``dist.placement.record_collectives``: every collective of
the mesh, the backward's transposes included) is the ground truth of
what runs, as the compiled post-SPMD HLO is the reference's.
:func:`audit_collectives` (the reference's ``audit_hlo``) diffs the two:

* take every recorded collective (:mod:`repro_torch.analysis.collectives`),
* map its groups onto the physical topology,
* compare per-kind ring-traffic volumes against the predicted comm terms,

and emits the typed findings of DESIGN.md §15 (``VolumeMismatch``,
``CrossZoneAllGather``, ``SilentReshard``, ``UnpricedCollective``,
``UnknownDtype``).

:func:`predicted_comm` derives the predicted per-device volumes from a
:class:`~repro_torch.core.profiler.analytic.JobProfile` with the exact
formulas the simulator charges (Megatron TP all-reduces + ring-scaled DP
gradient sync).  :func:`plan_audit` is the cheap structural gate wired
into ``SailorPlanner(audit=...)`` and the controller — it validates a
plan against the cluster and traces nothing (the program-level audit
runs through ``launch/dryrun.py --audit`` / ``repro_torch.analysis.demo``).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.analysis import collectives as coll_mod
from repro_torch.analysis.collectives import (CROSS_ZONE, CollectiveOp,
                                              DeviceTopology)
from repro_torch.analysis.findings import ERROR, WARNING, Report

# kinds that materialize data somewhere it wasn't: a resharding
GATHER_KINDS = ("all-gather", "all-to-all")
# ignore control scalars (loop counters, the f32[] loss all-reduce)
DEFAULT_MIN_BYTES = 1024
DEFAULT_TOL = 0.2


class AuditError(RuntimeError):
    """Raised by the planner's ``audit="error"`` gate."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(report.render())


def predicted_comm(profile, *, tp: int, dp: int, mbs: int,
                   n_micro: int = 1) -> Dict[str, float]:
    """Per-device collective ring traffic (bytes/step) the simulator
    charges for a (tp, dp) layout of ``profile``'s job — the prediction
    side of the audit diff.

    Mirrors ``profiler.analytic`` + ``simulator.timing``: per block and
    microbatch, 2 TP all-reduces of the activation forward and 4 backward
    (bwd doubles); one DP gradient all-reduce of the TP-sharded parameter
    bytes per step.
    """
    from repro_torch.core.profiler.analytic import DTYPE_BYTES
    from repro_torch.launch.comm import ring_traffic
    cfg = profile.cfg
    tokens = mbs * profile.job.seq_len
    tp_traffic = 0.0
    if tp > 1:
        per_ar = tokens * cfg.d_model * DTYPE_BYTES
        n_ar = 6 * cfg.n_layers * n_micro
        tp_traffic = n_ar * ring_traffic("all-reduce", per_ar, tp)
    dp_traffic = 0.0
    if dp > 1:
        params = profile.stage_params(0, profile.n_partition_units)
        dp_traffic = ring_traffic("all-reduce",
                                  params / tp * DTYPE_BYTES, dp)
    return {"all-reduce": tp_traffic + dp_traffic}


def audit_collectives(record, topology: DeviceTopology,
                      predicted: Dict[str, float], *,
                      tol: float = DEFAULT_TOL,
                      min_bytes: int = DEFAULT_MIN_BYTES,
                      tag: str = "collective-audit") -> Report:
    """Diff the program's collectives against the predicted comm terms
    (the reference's ``audit_hlo``).  ``record`` is a collective record
    (``placement.CollectiveRecord`` or its entries) or a sequence of
    :class:`CollectiveOp`.

    ``predicted``: op kind -> predicted per-device ring traffic in
    bytes/step (trip-count inclusive), e.g. from :func:`predicted_comm`.
    ``tol`` is the relative volume tolerance of the ``VolumeMismatch``
    rule; ops with result smaller than ``min_bytes`` are ignored
    entirely (control scalars).
    """
    items = list(getattr(record, "entries", record))
    ops = items if all(isinstance(op, CollectiveOp) for op in items) else \
        coll_mod.extract_collectives(items)
    report = Report(tag=tag)
    sized = [op for op in ops if op.nbytes >= min_bytes]
    actual = coll_mod.volumes_by_kind(sized, topology)
    report.summary = {
        "actual": actual,
        "predicted": dict(predicted),
        "n_ops": len(sized),
        "n_ops_ignored": len(ops) - len(sized),
        "tol": tol, "min_bytes": min_bytes,
    }
    # dtype coverage first: unpriced bytes poison every volume comparison
    for op in ops:
        for dt in op.unknown_dtypes:
            report.add(
                "UnknownDtype", WARNING,
                f"collective {op.name} ({op.kind}) has dtype {dt!r} "
                f"missing from the byte catalog; its traffic is not in "
                f"the audited totals", where=op.name, dtype=dt,
                op_kind=op.kind)
    # unpredicted kinds: gathers are reshardings, anything else unpriced
    for kind in sorted(actual):
        a = actual[kind]["traffic"]
        p = float(predicted.get(kind, 0.0))
        if p > 0.0:
            continue
        kind_ops = [op for op in sized if op.kind == kind]
        if kind in GATHER_KINDS:
            for op in kind_ops:
                dom = topology.op_domain(op)
                if dom == CROSS_ZONE:
                    report.add(
                        "CrossZoneAllGather", ERROR,
                        f"{op.kind} {op.name} "
                        f"({op.nbytes} B x{op.trip_mult:g}) crosses zones "
                        f"{sorted({topology.zone_of(d) for g in op.groups for d in g})} "
                        f"but the plan priced no cross-zone gather",
                        where=op.name, op_kind=op.kind, nbytes=op.nbytes,
                        trip_mult=op.trip_mult, domain=dom,
                        groups=[list(g) for g in op.groups[:8]])
                else:
                    report.add(
                        "SilentReshard", WARNING,
                        f"unpredicted {op.kind} {op.name} "
                        f"({op.nbytes} B x{op.trip_mult:g}, {dom}): the "
                        f"program reshards where the plan priced nothing",
                        where=op.name, op_kind=op.kind, nbytes=op.nbytes,
                        trip_mult=op.trip_mult, domain=dom)
        else:
            report.add(
                "UnpricedCollective", ERROR,
                f"{kind} volume {a:.0f} B/step in the program but the "
                f"simulator predicted none",
                op_kind=kind, actual=a, predicted=0.0,
                domains=actual[kind]["domains"])
    # volume diff on the kinds both sides know about
    for kind in sorted(set(actual) | set(predicted)):
        a = actual.get(kind, {}).get("traffic", 0.0)
        p = float(predicted.get(kind, 0.0))
        if p <= 0.0:
            continue                      # handled above (or both zero)
        rel = abs(a - p) / max(a, p)
        if rel > tol:
            report.add(
                "VolumeMismatch", ERROR,
                f"{kind}: program moves {a:.0f} B/step, simulator "
                f"predicted {p:.0f} B/step ({rel:.0%} apart, tol "
                f"{tol:.0%})",
                op_kind=kind, actual=a, predicted=p, rel_diff=rel,
                domains=actual.get(kind, {}).get("domains", {}))
        report.summary.setdefault("rel_diff", {})[kind] = rel
    return report


def plan_audit(plan, cluster) -> Report:
    """Structural audit of a materialized plan against the cluster — the
    default gate of ``SailorPlanner(audit=...)``.  Hardware-free and
    O(stages): checks the plan's placement is real (every replica's zone
    exists and pool capacities cover it) and flags stages whose replicas
    span regions (every TP/grad collective of that stage then rides an
    inter-region link).  The program-level audit traces the step and runs
    through ``launch/dryrun.py --audit`` or ``repro_torch.analysis.demo``
    instead.
    """
    from repro_torch.core.planner.search import plan_fits
    report = Report(tag="plan-audit")
    used: Dict = {}
    for si, s in enumerate(plan.stages):
        regions = set()
        for r in s.replicas:
            try:
                z = cluster.zone(r.zone)
            except KeyError:
                report.add("PlanCapacity", ERROR,
                           f"stage {si} placed in unknown zone {r.zone!r}",
                           where=f"stage{si}", zone=r.zone)
                continue
            regions.add(z.region)
            used[(r.zone, r.gpu_type)] = \
                used.get((r.zone, r.gpu_type), 0) + r.tp
        if len(regions) > 1:
            report.add(
                "CrossRegionStage", WARNING,
                f"stage {si} replicas span regions {sorted(regions)}: "
                f"its collectives ride inter-region links",
                where=f"stage{si}", regions=sorted(regions))
    if not plan_fits(plan, cluster):
        over = {f"{zn}/{t}": n for (zn, t), n in sorted(used.items())}
        report.add("PlanCapacity", ERROR,
                   "plan uses chips the cluster no longer has",
                   usage=over)
    if plan.assignment is not None:
        from repro_torch.core.planner.plan import PlanError
        try:
            plan.assignment.validate(plan.global_batch)
        except PlanError as e:
            report.add("BatchAssignment", ERROR,
                       f"adaptive assignment invalid: {e}",
                       assignment=str(plan.assignment))
        else:
            if plan.assignment.dp != plan.dp:
                report.add("BatchAssignment", ERROR,
                           f"assignment has {plan.assignment.dp} replicas "
                           f"but plan dp is {plan.dp}")
            if plan.assignment.max_mbs > plan.mbs:
                report.add("BatchAssignment", ERROR,
                           f"assignment max mbs {plan.assignment.max_mbs} "
                           f"exceeds nominal mbs {plan.mbs} (memory/TP "
                           f"gates were sized for the nominal)")
    if plan.staleness > 0:
        report.add("BoundedStaleness", WARNING,
                   f"plan runs bounded-staleness sync (k={plan.staleness}): "
                   f"gradients may lag up to {plan.staleness} step(s); "
                   f"convergence must be re-pinned for this job",
                   staleness=plan.staleness)
    report.summary = {"n_stages": len(plan.stages),
                      "chips": sum(used.values())}
    return report
