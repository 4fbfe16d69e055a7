"""Geo-distributed cost planning (paper §5.2.3/5.2.4, Figs 10-12).

Shows the cost/throughput frontier Sailor navigates across regions:
egress-priced pipeline traffic vs. cheaper far-away capacity, budget caps,
and throughput floors — and compares against the DTFM baseline.

    PYTHONPATH=src python -m repro_torch.examples.geo_cost_planning

The counterpart of the reference's ``examples/geo_cost_planning.py``: the
same calls on the same fleet, so the same plans, prices and replanner
outcomes (only the search times differ).  The planner runs on the host,
so it runs anywhere and takes no ``--device``.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.cluster import multi_zone
from repro_torch.core.planner.baselines import dtfm
from repro_torch.core.planner.baselines.common import evaluate_ranked
from repro_torch.core.planner.objectives import (MAX_THROUGHPUT, MIN_COST,
                                                 Objective)
from repro_torch.core.planner.search import plan_for
from repro_torch.core.profiler.analytic import JobProfile, TrainJob
from repro_torch.manager import (AvailabilityMonitor, IncrementalReplanner,
                                 ListFeed, NodeFailure, PriceChange)

ZONES = {
    "us-central1-a": ("us-central1", {"A100-40": 32}),
    "us-central1-b": ("us-central1", {"A100-40": 32}),
    "us-central1-c": ("us-central1", {"A100-40": 32}),
    "us-central1-f": ("us-central1", {"A100-40": 32}),
    "us-west1-a":    ("us-west1",    {"A100-40": 32}),
}
MODEL = "opt-350m"
SEQ, GBS = 2048, 2048
CAPS = (0.10, 0.25, 0.50, 1.00)


def _chips_by_zone(plan) -> Dict[str, int]:
    by_zone: Dict[str, int] = {}
    for s in plan.stages:
        for rep in s.replicas:
            by_zone[rep.zone] = by_zone.get(rep.zone, 0) + rep.tp
    return by_zone


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Plan, print the reference's report, return its figures."""
    argparse.ArgumentParser(
        description=__doc__.strip().splitlines()[0]).parse_args(argv)
    cluster = multi_zone(ZONES)
    model = get_config(MODEL)
    out: Dict[str, Any] = {}

    print("=== Sailor: max throughput across 5 zones / 2 regions ===")
    res = plan_for(model, cluster, Objective(MAX_THROUGHPUT), SEQ, GBS)
    print(f"search {res.search_time_s:.2f}s -> {res.best.throughput:.3f} "
          f"it/s, ${res.best.cost_per_iter:.3f}/iter "
          f"(egress ${res.best.cost_comm:.4f}/iter)")
    print(res.best.plan.describe())
    out["sailor"] = dict(throughput=res.best.throughput,
                         cost_per_iter=res.best.cost_per_iter,
                         cost_comm=res.best.cost_comm,
                         plan=res.best.plan.describe(),
                         search_time_s=res.search_time_s)

    print("\n=== DTFM baseline on the same fleet ===")
    job = TrainJob(cfg=model, seq_len=SEQ, global_batch=GBS)
    bres = dtfm.plan(job, cluster)
    best, n_oom = evaluate_ranked(bres, JobProfile(job), cluster,
                                  Objective(MAX_THROUGHPUT))
    out["dtfm"] = None
    if best:
        speedup = res.best.throughput / best.throughput
        saving = best.cost_per_iter / res.best.cost_per_iter
        print(f"search {bres.search_time_s:.2f}s -> {best.throughput:.3f} "
              f"it/s, ${best.cost_per_iter:.3f}/iter ({n_oom} OOM plans "
              f"first)")
        print(f"Sailor vs DTFM: {speedup:.1f}x throughput, "
              f"{saving:.1f}x cheaper per iteration")
        out["dtfm"] = dict(throughput=best.throughput,
                           cost_per_iter=best.cost_per_iter, n_oom=n_oom,
                           plan=best.plan.describe(), speedup=speedup,
                           saving=saving, search_time_s=bres.search_time_s)

    print("\n=== budget sweep: what does a $/iter cap cost in throughput? "
          "===")
    out["budget"] = []
    for cap in CAPS:
        r = plan_for(model, cluster,
                     Objective(MAX_THROUGHPUT, max_cost_per_iter=cap),
                     SEQ, GBS)
        if r.best:
            print(f"  cap ${cap:.2f}: {r.best.throughput:6.3f} it/s "
                  f"using {r.best.plan.n_chips:3d} chips "
                  f"(${r.best.cost_per_iter:.3f}/iter)")
            out["budget"].append(dict(cap=cap, throughput=r.best.throughput,
                                      n_chips=r.best.plan.n_chips,
                                      cost_per_iter=r.best.cost_per_iter))
        else:
            print(f"  cap ${cap:.2f}: infeasible")
            out["budget"].append(dict(cap=cap, throughput=None))

    # spot prices and preemption drive min-cost replans through the
    # warm-start cache: the monitor diffs a scripted feed of snapshots
    # into typed events, and every PriceChange or NodeFailure replans
    print("\n=== spot market: PriceChange events -> min-cost replans ===")
    floor = Objective(MIN_COST, min_throughput=res.best.throughput * 0.2)
    replanner = IncrementalReplanner(job, floor)
    base = replanner.replan(cluster)
    print(f"baseline: ${base.best.cost_per_iter:.3f}/iter on "
          f"{base.best.plan.n_chips} chips "
          f"({base.search_time_s * 1e3:.0f}ms {base.stats['cache']})")
    out["spot_baseline"] = dict(cost_per_iter=base.best.cost_per_iter,
                                n_chips=base.best.plan.n_chips,
                                cache=base.stats["cache"],
                                search_time_s=base.search_time_s)
    west_discount = cluster.with_price({("us-west1-a", "A100-40"): 1.20})
    west_preempted = west_discount.with_capacity(
        {("us-west1-a", "A100-40"): 16})
    feed = ListFeed([
        (600.0, west_discount),      # spot discount appears in us-west1
        (1200.0, west_preempted),    # half the discounted pool is preempted
        (1800.0, cluster),           # price reverts, capacity restored
    ])
    out["spot"] = []
    for ev in AvailabilityMonitor(cluster, [feed]).drain():
        if not isinstance(ev, (PriceChange, NodeFailure)):
            continue
        r = replanner.replan(ev.cluster)
        by_zone = _chips_by_zone(r.best.plan)
        print(f"  {ev.describe()}\n    -> ${r.best.cost_per_iter:.3f}/iter, "
              f"chips {by_zone} ({r.search_time_s * 1e3:.0f}ms "
              f"{r.stats['cache']})")
        out["spot"].append(dict(event=ev.describe(),
                                cost_per_iter=r.best.cost_per_iter,
                                chips=by_zone, cache=r.stats["cache"],
                                search_time_s=r.search_time_s))
    print(f"replanner: {replanner.stats}")
    out["replanner"] = dict(replanner.stats)
    return out


if __name__ == "__main__":
    main()
