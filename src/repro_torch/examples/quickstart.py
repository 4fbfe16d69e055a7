"""Quickstart: plan a heterogeneous, geo-distributed training job — then
execute the plan's pipeline shape on the port's MPMD pipeline.

Reproduces the paper's headline workflow (Fig. 4) in one page:
  1. describe the fleet (quotas per zone/region, GPU types),
  2. pick an objective (+ optional constraints),
  3. Sailor co-optimizes the resource allocation AND the parallelization
     plan in seconds, with accurate memory/time/cost estimates,
  4. the execution layer runs the resulting pipeline structure — the
     plan's stage count with heterogeneous per-stage TP — on this
     machine's mesh positions.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        --reduced --device cpu

The counterpart of the reference's ``examples/quickstart.py``.  The
planning half makes the same calls on the same fleet (the same plans,
``t_iter`` and $/iteration).  The execute half follows the reference's
rule over ``POSITIONS`` (8) mesh positions (the visible cards in turn,
``[cuda:0] * 8`` on one card): ``pp = min(plan's pp, 2, 8)``, ``tps = [n // 2, n // 4][:pp]``, ``even_stages(cfg, tps,
dp=1)``.  On the card the model is ``opt-350m`` at its published widths
and depth (24 layers, d_model 1024, 16 heads of 64, d_ff 4096, gelu,
vocab 50272), untied as the reference's, bf16, at the plan's sequence
length of 2048, 2 microbatches of 4 rows; the pipeline is graphed where
a stage's positions share a card.  ``--reduced`` runs the reference's
execute half: 4 layers of the reduced config, tokens (2, 4, 33).  The
weights are seeded random numbers (``MPMDPipeline.init_params(0)``), so
the losses are not the reference script's.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.cluster import multi_zone
from repro_torch.core.planner.objectives import (MAX_THROUGHPUT, MIN_COST,
                                                 Objective)
from repro_torch.core.planner.search import plan_for
from repro_torch.dist.pipeline import MPMDPipeline, even_stages
from repro_torch.examples.common import parser, positions, synchronize
from repro_torch.models.config import ModelConfig
from repro_torch.train import optimizer as opt_lib

# the fleet: what `gcloud` would tell you is actually available
ZONES = {
    "us-central1-a": ("us-central1", {"A100-40": 16, "V100-16": 48}),
    "us-central1-b": ("us-central1", {"A100-40": 16}),
    "us-west1-a":    ("us-west1",    {"A100-40": 32}),
}
MODEL = "opt-350m"                      # the paper's evaluation model
SEQ, GBS = 2048, 2048                   # paper §5 training setup
LR = 1e-3
# (num_micro, micro_batch, seq_len) of the executed batch
FULL_BATCH = (2, 4, SEQ)
REDUCED_BATCH = (2, 4, 32)              # the reference's (2, 4, 33) tokens
STEPS = 3
POSITIONS = 8                           # the reference's 8 host devices


def plan() -> Dict[str, Any]:
    """The planning half: both objectives and the simulator's breakdown,
    printed as the reference prints them.  ``best`` is the throughput
    plan's ``SimResult``."""
    cluster = multi_zone(ZONES)
    model = get_config(MODEL)
    res = plan_for(model, cluster, Objective(MAX_THROUGHPUT), SEQ, GBS)
    best = res.best
    print(f"[throughput] searched in {res.search_time_s:.2f}s "
          f"({res.n_evaluated} candidates simulated, {res.n_oom} "
          f"OOM-pruned)")
    print(f"  -> {best.throughput:.3f} iter/s "
          f"({best.samples_per_s:.0f} seq/s) at ${best.cost_per_iter:.3f}"
          f"/iter")
    print(best.plan.describe())
    print()

    # minimum cost, but keep at least 0.1 iter/s
    res2 = plan_for(model, cluster,
                    Objective(MIN_COST, min_throughput=0.1), SEQ, GBS,
                    max_pp=8)     # keep the demo snappy (<1 min)
    best2 = res2.best
    print(f"[min-cost, thr>=0.1] searched in {res2.search_time_s:.2f}s")
    print(f"  -> ${best2.cost_per_iter:.3f}/iter at {best2.throughput:.3f} "
          f"iter/s using {best2.plan.n_chips} chips")
    print(best2.plan.describe())
    print()

    t = best.timing
    print(f"[simulator] t_iter={t.t_iter * 1e3:.0f}ms = pipeline "
          f"{t.t_pp * 1e3:.0f} + sync {t.t_sync * 1e3:.0f} + update "
          f"{t.t_update * 1e3:.0f} (straggler: stage {t.straggler_stage})")
    worst = max(r["peak"] for row in best.peak_mem for r in row)
    print(f"[simulator] worst worker peak memory: {worst / 1e9:.1f} GB")
    print()
    return dict(
        best=best,
        throughput=dict(
            throughput=best.throughput, samples_per_s=best.samples_per_s,
            cost_per_iter=best.cost_per_iter, plan=best.plan.describe(),
            pp=best.plan.pp, n_evaluated=res.n_evaluated, n_oom=res.n_oom,
            search_time_s=res.search_time_s),
        min_cost=dict(
            throughput=best2.throughput, cost_per_iter=best2.cost_per_iter,
            n_chips=best2.plan.n_chips, plan=best2.plan.describe(),
            search_time_s=res2.search_time_s),
        simulator=dict(t_iter=t.t_iter, t_pp=t.t_pp, t_sync=t.t_sync,
                       t_update=t.t_update,
                       straggler_stage=t.straggler_stage,
                       worst_peak_bytes=worst))


def stage_tps(plan_pp: int, n: int) -> List[int]:
    """The reference's execute rule: the plan's stage count, at most 2 and
    at most ``n``, stage 0 on the wider mesh."""
    pp = min(plan_pp, 2, n)
    return [max(n // 2, 1), max(n // 4, 1)][:pp]


def execute_config(reduced: bool) -> ModelConfig:
    """``opt-350m`` untied (tied embeddings span the first and last
    stage); ``reduced``: 4 layers of its reduced config, the
    reference's."""
    model = get_config(MODEL)
    if reduced:
        return dataclasses.replace(model.reduced(), n_layers=4,
                                   tie_embeddings=False)
    return dataclasses.replace(model, tie_embeddings=False)


def tokens(cfg: ModelConfig, shape: Sequence[int],
           seed: int = 0) -> Dict[str, np.ndarray]:
    """A (num_micro, micro_batch, seq) batch from ``default_rng(seed)``,
    as the reference draws it."""
    rng = np.random.default_rng(seed)
    n_micro, mbs, seq = shape
    toks = rng.integers(0, cfg.vocab_size,
                        (n_micro, mbs, seq + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def execute(cfg: ModelConfig, tps: Sequence[int], devices: Sequence,
            batch: Dict[str, np.ndarray], graphed: Optional[bool] = None,
            full: Any = None) -> Dict[str, Any]:
    """``STEPS`` pipeline steps on one batch: ``MPMDPipeline`` over
    ``even_stages(cfg, tps, dp=1)`` on ``devices``, its weights
    ``full`` (a full params tree) or ``init_params(0)``.  Returns the
    losses and each step's host wall (to the cards synchronized)."""
    pipe = MPMDPipeline(cfg, even_stages(cfg, tps=tps, dp=1),
                        opt_lib.OptimizerConfig(lr=LR), devices=devices,
                        graphed=graphed)
    if full is None:
        pipe.init_params(0)
    else:
        pipe.full_params_like(full)
    losses, walls = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(pipe.train_step(batch))
        synchronize(pipe.devices)
        walls.append(time.perf_counter() - t0)
    graphs = [g is not None for g in pipe.graphs]
    del pipe
    gc.collect()            # a graphed pipeline sits in reference cycles
    return dict(losses=losses, step_wall_s=walls, graphed_stages=graphs)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Plan, then execute the plan's pipeline shape; print the
    reference's report and return its figures."""
    ap = parser(__doc__)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's CPU sizes")
    args = ap.parse_args(argv)
    devices = positions(args.device, POSITIONS)

    out = plan()
    best = out.pop("best")
    n = len(devices)
    tps = stage_tps(best.plan.pp, n)
    cfg = execute_config(args.reduced)
    batch = tokens(cfg, REDUCED_BATCH if args.reduced else FULL_BATCH)
    run = execute(cfg, tps, devices, batch)
    losses = run["losses"]
    where = "host" if devices[0].type == "cpu" else devices[0].type
    print(f"[execute] {len(tps)}-stage MPMD pipeline, per-stage tp={tps} "
          f"on {n} {where} positions")
    print("[execute] losses: " + " -> ".join(f"{x:.3f}" for x in losses))
    print("[execute] step wall ms: " + ", ".join(
        f"{w * 1e3:.1f}" for w in run["step_wall_s"])
        + f" (graphed stages {run['graphed_stages']})")
    out["execute"] = dict(model=cfg.name, n_layers=cfg.n_layers,
                          positions=n, tps=tps, batch=list(
                              batch["tokens"].shape), **run)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"pipeline should learn: losses {losses}")
    return out


if __name__ == "__main__":
    main()
