"""Serving example: plan a placement under an SLO, then serve locally.

Two halves, mirroring the paper's workflow for the inference fleet:

1. **Plan.**  A ``ServeJob`` + 2-zone heterogeneous cluster go through
   ``SailorPlanner`` with a ``ServingObjective`` (min $/token s.t. TTFT /
   TPOT p99 SLOs).  The planner sizes the replica fleet, picks types and
   zones, and memory-gates each replica on KV-aware peak bytes.
2. **Serve.**  The chosen decode batch size then drives a local
   ``ContinuousBatchingServer`` — paged KV cache, per-step admission, the
   same scheduler the simulator models.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --reduced --device cpu

The counterpart of the reference's ``examples/serve_batched.py``: the same
job, fleet and objective (the same plan, p99s, tok/s and $/token), and the
same 8 requests (``default_rng(0)``: prompts of 8-15 tokens, 4-18 new
tokens) at ``max_slots`` = the plan's decode batch and ``max_ctx`` 64.  On
the card the model is ``qwen1_5_0_5b`` at its published widths, bf16, its
prefills and decode steps replayed as CUDA graphs; ``--reduced`` serves
its reduced form, the reference's.  The weights are seeded random numbers (``model.init(cfg,
0)``), so the tokens are not the reference script's.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import cluster as cl
from repro_torch.core.planner.objectives import ServingObjective
from repro_torch.core.planner.search import SailorPlanner
from repro_torch.core.profiler.analytic import ServeJob
from repro_torch.examples.common import parser, positions, synchronize
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serve.scheduler import ContinuousBatchingServer
from repro_torch.serve.serve_step import Request

ARCH = "qwen1_5_0_5b"
MAX_CTX = 64


def plan_placement() -> Dict[str, Any]:
    """The planning half, printed as the reference prints it; ``best`` is
    the plan's ``ServeResult``."""
    job = ServeJob(cfg=get_config("smollm_360m"), prompt_len=256,
                   max_new_tokens=128, decode_batch=8, arrival_rps=4.0)
    cluster = cl.multi_zone({
        "us-central1-a": ("us-central1", {"A100-40": 8}),
        "eu-west4-a": ("eu-west4", {"RTX-3090": 16}),
    })
    objective = ServingObjective(slo_ttft_p99_s=2.0, slo_tpot_p99_s=0.2)
    planner = SailorPlanner(job)
    t0 = time.perf_counter()
    res = planner.plan(cluster, objective)
    dt = time.perf_counter() - t0
    best = res.best
    print(f"planned in {dt:.1f}s ({res.n_evaluated} candidates simulated)")
    print(best.plan.describe())
    print(f"  ttft_p99={best.ttft_p99:.3f}s tpot_p99="
          f"{best.tpot_p99 * 1e3:.1f}ms tok/s={best.tokens_per_s:.0f} "
          f"$/token={best.cost_per_token:.3g}")
    return dict(best=best, plan=best.plan.describe(),
                decode_batch=best.plan.decode_batch,
                ttft_p99=best.ttft_p99, tpot_p99=best.tpot_p99,
                tokens_per_s=best.tokens_per_s,
                cost_per_token=best.cost_per_token,
                n_evaluated=res.n_evaluated, seconds=dt)


def requests(cfg: ModelConfig) -> List[Request]:
    """The reference's 8 requests."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, 8 + i,
                                        dtype=np.int32),
                    max_new_tokens=4 + 2 * i)
            for i in range(8)]


def serve_locally(cfg: ModelConfig, params, decode_batch: int,
                  graphed: Optional[bool] = None) -> Dict[str, Any]:
    """Serve the reference's requests on ``params``; print what the
    reference prints and return the tokens and ``ServerStats``."""
    reqs = requests(cfg)
    server = ContinuousBatchingServer(cfg, params, max_slots=decode_batch,
                                      max_ctx=MAX_CTX, graphed=graphed)
    t0 = time.perf_counter()
    server.run(reqs)
    synchronize([server.device])
    dt = time.perf_counter() - t0
    total = sum(len(r.output) for r in reqs)
    s = server.stats
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.1f}s "
          f"(steps={s.decode_steps} row_steps={s.decode_row_steps} "
          f"peak_pages={s.peak_pages})")
    for r in reqs[:3]:
        print(f"  req{r.rid}: prompt_len={len(r.prompt)} -> {r.output}")
    return dict(outputs=[list(map(int, r.output)) for r in reqs],
                stats=dataclasses.asdict(s), seconds=dt,
                tokens=total, tokens_per_s=total / dt,
                graphed=server.graphed)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Plan, then serve at the planned decode batch; print the reference's
    report and return its figures."""
    ap = parser(__doc__)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's CPU sizes")
    args = ap.parse_args(argv)
    device = positions(args.device, 1)[0]
    out = plan_placement()
    best = out.pop("best")
    cfg = get_config(ARCH)
    if args.reduced:
        cfg = cfg.reduced()
    params = model_lib.init(cfg, 0, device=device)
    out["serve"] = serve_locally(cfg, params, best.plan.decode_batch)
    out["serve"].update(model=cfg.name, n_layers=cfg.n_layers)
    return out


if __name__ == "__main__":
    main()
