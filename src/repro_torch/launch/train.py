"""End-to-end training entry point (counterpart of ``repro/launch/train.py``).

Plans (Sailor planner against a cluster spec, or an explicit dp/tp), builds
the mesh over local devices, and trains with the elastic runtime —
checkpointing, straggler telemetry and kill-free reconfiguration included.

Examples:
  # smollm-360M at its published widths on every local card
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
      --steps 20 --seq-len 1024 --global-batch 8 --num-micro 2

  # plan first against a simulated cluster, then execute on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m \\
      --reduced --device cpu --plan --cluster H100:8 --steps 5

The reference's flags plus ``--device`` (default ``cuda``): the mesh's
positions are the devices of that kind, every CUDA device or one ``cpu``,
so ``--dp 0`` means all of them, as in the reference.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.core.cluster import heterogeneous_zone
from repro_torch.core.planner.objectives import MAX_THROUGHPUT, Objective
from repro_torch.core.planner.search import plan_for
from repro_torch.device import resolve_device
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.elastic import ElasticTrainer, RuntimePlan


def parse_cluster(spec: str):
    """'a100:8,v100:16' -> heterogeneous single-zone ClusterSpec."""
    names = {"a100": "A100-40", "v100": "V100-16", "v5e": "tpu-v5e",
             "gh200": "GH200", "cpu": "cpu-host"}
    cap = {}
    for part in spec.split(","):
        t, n = part.split(":")
        cap[names.get(t.lower(), t)] = int(n)
    return heterogeneous_zone(cap)


def local_devices(kind: str) -> List[torch.device]:
    """The mesh's positions: every CUDA device, or one CPU."""
    dev = resolve_device(kind)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def main(argv: Optional[List[str]] = None):
    """Parse ``argv`` (default ``sys.argv[1:]``), plan, train; returns
    ``(plan result or None, trainer)`` for callers that check them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--num-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--dp", type=int, default=0, help="0 = all devices")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--plan", action="store_true",
                    help="run the Sailor planner first and print its plan")
    ap.add_argument("--cluster", default="a100:8")
    ap.add_argument("--workdir", default="artifacts/train")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    res = None
    if args.plan:
        cluster = parse_cluster(args.cluster)
        res = plan_for(cfg, cluster, Objective(MAX_THROUGHPUT),
                       seq_len=args.seq_len, global_batch=args.global_batch)
        if res.best is None:
            raise SystemExit("planner found no valid plan")
        print(f"[planner] search={res.search_time_s:.2f}s "
              f"t_iter={res.best.t_iter:.3f}s "
              f"cost=${res.best.cost_per_iter:.4f}/iter")
        print(res.best.plan.describe())

    devices = local_devices(args.device)
    dp = args.dp or max(1, len(devices) // args.tp)
    data_cfg = data_lib.DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        num_microbatches=args.num_micro)
    opt_cfg = opt_lib.OptimizerConfig(lr=args.lr, warmup_steps=10,
                                      total_steps=args.steps)
    trainer = ElasticTrainer(
        cfg, opt_cfg, data_cfg, workdir=args.workdir,
        checkpoint_every=args.checkpoint_every,
        plan_fn=lambda n: RuntimePlan(
            n_devices=dp * args.tp, dp=dp, tp=args.tp,
            num_microbatches=args.num_micro),
        devices=devices)
    trainer.build(dp * args.tp)
    t0 = time.time()
    log = trainer.train(args.steps)
    dt = time.time() - t0
    toks = args.steps * args.global_batch * args.seq_len
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({toks / dt:.0f} tok/s) loss {log[0]['loss']:.3f} -> "
          f"{log[-1]['loss']:.3f}")
    if trainer.detector.events:
        print(f"[train] straggler events at steps {trainer.detector.events}")
    return res, trainer


if __name__ == "__main__":
    main()
