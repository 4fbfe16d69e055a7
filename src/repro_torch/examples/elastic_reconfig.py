"""Elasticity demo (paper §4.4): the autonomous control plane.

Replays a Figure-2-style availability trace against a live training job:
``repro_torch.manager`` watches the trace, re-invokes the planner on every
change point (warm-started, so replans are much cheaper than the first
search), prices each transition, and drives the trainer:

  * capacity drop, state intact   -> kill-free reshard
  * bulk preemption (state lost)  -> rollback to the latest async checkpoint
  * short capacity blip           -> deferred (hysteresis absorbs it)
  * straggler step                -> replan, recorded in the decision log

    PYTHONPATH=src python -m repro_torch.examples.elastic_reconfig
    PYTHONPATH=src python -m repro_torch.examples.elastic_reconfig \\
        --reduced --device cpu

The counterpart of the reference's ``examples/elastic_reconfig.py``: the
same seeded trace over an 8-device zone, hysteresis, step clock, data
(seq 32, global batch 8), optimizer, checkpoint interval and 60 steps.
The trainer's mesh positions are 8 (the visible cards in turn,
``[cuda:0] * 8`` on one card); each reconfiguration makes a new step,
graphed where the positions share a card, whose capture is printed beside
the reconfiguration.  On the card the model is ``smollm_360m`` at its
published widths; ``--reduced`` trains its reduced form, the reference's.
Checkpoints go to ``--workdir``; the ones an earlier run left there are
removed first (a stale one would be rolled back to).  The weights are
seeded random numbers, so the losses are not the reference script's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.cluster import AvailabilityTrace, single_zone
from repro_torch.core.planner.objectives import MAX_THROUGHPUT, Objective
from repro_torch.core.profiler.analytic import TrainJob
from repro_torch.examples.common import fresh_checkpoints, parser, positions
from repro_torch.manager import (AvailabilityMonitor, Controller,
                                 ControllerConfig, IncrementalReplanner,
                                 TraceFeed, TransitionConfig, TransitionModel)
from repro_torch.models.config import ModelConfig
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.elastic import ElasticTrainer

ARCH = "smollm_360m"
ZONE_DEVICES = 8
STEPS = 60
DATA = dict(seq_len=32, global_batch=8)
CHECKPOINT_EVERY = 8


def trace() -> AvailabilityTrace:
    """The reference's seeded trace over an 8-device zone (its pool is
    the reference's ``cpu-host``: the trace's steps and the plans depend
    on the accelerator's catalog entry)."""
    return AvailabilityTrace(single_zone("cpu-host", ZONE_DEVICES), seed=4,
                             step_s=60, horizon_s=3600, preempt_prob=0.25)


def controller(cfg: ModelConfig, devices: Sequence, workdir: str,
               audit_path: Optional[str] = None) -> Controller:
    """The reference's control loop over a fresh ``ElasticTrainer`` of
    ``cfg`` on ``devices`` (``ctl.trainer``), its checkpoints in
    ``workdir``; ``audit_path`` is ``ControllerConfig``'s."""
    data_cfg = data_lib.DataConfig(**DATA)
    opt_cfg = opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=5,
                                      total_steps=80)
    availability = trace()
    job = TrainJob(cfg=cfg, seq_len=data_cfg.seq_len,
                   global_batch=data_cfg.global_batch)
    fresh_checkpoints(workdir)      # stale checkpoints confuse the
    trainer = ElasticTrainer(cfg, opt_cfg, data_cfg,  # rollback story
                             workdir=workdir,
                             checkpoint_every=CHECKPOINT_EVERY,
                             devices=devices)
    return Controller(
        trainer,
        AvailabilityMonitor(availability.cluster, [TraceFeed(availability)]),
        IncrementalReplanner(job, Objective(MAX_THROUGHPUT)),
        transition=TransitionModel(TransitionConfig(hysteresis_s=120.0)),
        config=ControllerConfig(step_time_s=60.0, max_devices=ZONE_DEVICES,
                                audit_path=audit_path))


def report(ctl: Controller, log: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Print the reference's report of a run (``log`` its rows), each
    reconfiguration beside its new step's capture, and return its
    figures."""
    trainer = ctl.trainer
    print(f"trained {len(log)} steps; loss {log[0]['loss']:.3f} -> "
          f"{log[-1]['loss']:.3f}\n")
    print(ctl.summary())
    print("\nreconfigurations applied:")
    for r in trainer.reconfigs:
        beside = "" if r["capture_s"] is None else \
            f" (new step captured in {r['capture_s']:.2f} s)"
        print(f"  step {r['step']:3d}: {r['kind']:9s} -> "
              f"{r['n_devices']} devices in {r['reconfig_s'] * 1e3:.0f} ms"
              + beside)
    if trainer.detector.events:
        print("straggler flags at steps:", trainer.detector.events)
    cfg = trainer.cfg
    return dict(
        model=cfg.name, n_layers=cfg.n_layers,
        positions=len(trainer.devices),
        losses=[r["loss"] for r in log],
        n_devices=[r["n_devices"] for r in log],
        step_wall_s=[r["time_s"] for r in log],
        decisions=[{k: v for k, v in d.items() if k != "search_ms"}
                   for d in ctl.decisions],
        outcomes=ctl.outcomes(), reconfigs=list(trainer.reconfigs),
        captures=list(trainer.captures),
        stragglers=list(trainer.detector.events),
        replanner=dict(ctl.replanner.stats))


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Run the control loop over the trace; print the reference's report
    and return its figures."""
    ap = parser(__doc__)
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's CPU sizes")
    ap.add_argument("--workdir",
                    default="artifacts/torch_examples/elastic_demo")
    args = ap.parse_args(argv)
    devices = positions(args.device, ZONE_DEVICES)
    cfg = get_config(ARCH)
    if args.reduced:
        cfg = cfg.reduced()
    ctl = controller(cfg, devices, args.workdir)
    return report(ctl, ctl.run(STEPS))


if __name__ == "__main__":
    main()
