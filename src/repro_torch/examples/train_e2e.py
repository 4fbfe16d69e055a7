"""End-to-end training: ~100M-parameter model for a few hundred steps.

A gpt-neo-style dense config scaled to ~100M params, fp32, trained through
the full production stack (data pipeline, AdamW, remat, async
checkpoints), then a resume-from-checkpoint reproducibility check.

    PYTHONPATH=src python -m repro_torch.examples.train_e2e  [--steps 200]
    PYTHONPATH=src python -m repro_torch.examples.train_e2e \\
        --reduced --device cpu --steps 6 --checkpoint-every 2

The counterpart of the reference's ``examples/train_e2e.py``:
``ElasticTrainer`` on one device (``RuntimePlan(1, 1, 1, 2)``: two
microbatches), its step graphed on the card, a checkpoint every 50 steps
into ``--workdir`` (the checkpoints an earlier run left there are removed
first), ``ckpt.wait()``, then a fresh trainer restores the latest
checkpoint and trains 3 more steps.  The resumed losses must equal, bit
for bit, the first trainer's losses over the same steps (it trains on
from its live state where it has not run them yet): the data is
deterministic by step and both run the same step.  The weights are
seeded random numbers (``build(1)``: ``model.init(cfg, 0)``), so the
losses are not the reference script's.  ``--reduced`` trains the config's reduced
form.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.examples.common import (fresh_checkpoints, parser,
                                         positions, synchronize)
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.elastic import ElasticTrainer, RuntimePlan

# ~100M params: 10L x d640 x ff2560 + untied 32k vocab embeddings = 106M
CFG = ModelConfig(
    name="demo-100m", family="dense",
    n_layers=10, d_model=640, n_heads=10, n_kv_heads=10,
    d_ff=2560, vocab_size=32000, head_dim=64,
    dtype="float32", param_dtype="float32",
    sharding="replicated", remat="full",
)
SEQ_LEN, GLOBAL_BATCH, NUM_MICRO = 256, 8, 2
RESUME_STEPS = 3


def _plan(n_devices: int) -> RuntimePlan:
    return RuntimePlan(1, 1, 1, NUM_MICRO)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train, checkpoint, resume; print the reference's report and return
    its figures."""
    ap = parser(__doc__)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced form")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=SEQ_LEN)
    ap.add_argument("--global-batch", type=int, default=GLOBAL_BATCH)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--workdir",
                    default="artifacts/torch_examples/train_e2e")
    args = ap.parse_args(argv)
    device = positions(args.device, 1)[0]
    cfg = CFG.reduced() if args.reduced else CFG

    n = model_lib.param_count(cfg)
    print(f"model: {n / 1e6:.1f}M params")

    data_cfg = data_lib.DataConfig(seq_len=args.seq_len,
                                   global_batch=args.global_batch,
                                   num_microbatches=NUM_MICRO)
    opt_cfg = opt_lib.OptimizerConfig(lr=6e-4, warmup_steps=20,
                                      total_steps=args.steps)
    fresh_checkpoints(args.workdir)

    def trainer(every: int = 20) -> ElasticTrainer:
        return ElasticTrainer(cfg, opt_cfg, data_cfg, workdir=args.workdir,
                              checkpoint_every=every, plan_fn=_plan,
                              devices=[device])

    tr = trainer(args.checkpoint_every)
    tr.build(1)
    t0 = time.perf_counter()
    log = tr.train(args.steps)
    tr.ckpt.wait()               # join the last async save before resuming
    synchronize([device])
    dt = time.perf_counter() - t0
    toks = args.steps * args.global_batch * args.seq_len
    print(f"{args.steps} steps in {dt / 60:.1f} min ({toks / dt:.0f} tok/s)")
    print(f"loss: {log[0]['loss']:.3f} -> {log[-1]['loss']:.3f}")
    if not log[-1]["loss"] < log[0]["loss"]:
        raise RuntimeError("no learning? losses "
                           f"{log[0]['loss']} -> {log[-1]['loss']}")
    out: Dict[str, Any] = dict(
        params=n, n_layers=cfg.n_layers, num_microbatches=NUM_MICRO,
        steps=args.steps, seconds=dt, tokens_per_s=toks / dt,
        losses=[r["loss"] for r in log],
        step_wall_s=[r["time_s"] for r in log], captures=list(tr.captures))

    # resume check: a fresh trainer continues from the latest checkpoint
    latest = tr.ckpt.latest_step()
    tr2 = trainer()
    tr2.restore_from_checkpoint(1)
    print(f"resumed at step {tr2.step}; running {RESUME_STEPS} more steps")
    resumed = [r["loss"] for r in tr2.train(RESUME_STEPS)]
    start = tr2.step - RESUME_STEPS
    if tr.step < tr2.step:       # the uninterrupted trainer trains on
        tr.train(tr2.step - tr.step)
    went_on = [r["loss"] for r in tr.log
               if start <= r["step"] < start + RESUME_STEPS]
    same = resumed == went_on
    print(f"resume check: step {start} (latest checkpoint "
          f"{latest}); resumed losses equal the uninterrupted run's bit "
          f"for bit: {same}")
    if start != (latest or 0) or not same:
        raise RuntimeError(f"resume failed: resumed at step {start} from "
                           f"checkpoint {latest}, losses {resumed} against "
                           f"{went_on}")
    print("resume OK")
    out.update(resumed_at=start, latest_checkpoint=latest,
               resumed_losses=resumed, uninterrupted_losses=went_on,
               bit_identical=same)
    return out


if __name__ == "__main__":
    main()
