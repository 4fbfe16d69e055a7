"""Host seconds of one dry-run cell by phase of the step, on the CPU.

    PYTHONPATH=<tree>/src python3 src/repro_torch/bench/dryrun_phases.py \
        --arch smollm_360m --shape train_4k --mesh single \
        [--override n_layers=1 --override num_microbatches=1] [--audit]

The arguments are ``repro_torch.launch.dryrun``'s, and the cell runs
through its ``main`` (its artifact goes to ``--out``, default
``artifacts/dryrun``).  Wall clocks wrap the step's pieces, each piece's
nested pieces taken off it: building the stand-ins, the embedding, the
layers' forward, the head, the loss, the backward (autograd outside the
remat recompute), the recompute, the replica sums of the gradients,
AdamW over every leaf (``optimizer._adamw``), the rest of
``apply_sharded_updates`` and its global norm.  It times whatever
``repro_torch`` ``PYTHONPATH`` finds first, through names every tree
with ``launch/dryrun.py`` has, so a parent tree's ``src`` times that
tree.  Prints one JSON line: the total, the seconds by phase and the
calls of each.
"""
from __future__ import annotations

import functools
import json
import sys
import time
from collections import defaultdict

import torch
import torch.utils.checkpoint as ckpt

SECONDS: dict = defaultdict(float)
CALLS: dict = defaultdict(int)
_STACK: list = []


def timed(name: str, fn):
    """``fn`` with its wall seconds, less those of the timed calls inside
    it, added to ``SECONDS[name]``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        _STACK.append(0.0)
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            SECONDS[name] += dt - _STACK.pop()
            CALLS[name] += 1
            if _STACK:
                _STACK[-1] += dt
    return wrapper


def main(argv) -> int:
    from repro_torch.dist import placement as pm
    from repro_torch.dist import spmd
    from repro_torch.launch import dryrun, shapes
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as ts
    shapes.build_cell = timed("build_cell", shapes.build_cell)
    spmd._embed = timed("embed", spmd._embed)
    spmd.run_layers = timed("layers_forward", spmd.run_layers)
    spmd.head_logits = timed("head", spmd.head_logits)
    for name in ("ce_loss", "chunked_ce_loss"):
        if hasattr(spmd, name):
            setattr(spmd, name, timed("loss", getattr(spmd, name)))
    torch.autograd.grad = timed("backward", torch.autograd.grad)
    frame_init = ckpt._CheckpointFrame.__init__

    def frame(self, recompute_fn, *args, **kwargs):
        frame_init(self, timed("recompute", recompute_fn), *args, **kwargs)
    ckpt._CheckpointFrame.__init__ = frame
    pm.replica_group_sum = timed("replica_sums", pm.replica_group_sum)
    opt.sharded_global_norm = timed("adamw_norm", opt.sharded_global_norm)
    opt._adamw = timed("adamw_leaves", opt._adamw)
    opt.apply_sharded_updates = timed("adamw_rest", opt.apply_sharded_updates)
    ts.apply_sharded_updates = opt.apply_sharded_updates
    t0 = time.perf_counter()
    rc = dryrun.main(argv)
    print(json.dumps({"total_s": time.perf_counter() - t0, "by_phase_s": dict(
        sorted(SECONDS.items(), key=lambda kv: -kv[1])),
        "calls": dict(CALLS)}))
    return rc


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
