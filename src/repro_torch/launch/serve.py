"""Serving entry point: batched greedy decoding against a seeded model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1_5_0_5b \
      --reduced --device cpu --requests 16 --prompt-len 32 --max-new 16

Counterpart of ``repro/launch/serve.py`` with the same flags plus
``--device`` (default ``cuda``).  A warmup batch runs first and is timed
apart, so the reported tok/s is the steady state.  ``--continuous`` serves
through the paged continuous-batching scheduler (``max_slots`` =
``--batch-size``, ``max_ctx`` = prompt + new tokens + 8) instead of the
static lockstep batch; a request whose prompt bucket and decode steps
would write past ``max_ctx`` raises (``ContinuousBatchingServer.submit``).
The weights are seeded random numbers at the config's widths.  A vlm
config's cache also holds its ``n_patches`` patch positions, so its
``max_len`` is ``n_patches`` + prompt + new tokens + 8 (the reference's
omits the patches and fails in its ``grow_cache``: ROADMAP §3, fault R9);
encdec and vlm prompts come with the zero frames or patches that the
reference's server gives them.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.serve.scheduler import ContinuousBatchingServer
from repro_torch.serve.serve_step import BatchedServer, Request


def make_requests(cfg, n: int, prompt_len: int, max_new: int,
                  seed: int = 0) -> List[Request]:
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=prompt_len,
                                        dtype=np.int32),
                    max_new_tokens=max_new)
            for i in range(n)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--continuous", action="store_true",
                    help="serve via the paged continuous-batching scheduler")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = model_lib.init(cfg, 0, device=args.device)
    device = torch.device(args.device)
    max_len = args.prompt_len + args.max_new + 8
    if cfg.family == "vlm":
        max_len += cfg.n_patches
    if args.continuous:
        server = ContinuousBatchingServer(cfg, params,
                                          max_slots=args.batch_size,
                                          max_ctx=max_len)
    else:
        server = BatchedServer(cfg, params, max_len=max_len,
                               batch_size=args.batch_size)

    # warmup: one full batch through prefill + decode (first launches,
    # kernel builds); timed separately
    warm = make_requests(cfg, args.batch_size, args.prompt_len,
                         args.max_new, seed=1)
    t0 = time.perf_counter()
    server.run(warm)
    _sync(device)
    t_warm = time.perf_counter() - t0

    reqs = make_requests(cfg, args.requests, args.prompt_len, args.max_new)
    t0 = time.perf_counter()
    server.run(reqs)
    _sync(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.output) for r in reqs)
    tag = f"[serve:{'continuous' if args.continuous else 'static'}:" \
        f"{device.type}]"
    print(f"{tag} warmup {t_warm:.2f}s")
    print(f"{tag} {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"steady-state ({n_tok / dt:.1f} tok/s)")
    if not all(r.done for r in reqs):
        raise RuntimeError("serve: a request did not finish")
    print("sample output:", reqs[0].output[:8])


if __name__ == "__main__":
    main()
