"""The two servers' timed runs at smollm-360M's published widths, served as
``chip_smoke.py`` serves them, for comparing two trees on one card.

    PYTHONPATH=<tree>/src python3 src/repro_torch/bench/serve_runs.py [label]

It serves with whatever ``repro_torch`` ``PYTHONPATH`` finds first, through
the API every tree since continuous batching has (``BatchedServer``,
``ContinuousBatchingServer``, ``serve_step.decode_rows``), so an older
tree's ``src`` times that tree in the same call: run parent, change,
change, parent.  On seeded random weights (32 layers, bf16):

* the static server: a warm batch of 8, then 16 requests (prompts of
  256-509 tokens, 32 new tokens, batch 8): warm-up and run seconds, tok/s,
  and the run's host seconds inside ``decode_rows`` (each call followed by
  a sync: the loop syncs there anyway, on its next read of the tokens) and
  outside it (prefills, host work), and the allocator's ``cudaMalloc``,
  ``cudaFree`` and retry counts over the run;
* its decode step at 8 rows, 16 single steps with a sync each (median)
  and 8 back to back with one sync;
* the continuous server: a warm run of 8, then 32 requests (8 slots,
  max_ctx 576, 224 pages of 16: it preempts): warm-up and run seconds,
  tok/s, the same split and ``ServerStats``.

One JSON line, with the card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import model as model_lib
from repro_torch.serve import scheduler, serve_step
from repro_torch.serve.serve_step import BatchedServer, Request

PROMPTS, NEW, BATCH, REQUESTS = (256, 509), 32, 8, 16
CB = dict(max_slots=8, max_ctx=576, page_size=16, total_pages=224)
CB_REQUESTS, CB_NEW = 32, (8, 64)


def _requests(vocab: int, seed: int, n: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPTS[0], PROMPTS[1] + 1, size=n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(s),
                                               dtype=np.int32),
                    max_new_tokens=NEW) for i, s in enumerate(lens)]


def _continuous_requests(vocab: int, seed: int, n: int):
    reqs = _requests(vocab, seed, n)
    spread = np.linspace(CB_NEW[0], CB_NEW[1], n).round().astype(int)
    for r, m in zip(reqs, np.random.default_rng(seed).permutation(spread)):
        r.max_new_tokens = int(m)
    return reqs


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


class DecodeClock:
    """Host seconds inside ``serve_step.decode_rows`` (the name both
    servers call), each call ended by a sync; and the caching allocator's
    ``cudaMalloc`` calls, ``cudaFree`` calls and retries (a failed
    ``cudaMalloc`` that frees the cache and tries again) meanwhile."""

    COUNTERS = ("num_device_alloc", "num_device_free", "num_alloc_retries")

    def __init__(self):
        self.seconds = 0.0
        self.allocator: dict = {}
        self._real = serve_step.decode_rows

    def __enter__(self):
        self._before = torch.cuda.memory_stats()

        def timed(*args, **kw):
            t0 = time.perf_counter()
            out = self._real(*args, **kw)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out
        serve_step.decode_rows = scheduler.decode_rows = timed
        return self

    def __exit__(self, *exc):
        serve_step.decode_rows = scheduler.decode_rows = self._real
        after = torch.cuda.memory_stats()
        self.allocator = {k: after.get(k, 0) - self._before.get(k, 0)
                          for k in self.COUNTERS}


def _run(server, warm, reqs) -> dict:
    warm_s = _timed(lambda: server.run(warm))
    if hasattr(server, "stats"):
        server.stats = scheduler.ServerStats()
    with DecodeClock() as clock:
        run_s = _timed(lambda: server.run(reqs))
    if not all(r.done and len(r.output) == r.max_new_tokens for r in reqs):
        raise AssertionError("a request did not finish with its own length")
    tokens = sum(len(r.output) for r in reqs)
    return dict(warmup_s=warm_s, run_s=run_s, tok_s=tokens / run_s,
                tokens=tokens, decode_rows_s=clock.seconds,
                other_s=run_s - clock.seconds, allocator=clock.allocator)


def main(label: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("serve_runs: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = get_config("smollm_360m")
    params = model_lib.init(cfg, 0, device="cuda")
    v = cfg.vocab_size
    static = BatchedServer(cfg, params, max_len=PROMPTS[1] + NEW + 8,
                           batch_size=BATCH)
    out = dict(label=label, card=card, tree=serve_step.__file__,
               static=_run(static, _requests(v, 1, BATCH),
                           _requests(v, 0, REQUESTS)))
    with torch.inference_mode():
        static.state["len"].fill_(1)
        step = lambda: serve_step.decode_rows(  # noqa: E731
            cfg, params, static.state, BATCH, static.decode_graph)
        singles = [_timed(step) * 1e3 for _ in range(16)]
        back = _timed(lambda: [step() for _ in range(8)]) * 1e3 / 8
    out["decode_8_rows"] = dict(single_ms=statistics.median(singles),
                                single_ms_all=singles, back_to_back_ms=back)
    cont = scheduler.ContinuousBatchingServer(cfg, params, **CB)
    warm = _continuous_requests(v, 1, CB["max_slots"])
    for i, r in enumerate(warm):
        r.max_new_tokens = 4 + 2 * i
    out["continuous"] = dict(
        _run(cont, warm, _continuous_requests(v, 0, CB_REQUESTS)),
        stats=dataclasses.asdict(cont.stats))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
