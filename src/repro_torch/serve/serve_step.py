"""Serving steps and a batched request server (counterpart of
``repro/serve/serve_step.py``).

``make_prefill`` runs the full-sequence forward returning (last-token
logits, cache); ``make_decode`` advances one token for the whole batch.
PyTorch runs eagerly, so there is nothing to compile: the reference's
``jax.jit`` around each step has no counterpart here.  Cache sharding
(``cache_specs``) waits for the mesh slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch

from repro_torch.device import device_of
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serve import kv_cache


def make_prefill(cfg: ModelConfig) -> Callable:
    def prefill(params, batch):
        logits, cache = model_lib.forward(cfg, params, batch,
                                          return_cache=True)
        return logits[:, -1], cache
    return prefill


def make_decode(cfg: ModelConfig) -> Callable:
    def decode(params, cache, tokens):
        logits, cache = model_lib.decode(cfg, params, cache, tokens)
        return logits[:, -1], cache
    return decode


# --- a small batched-requests server (greedy sampling) ---------------------------


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchedServer:
    """Static-batch server: pads a batch of requests, prefills once, then
    decodes in lockstep until every request finishes.

    Finished rows are compacted out: once live requests fall to half the
    current batch, the cache/batch are gathered down to the live rows, so
    a batch with mixed ``max_new_tokens`` stops paying full-batch decode
    steps for dead rows, capping wasted row-steps at 2x the useful work.
    ``decode_steps`` / ``decode_row_steps`` count the actual work.  The
    server runs on the device its ``params`` lie on.
    """

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 batch_size: int = 8):
        self.cfg = cfg
        self.params = params
        self.device = device_of(params)
        self.max_len = max_len
        self.batch_size = batch_size
        self._prefill = make_prefill(cfg)
        self._decode = make_decode(cfg)
        self.decode_steps = 0        # decode_step launches
        self.decode_row_steps = 0    # sum of batch rows over launches

    def run(self, requests: List[Request]) -> List[Request]:
        with torch.inference_mode():
            for i in range(0, len(requests), self.batch_size):
                self._run_batch(requests[i:i + self.batch_size])
        return requests

    def _run_batch(self, reqs: List[Request]):
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt     # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = self._prefill(self.params, batch)
        # re-home the cache into a max_len buffer
        full = model_lib.init_cache(self.cfg, b, self.max_len,
                                    device=self.device)
        cache = kv_cache.grow_cache(cache, full)
        cur = torch.argmax(logits, dim=-1)[:, None]
        rows = list(range(b))        # batch row -> index into reqs
        while True:
            cur_host = cur[:, 0].tolist()     # one device->host copy a step
            for j, ri in enumerate(rows):
                r = reqs[ri]
                if not r.done:
                    r.output.append(int(cur_host[j]))
                    if len(r.output) >= r.max_new_tokens:
                        r.done = True
            live = [j for j, ri in enumerate(rows) if not reqs[ri].done]
            if not live:
                break
            if len(live) <= len(rows) // 2:
                # gather the cache down to the live rows (rows decode
                # independently, so trajectories are unchanged)
                nrows = len(rows)
                idx = torch.tensor(live, device=self.device)

                def take(v):
                    if not isinstance(v, torch.Tensor) or v.dim() == 0:
                        return v
                    if v.dim() >= 2 and v.shape[1] == nrows:
                        return v[:, idx]
                    if v.shape[0] == nrows:
                        return v[idx]
                    return v
                cache = {k: take(v) for k, v in cache.items()}
                cur = cur[idx]
                rows = [rows[j] for j in live]
            logits, cache = self._decode(self.params, cache, cur)
            cur = torch.argmax(logits, dim=-1)[:, None]
            self.decode_steps += 1
            self.decode_row_steps += len(rows)
