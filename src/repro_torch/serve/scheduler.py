"""Continuous-batching scheduler over a paged KV cache (counterpart of
``repro/serve/scheduler.py``).

The static ``BatchedServer`` admits one batch, decodes it to completion,
and only then starts the next — short requests finish early and their
slots idle while stragglers drain.  This server admits and retires
requests at every decode-step boundary:

* **Slots.**  A fixed pool of ``max_slots`` cache rows.  Live requests
  always occupy the row prefix ``[0, n_live)`` (finish/preempt swaps the
  last live row down), so a decode step runs on a *prefix slice* of the
  cache at the next power-of-2 above ``n_live``: at most log2(max_slots)
  + 1 batch sizes, with dead rows bounded by half the sliced batch.
* **Pages.**  Admission and per-token growth go through
  ``PagedKVAllocator``: a request is admitted only when a slot AND its
  prompt's pages are free; growth that finds the pool exhausted preempts
  the most recently admitted request back to the queue (recompute-style,
  vLLM semantics).
* **Per-row positions.**  The cache's ``len`` is a (B,) device vector —
  rows admitted at different times decode together, each masking its own
  context (``models/transformer.decode``'s per-row path).
* **One dispatch a step.**  Where the reference jits one fused program per
  pow2 batch (prefix slice, decode, write back, greedy pick), the port
  replays one CUDA graph per pow2 batch (``serve_step.GraphedDecodeStep``)
  over a static decode state that also mirrors ``len`` and the current
  tokens.  The host writes its arrays into that mirror only after an
  admission, finish or preemption; between such events the graph advances
  it (idle rows in the slice drift, but their logits are discarded).
* **One graph per prefill bucket.**  Prefill is batch 1 at the prompt's
  pow2 bucket, the reference's jitted prefill at one shape per bucket; the
  port replays one CUDA graph per bucket (``serve_step.GraphedPrefill``,
  by row), which writes the prompt's K/V, length and first token into the
  admitted row of the static state at a device row index.

Unlike the reference, ``submit`` refuses a request whose bucket plus
decode steps would write past ``max_ctx`` (the reference clamps that write
into the cache and drops the row's K/V).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import device_of
from repro_torch.models.config import ModelConfig
from repro_torch.serve.paged_cache import PagedKVAllocator
from repro_torch.serve.serve_step import (GraphedDecodeStep, GraphedPrefill,
                                          Request, decode_rows, decode_state,
                                          prefill_on_device, resolve_graphed)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class ServerStats:
    decode_steps: int = 0        # decode_step launches
    decode_row_steps: int = 0    # sum of sliced batch sizes over launches
    prefill_calls: int = 0
    n_preempted: int = 0
    n_finished: int = 0
    peak_pages: int = 0


class ContinuousBatchingServer:
    """Admit/evict by page budget; decode a dead-slot-free prefix batch.

    ``graphed`` as in ``BatchedServer``: None replays the prefill and
    decode graphs when the params lie on a CUDA device and runs their
    bodies eagerly on the CPU; True on the CPU raises; False runs them
    eagerly."""

    def __init__(self, cfg: ModelConfig, params, max_slots: int = 8,
                 max_ctx: int = 512, page_size: int = 16,
                 total_pages: Optional[int] = None,
                 graphed: Optional[bool] = None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError("continuous batching needs the per-row "
                             "transformer decode path")
        self.cfg = cfg
        self.params = params
        self.device = device_of(params)
        self.max_slots = max_slots
        self.max_ctx = max_ctx
        self.page_size = page_size
        if total_pages is None:
            total_pages = max_slots * (-(-max_ctx // page_size))
        self.alloc = PagedKVAllocator(total_pages, page_size)
        self.graphed = resolve_graphed(params, graphed,
                                       "ContinuousBatchingServer")
        # the static cache, per-row lengths and current tokens the prefills
        # write and the decode steps read and write in place
        self.state = decode_state(cfg, max_slots, max_ctx, per_row=True,
                                  device=self.device)
        self.prefill_graph = GraphedPrefill(cfg, params, self.state,
                                            by_row=True) \
            if self.graphed else None
        self.decode_graph = GraphedDecodeStep(cfg, params, self.state) \
            if self.graphed else None
        # per-row positions; idle rows sit at 1 (a 0 would mask every
        # position and NaN the softmax — their logits are discarded)
        self.len_np = np.ones((max_slots,), np.int64)
        self.cur = np.zeros((max_slots, 1), np.int64)
        # the state's len and cur mirror (len_np, cur) between event-free
        # decode steps, so steady-state decoding uploads nothing; any host
        # mutation (admit/finish/preempt) marks it stale
        self._stale = True
        self.queue: List[Request] = []
        self.live: List[Request] = []       # row i <-> live[i]
        self.stats = ServerStats()

    # --- queue/slot management ------------------------------------------------
    def submit(self, req: Request) -> None:
        plen = len(req.prompt)
        if plen + req.max_new_tokens > self.max_ctx:
            raise ValueError(f"request {req.rid} exceeds the context budget: "
                             f"{plen} prompt + {req.max_new_tokens} new "
                             f"tokens > max_ctx {self.max_ctx}")
        bucket = min(_next_pow2(plen), self.max_ctx)
        steps = req.max_new_tokens - 1
        if not self.cfg.window and bucket + steps > self.max_ctx:
            raise ValueError(f"request {req.rid}: its prompt's bucket of "
                             f"{bucket} tokens and {steps} decode steps "
                             f"write past max_ctx {self.max_ctx}")
        self.queue.append(req)

    def _prefill_row(self, row: int, toks: np.ndarray) -> int:
        """Prefill one left-padded prompt into ``row`` of the state (its
        K/V from slot 0, its length and first token); the host mirror
        follows.  Returns the first token."""
        if self.prefill_graph is not None:
            self.prefill_graph(self.params, self.state, toks, row=row)
        else:
            prefill_on_device(
                self.cfg, self.params, self.state,
                torch.from_numpy(toks).to(self.device),
                torch.tensor([row], device=self.device))
        self.len_np[row] = toks.shape[1]
        self._stale = True
        return int(self.state["cur"][row, 0])

    def _remove_row(self, row: int) -> None:
        """Swap the last live row into ``row`` (prefix compaction)."""
        self._stale = True
        last = len(self.live) - 1
        if row != last:
            for key in ("k", "v"):
                self.state[key][:, row] = self.state[key][:, last]
            self.len_np[row] = self.len_np[last]
            self.cur[row] = self.cur[last]
            self.live[row] = self.live[last]
        self.live.pop()
        self.len_np[last] = 1
        self.cur[last] = 0

    def _admit(self) -> None:
        while self.queue and len(self.live) < self.max_slots:
            req = self.queue[0]
            plen = len(req.prompt)
            if not self.alloc.alloc(req.rid, plen):
                break                        # pages exhausted: wait
            self.queue.pop(0)
            # bucket the prompt to a power of 2 (left-pad): bounded
            # prefill shapes
            bucket = min(_next_pow2(plen), self.max_ctx)
            toks = np.zeros((1, bucket), np.int64)
            toks[0, bucket - plen:] = req.prompt
            row = len(self.live)
            first = self._prefill_row(row, toks)
            self.stats.prefill_calls += 1
            self.live.append(req)
            self.cur[row, 0] = first
            req.output.append(first)
            if len(req.output) >= req.max_new_tokens:
                self._finish(row)
        self.stats.peak_pages = max(self.stats.peak_pages,
                                    self.alloc.used_pages)

    def _finish(self, row: int) -> None:
        req = self.live[row]
        req.done = True
        self.alloc.release(req.rid)
        self.stats.n_finished += 1
        self._remove_row(row)

    def _preempt_latest(self) -> bool:
        """Evict the most recently admitted request (recompute on
        re-admission).  False if there is nothing to evict."""
        if len(self.live) <= 1:
            return False
        row = len(self.live) - 1
        req = self.live[row]
        self.alloc.release(req.rid)
        req.output.clear()
        self._remove_row(row)
        self.queue.insert(0, req)
        self.stats.n_preempted += 1
        return True

    # --- the step -------------------------------------------------------------
    def step(self) -> bool:
        """Admissions, then ONE decode step over the live prefix.
        Returns False when queue and slots are both empty."""
        self._admit()
        if not self.live:
            if self.queue:
                raise RuntimeError(
                    "head-of-line request cannot fit the page budget")
            return False
        # grow page allocations for the token this step will append
        row = 0
        while row < len(self.live):
            req = self.live[row]
            if self.alloc.extend(req.rid, int(self.len_np[row]) + 1):
                row += 1
                continue
            if not self._preempt_latest() or row >= len(self.live):
                row += 1                     # at capacity: decode anyway
        n_live = len(self.live)
        bsz = min(_next_pow2(n_live), self.max_slots)
        if self._stale:
            self.state["len"].copy_(torch.from_numpy(self.len_np))
            self.state["cur"].copy_(torch.from_numpy(self.cur))
            self._stale = False
        decode_rows(self.cfg, self.params, self.state, bsz,
                    self.decode_graph)
        self.stats.decode_steps += 1
        self.stats.decode_row_steps += bsz
        nxt = self.state["cur"][:n_live, 0].tolist()   # one host copy
        self.len_np[:n_live] += 1
        done: List[Request] = []
        for r_i in range(n_live):
            req = self.live[r_i]
            req.output.append(int(nxt[r_i]))
            self.cur[r_i, 0] = nxt[r_i]
            if len(req.output) >= req.max_new_tokens:
                done.append(req)
        for req in done:                     # finish by identity: each
            self._finish(self.live.index(req))   # _finish swaps rows
        return bool(self.live or self.queue)

    def run(self, requests: List[Request]) -> List[Request]:
        with torch.inference_mode():
            for r in requests:
                self.submit(r)
            while self.step():
                pass
        return requests
