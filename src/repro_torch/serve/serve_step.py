"""Serving steps and a batched request server (counterpart of
``repro/serve/serve_step.py``).

``make_prefill`` runs the full-sequence forward returning (last-token
logits, cache); ``make_decode`` advances one token for the whole batch.
Both run eagerly.  The reference jits both; the port's counterpart of the
jitted decode is a CUDA graph.  A served decode step keeps its state in
static buffers (``decode_state``: the KV cache, the length, the current
tokens), and its device body (``decode_on_device``) reads and writes them
in place without a host sync, so ``GraphedDecodeStep`` captures it once
per batch size and replays it.  Prefill stays eager: its shape follows
each batch's longest prompt.  Cache sharding (``cache_specs``) waits for
the mesh slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import graphs
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


# --- the served decode step: static buffers, device body, CUDA graphs -------------

def decode_state(cfg: ModelConfig, rows: int, max_len: int, *,
                 per_row: bool, device) -> Dict[str, torch.Tensor]:
    """Static buffers of a served decode: ``k``, ``v`` (``init_cache``),
    ``len`` (int64: 0-d for a lockstep batch, ``(rows,)`` per row, at 1)
    and ``cur`` ((rows, 1) int64, the tokens the next step reads)."""
    cache = model_lib.init_cache(cfg, rows, max_len, device=device)
    shape = (rows,) if per_row else ()
    return {"k": cache["k"], "v": cache["v"],
            "len": torch.ones(shape, dtype=torch.int64, device=device),
            "cur": torch.zeros((rows, 1), dtype=torch.int64, device=device)}


def rows_of(state: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """The first ``n`` rows of a decode state, as views of its buffers."""
    ln = state["len"]
    return {"k": state["k"][:, :n], "v": state["v"][:, :n],
            "len": ln if ln.dim() == 0 else ln[:n], "cur": state["cur"][:n]}


def decode_on_device(cfg: ModelConfig, params,
                     state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One decode step's device body on ``state`` (``rows_of`` views):
    each row's new K/V row goes into the cache, ``len + 1`` into ``len``
    and the greedy next token into ``cur``, all in place.  Returns the
    last-position logits (B, V).  It reads no value on the host, copies
    nothing to or from it and branches on no tensor's value, so a CUDA
    graph can capture it."""
    logits, new = model_lib.decode(
        cfg, params, {"k": state["k"], "v": state["v"], "len": state["len"]},
        state["cur"])
    logits = logits[:, -1]
    state["len"].copy_(new["len"])
    state["cur"].copy_(torch.argmax(logits, dim=-1)[:, None])
    return logits


class GraphedDecodeStep(graphs.GraphedStep):
    """``decode_on_device`` on the first ``rows`` rows of one static decode
    state, one ``torch.cuda.CUDAGraph`` per row count (the reference jits
    one program per batch shape).  For each row count:

    1. the first call runs the body eagerly on the step's own side stream
       (what the body makes on first use, cuBLAS's handle and workspace for
       that stream among it, must not be made inside a capture);
    2. the second captures the body on that stream, then replays it;
    3. every later call replays it, on the caller's current stream.

    Every graph draws from one memory pool (``graph_pool_handle``): they
    never run at the same time.  The graphs read the storage of the params
    and read and write that of the state they were made with, so other
    tensors raise.  A call returns the step's logits, which the graph's
    next replay overwrites.  ``capture_launches[rows]`` holds the kernel
    launches a capture recorded, added to ``ops.LAUNCHES`` on every replay
    (a replay calls no wrapper); ``capture_seconds[rows]`` the capture's
    host time.  A capture that fails raises, naming the row count, and so
    does every later call: PyTorch's allocator is left recording into the
    shared pool, so no later capture can use it.  The warm call, the
    capture, the replay and the failure latch are ``graphs.GraphedStep``'s."""

    def __init__(self, cfg: ModelConfig, params,
                 state: Dict[str, torch.Tensor]):
        super().__init__(params, "graphed decode step", shared_pool=True)
        self.cfg = cfg
        self._params = graphs.tree_leaves(params)
        self._state = dict(state)
        self._captured: Dict[int, graphs.Captured] = {}
        self._warm: set = set()

    @property
    def graphs(self) -> Dict[int, torch.cuda.CUDAGraph]:
        return {rows: c.graph for rows, c in self._captured.items()}

    @property
    def capture_launches(self) -> Dict[int, Dict[str, int]]:
        return {rows: c.launches for rows, c in self._captured.items()}

    @property
    def capture_seconds(self) -> Dict[int, float]:
        return {rows: c.seconds for rows, c in self._captured.items()}

    def __call__(self, params, state: Dict[str, torch.Tensor],
                 rows: int) -> torch.Tensor:
        self.check_alive()
        self.check_bound("params", self._params, graphs.tree_leaves(params))
        self.check_bound("decode state", graphs.tree_leaves(self._state),
                         graphs.tree_leaves(state))
        held = self._state["cur"].shape[0]
        if not 1 <= rows <= held:
            raise ValueError(f"{self.who}: {rows} rows; the state holds "
                             f"{held}")

        def body():
            return decode_on_device(self.cfg, params,
                                    rows_of(self._state, rows))
        if rows not in self._warm:
            out = self.eager(body)
            self._warm.add(rows)
            return out
        if rows not in self._captured:
            self._captured[rows] = self.capture(body, f" at {rows} rows")
        return self._captured[rows].replay()


def resolve_graphed(params, graphed: Optional[bool], who: str) -> bool:
    """A server's ``graphed`` argument: None means graphed when the params
    lie on a CUDA device and eager elsewhere; True off CUDA raises."""
    dev = device_of(params)
    on_cuda = dev is not None and dev.type == "cuda"
    if graphed and not on_cuda:
        raise ValueError(f"{who}(graphed=True): a CUDA graph needs params on "
                         f"a CUDA device, got {dev}")
    return on_cuda if graphed is None else bool(graphed)


def decode_rows(cfg: ModelConfig, params, state: Dict[str, torch.Tensor],
                rows: int, graph: Optional[GraphedDecodeStep] = None
                ) -> torch.Tensor:
    """One decode step on the first ``rows`` rows of ``state``: through
    ``graph`` where there is one, else the device body run eagerly."""
    if graph is not None:
        return graph(params, state, rows)
    return decode_on_device(cfg, params, rows_of(state, rows))


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

    One static decode state of ``(batch_size, max_len)`` rows lives as long
    as the server: each batch's prefill cache is written into its prefix
    (``kv_cache.grow_cache``), compaction moves the live rows into the
    prefix in place, and decode runs on prefix views.  ``graphed``: None
    (the default) replays a ``GraphedDecodeStep`` when the params lie on
    a CUDA device and runs the body eagerly on the CPU; True on the CPU
    raises; False runs it eagerly on any device.  A batch whose prompt and
    decode steps would write past ``max_len`` raises before its prefill
    (the reference clamps the write into the cache).
    """

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 batch_size: int = 8, graphed: Optional[bool] = None):
        self.cfg = cfg
        self.params = params
        self.device = device_of(params)
        self.max_len = max_len
        self.batch_size = batch_size
        self.graphed = resolve_graphed(params, graphed, "BatchedServer")
        self._prefill = make_prefill(cfg)
        self.state = decode_state(cfg, batch_size, max_len, per_row=False,
                                  device=self.device)
        self.decode_graph = GraphedDecodeStep(cfg, params, self.state) \
            if self.graphed else None
        self.decode_steps = 0        # decode_step launches
        self.decode_row_steps = 0    # sum of batch rows over launches

    def run(self, requests: List[Request]) -> List[Request]:
        with torch.inference_mode():
            for i in range(0, len(requests), self.batch_size):
                self._run_batch(requests[i:i + self.batch_size])
        return requests

    def _compact(self, live: List[int]) -> None:
        """Move rows ``live`` of the state into its prefix, in place: the
        gather copies first, so no row is read after it was written."""
        idx = torch.tensor(live, device=self.device)
        n = len(live)
        for key in ("k", "v"):
            buf = self.state[key]
            buf[:, :n].copy_(buf[:, idx])
        cur = self.state["cur"]
        cur[:n].copy_(cur[idx])

    def _run_batch(self, reqs: List[Request]):
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        steps = max(r.max_new_tokens for r in reqs) - 1
        size = self.state["k"].shape[2]
        if not self.cfg.window and plen + steps > size:
            raise ValueError(f"BatchedServer: a {plen}-token prompt and "
                             f"{steps} decode steps write past the cache's "
                             f"{size} slots (max_len)")
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt     # left-pad
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        logits, cache = self._prefill(self.params, batch)
        # the prefill cache into the static cache's prefix, in place
        view = rows_of(self.state, b)
        kv_cache.grow_cache(cache, {"k": view["k"], "v": view["v"]})
        self.state["len"].fill_(plen)
        cur = self.state["cur"]
        cur[:b].copy_(torch.argmax(logits, dim=-1)[:, None])
        rows = list(range(b))        # batch row -> index into reqs
        while True:
            cur_host = cur[:len(rows), 0].tolist()   # one device->host copy
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
                # rows decode independently, so trajectories are unchanged
                self._compact(live)
                rows = [rows[j] for j in live]
            decode_rows(self.cfg, self.params, self.state, len(rows),
                        self.decode_graph)
            self.decode_steps += 1
            self.decode_row_steps += len(rows)
