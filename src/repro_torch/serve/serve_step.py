"""Serving steps and a batched request server (counterpart of
``repro/serve/serve_step.py``).

``make_prefill`` runs the full-sequence forward returning (last-token
logits, cache); ``make_decode`` advances one token for the whole batch.
Both run eagerly.  The reference jits the servers' prefill and decode;
the port's counterparts of those jitted programs are CUDA graphs.  A
server keeps one static decode state for its life (``decode_state``: the
KV cache, the length, the current tokens).  A served prefill's device
body (``prefill_on_device``) writes its K/V, length and first token into
rows of that state, and a decode step's (``decode_on_device``) reads and
writes it in place; neither syncs with the host, so ``GraphedPrefill``
captures a prefill once per prompt shape and ``GraphedDecodeStep`` a
decode step once per batch size, and both replay.  The state holds the
family's cache leaves (``model.cache_decls``: ``k``/``v`` for attention,
``ssm``/``conv`` for the state-space families, all four for the hybrid,
``k``/``v`` and the cross-attention's ``ck``/``cv`` for encdec), the
batch their dim 1.  The encdec and vlm prefills take zero ``frames`` or
``patches`` (``model.stub_inputs``), as the reference's server gives
them.  ``cache_specs`` is the
reference's cache layout on a mesh (a plain copy): ``make_prefill(cfg,
mesh)`` and ``make_decode(cfg, mesh)`` run the sharded prefill and decode
step on it (``dist/spmd_serve.py``); the servers run on one device, as
the reference's ``BatchedServer`` takes no mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import graphs
from repro_torch.device import device_of
from repro_torch.dist import placement as pm
from repro_torch.dist import sharding as shd
from repro_torch.models import mamba2
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.serve import kv_cache


# logical rules for cache tensors: prefer kv-head sharding, fall back to
# sequence (context-parallel decode), never both on 'model'.
CACHE_RULES = {
    "kv_heads": ("model",),
    "kv_seq": ("model",),
    "ssm_inner": ("model",),
}


def cache_specs(cfg: ModelConfig, batch: int, max_len: int, mesh):
    """Specs of ``model.cache_decls(cfg, batch, max_len)`` on ``mesh``:
    kv heads over 'model' where they divide, else the sequence; the batch
    dim over the dp axes where it divides (a plain copy of the
    reference's)."""
    decls = model_lib.cache_decls(cfg, batch, max_len)

    def to_spec(d: shd.Decl):
        # try kv_heads first; if it didn't shard, allow kv_seq
        spec = shd.logical_to_spec(d.shape, d.axes,
                                   {"kv_heads": ("model",),
                                    "ssm_inner": ("model",)}, mesh)
        if all(s is None for s in spec) and "kv_seq" in d.axes:
            spec = shd.logical_to_spec(d.shape, d.axes,
                                       {"kv_seq": ("model",)}, mesh)
        return spec

    # shard batch dim (dim 1 for stacked caches) over dp axes when divisible
    dp = shd.batch_spec(mesh, batch)[0]

    def add_dp(d: shd.Decl, spec: shd.P):
        parts = list(spec)
        for i, ax in enumerate(d.axes):
            if ax is None and i == 1 and d.shape[i] == batch and dp is not None:
                if parts[i] is None:
                    parts[i] = dp
        return shd.P(*parts)

    return {k: add_dp(d, to_spec(d)) for k, d in decls.items()}


def _last(logits):
    """The last position's logits (B, V): of a tensor, or of a mesh's
    ``Sharded`` (B, S, V), its blocks' last positions as a ``Sharded`` of
    the same layout."""
    if not isinstance(logits, pm.Sharded):
        return logits[:, -1]
    b, _, v = logits.shape
    return pm.Sharded((b, v), shd.P(logits.spec[0], logits.spec[2]),
                      logits.mesh, [x[:, -1].contiguous()
                                    for x in logits.blocks])


def make_prefill(cfg: ModelConfig, mesh=None) -> Callable:
    """(params, batch) -> (last-token logits, cache).  ``mesh``: the
    sharded prefill (``params`` a tree of ``Sharded``; the logits a
    ``Sharded`` (B, V) fp32, the cache ``Sharded`` leaves laid out by
    ``cache_specs(cfg, B, S, mesh)``)."""
    def prefill(params, batch):
        logits, cache = model_lib.forward(cfg, params, batch, mesh=mesh,
                                          return_cache=True)
        return _last(logits), cache
    return prefill


def make_decode(cfg: ModelConfig, mesh=None) -> Callable:
    """(params, cache, tokens) -> (logits (B, V), cache), one token for
    the whole batch; ``mesh`` as ``make_prefill``'s, on a cache laid out
    by ``cache_specs(cfg, B, max_len, mesh)`` (``kv_cache.grow_cache``)."""
    def decode(params, cache, tokens):
        logits, cache = model_lib.decode(cfg, params, cache, tokens,
                                         mesh=mesh)
        return _last(logits), cache
    return decode


# --- the served decode step: static buffers, device body, CUDA graphs -------------

def cache_keys(state: Dict[str, torch.Tensor]) -> List[str]:
    """The cache leaves of a decode state (every key but ``len`` and
    ``cur``), in the state's order."""
    return [k for k in state if k not in ("len", "cur")]


def decode_state(cfg: ModelConfig, rows: int, max_len: int, *,
                 per_row: bool, device) -> Dict[str, torch.Tensor]:
    """Static buffers of a served decode: the cache's leaves
    (``init_cache``, in ``cfg.dtype``, but ``ssm`` in fp32: a decode step
    carries the SSM state in fp32, as the reference's does, and writes it
    in place), ``len`` (int64: 0-d for a lockstep batch, ``(rows,)`` per
    row, at 1) and ``cur`` ((rows, 1) int64, the tokens the next step
    reads)."""
    cache = model_lib.init_cache(cfg, rows, max_len, device=device)
    state = {k: v for k, v in cache.items() if k != "len"}
    if "ssm" in state:
        state["ssm"] = state["ssm"].float()
    shape = (rows,) if per_row else ()
    state["len"] = torch.ones(shape, dtype=torch.int64, device=device)
    state["cur"] = torch.zeros((rows, 1), dtype=torch.int64, device=device)
    return state


def rows_of(state: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    """The first ``n`` rows of a decode state, as views of its buffers."""
    ln = state["len"]
    out = {k: state[k][:, :n] for k in cache_keys(state)}
    out["len"] = ln if ln.dim() == 0 else ln[:n]
    out["cur"] = state["cur"][:n]
    return out


def prefill_on_device(cfg: ModelConfig, params,
                      state: Dict[str, torch.Tensor], tokens: torch.Tensor,
                      rows: Union[int, torch.Tensor]) -> torch.Tensor:
    """One served prefill's device body: ``make_prefill`` on ``tokens``
    (B, S), its cache written into rows of ``state`` (K/V from slot 0), in
    place (an SSM state rounded to ``cfg.dtype`` first: the reference's
    ``grow_cache`` casts it into its ``cfg.dtype`` buffer, and its decode
    carries it in fp32 from there, as the state's fp32 buffer does),
    those rows' ``len`` set to the cache's (S, or ``n_patches + S`` for
    vlm) and the greedy first token written into their ``cur``.  The
    stubbed frontends' zero ``frames`` or ``patches`` are made on the
    device inside the body, so a graph captures them.  ``rows`` is an int
    ``B`` (the prefix ``[0, B)``, as ``rows_of`` gives it: the static
    server) or a (B,) int64 tensor of row indices on the state's device (a
    per-row state: the continuous server's row, so one graph serves every
    row).  Returns the last-position
    logits (B, V) as a tensor of their own, so the (B, S, V) logits are a
    temporary.  It reads no value on the host, copies nothing to or from
    it and branches on no tensor's value, so a CUDA graph can capture it."""
    batch = {"tokens": tokens,
             **model_lib.stub_inputs(cfg, tokens.shape[0], tokens.device)}
    logits, cache = make_prefill(cfg)(params, batch)
    if "ssm" in cache:
        cache = mamba2.round_state(cfg, cache)
    logits = logits.clone()
    first = torch.argmax(logits, dim=-1)[:, None]
    keys = cache_keys(state)
    if isinstance(rows, torch.Tensor):
        for key in keys:
            src = cache[key]
            dst = state[key][(slice(None), slice(None)) + tuple(
                slice(0, d) for d in src.shape[2:])]
            dst.index_copy_(1, rows, src.to(dst.dtype))
        state["len"].index_fill_(0, rows, cache["len"])
        state["cur"].index_copy_(0, rows, first)
    else:
        view = rows_of(state, rows)
        kv_cache.grow_cache(cache, {k: view[k] for k in keys})
        view["len"].fill_(cache["len"])
        view["cur"].copy_(first)
    return logits


def decode_on_device(cfg: ModelConfig, params,
                     state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One decode step's device body on ``state`` (``rows_of`` views):
    each row's new K/V row (and SSM and conv state) goes into the cache,
    ``len + 1`` into ``len``
    and the greedy next token into ``cur``, all in place.  Returns the
    last-position logits (B, V).  It reads no value on the host, copies
    nothing to or from it and branches on no tensor's value, so a CUDA
    graph can capture it."""
    cache = {k: state[k] for k in cache_keys(state)}
    cache["len"] = state["len"]
    logits, new = model_lib.decode(cfg, params, cache, state["cur"])
    logits = logits[:, -1]
    state["len"].copy_(new["len"])
    state["cur"].copy_(torch.argmax(logits, dim=-1)[:, None])
    return logits


class GraphedDecodeStep(graphs.GraphedShapes):
    """``decode_on_device`` on the first ``rows`` rows of one static decode
    state, one ``torch.cuda.CUDAGraph`` per row count (the reference jits
    one program per batch shape).  For each row count:

    1. the first call runs the body eagerly: the step's first call on its
       own side stream (what the body makes on first use, cuBLAS's handle
       and workspace for that stream among it, must not be made inside a
       capture), the first call at a later row count on the caller's;
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
    capture, the replay and the failure latch are ``graphs.GraphedShapes``'s."""

    def __init__(self, cfg: ModelConfig, params,
                 state: Dict[str, torch.Tensor]):
        super().__init__(params, "graphed decode step", shared_pool=True)
        self.cfg = cfg
        self._params = graphs.tree_leaves(params)
        self._state = dict(state)

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
        return self.run(rows, body, f" at {rows} rows")


class GraphedPrefill(graphs.GraphedShapes):
    """``prefill_on_device`` into one static decode state, one
    ``torch.cuda.CUDAGraph`` per prompt shape (the reference's jitted
    prefill compiles one program per shape).  ``by_row`` False: a call
    prefills B prompts into the prefix ``[0, B)`` (the static server), one
    graph per ``(B, S)``; True: one prompt into the row it names, through a
    device row index the host writes before each run, so one graph per
    bucket ``S`` serves every row (the continuous server).  Each shape has
    a static token buffer on the device, into which a call copies its
    left-padded prompts.  For each shape, as in ``GraphedDecodeStep``: the
    first call runs the body eagerly (the step's first call on its side
    stream, a later shape's on the caller's stream, where the eager body
    runs, so a shape seen once costs what it costs eagerly), the second
    captures it on the side stream and replays it, later calls replay it
    on the caller's current stream.

    Every output that outlives a call is in the static state (K/V, ``len``,
    ``cur``), outside the graphs' memory.  The graphs share one pool of
    their own (not the decode graphs'): they never run at the same time,
    and a call's logits, which live in that pool, hold only until the
    step's next call (a replay writes its temporaries where a graph
    captured later keeps its logits).  The graphs read the storage of the
    params and write that of the state they were made with, so other
    tensors raise.  ``graphs``, ``capture_launches`` (added to
    ``ops.LAUNCHES`` on every replay) and ``capture_seconds`` are keyed by
    shape.  A capture that fails raises, naming the shape, and so does
    every later call (``graphs.GraphedShapes``)."""

    def __init__(self, cfg: ModelConfig, params,
                 state: Dict[str, torch.Tensor], by_row: bool = False):
        super().__init__(params, "graphed prefill", shared_pool=True)
        self.cfg = cfg
        self.by_row = by_row
        self._params = graphs.tree_leaves(params)
        self._state = dict(state)
        self._row = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._tokens: Dict[object, torch.Tensor] = {}

    def __call__(self, params, state: Dict[str, torch.Tensor],
                 tokens: np.ndarray, row: Optional[int] = None
                 ) -> torch.Tensor:
        """Prefill ``tokens`` ((B, S) host ints, left-padded) into the
        prefix, or (``by_row``; B = 1) into ``row``.  Returns the logits
        (B, V), valid until the next call."""
        self.check_alive()
        self.check_bound("params", self._params, graphs.tree_leaves(params))
        self.check_bound("decode state", graphs.tree_leaves(self._state),
                         graphs.tree_leaves(state))
        b, s = tokens.shape
        held = self._state["cur"].shape[0]
        if self.by_row:
            if b != 1 or row is None or not 0 <= row < held:
                raise ValueError(f"{self.who}: by row, one prompt into a row "
                                 f"of {held}; got {b} prompts, row {row}")
            key, where, rows = s, f" at bucket {s}", self._row
        else:
            if row is not None or not 1 <= b <= held:
                raise ValueError(f"{self.who}: {b} prompts into the prefix "
                                 f"(row {row}); the state holds {held}")
            key, where, rows = (b, s), f" at {b} x {s}", b
        if key not in self._tokens:
            self._tokens[key] = torch.empty((b, s), dtype=torch.int64,
                                            device=self.device)
        buf = self._tokens[key]
        buf.copy_(torch.from_numpy(np.asarray(tokens, np.int64)))
        if self.by_row:
            self._row.fill_(row)

        def body():
            return prefill_on_device(self.cfg, params, self._state, buf, rows)
        return self.run(key, body, where)


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
    as the server: each batch's prefill writes its cache into the state's
    prefix (``prefill_on_device``), compaction moves the live rows into the
    prefix in place, and decode runs on prefix views.  ``graphed``: None
    (the default) runs the prefill through a ``GraphedPrefill`` (a graph
    per batch shape, from the second batch of that shape on) and the decode
    steps through a ``GraphedDecodeStep`` when the params lie on a CUDA
    device, and both bodies eagerly on the CPU; True on the CPU raises;
    False runs both eagerly on any device.  Prompts are not bucketed: the
    prefill has no pad mask, so a longer pad would change its logits
    against the reference's.  A batch whose prompt and decode steps would
    write past ``max_len`` raises before its prefill (the reference clamps
    the write into the cache); a vlm batch counts its ``n_patches`` patch
    positions, which its prefill's cache holds before the prompt.
    """

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 batch_size: int = 8, graphed: Optional[bool] = None):
        self.cfg = cfg
        self.params = params
        self.device = device_of(params)
        self.max_len = max_len
        self.batch_size = batch_size
        self.graphed = resolve_graphed(params, graphed, "BatchedServer")
        self.state = decode_state(cfg, batch_size, max_len, per_row=False,
                                  device=self.device)
        self.prefill_graph = GraphedPrefill(cfg, params, self.state) \
            if self.graphed else None
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
        for key in cache_keys(self.state):
            buf = self.state[key]
            buf[:, :n].copy_(buf[:, idx])
        cur = self.state["cur"]
        cur[:n].copy_(cur[idx])

    def _run_batch(self, reqs: List[Request]):
        b = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        steps = max(r.max_new_tokens for r in reqs) - 1
        # a state-space cache has no slots to run past (the reference's
        # state ignores max_len)
        size = self.state["k"].shape[2] if "k" in self.state else None
        extra = self.cfg.n_patches if self.cfg.family == "vlm" else 0
        if size is not None and not self.cfg.window and \
                extra + plen + steps > size:
            what = f"{extra} patches, " if extra else ""
            raise ValueError(f"BatchedServer: {what}a {plen}-token prompt "
                             f"and {steps} decode steps write past the "
                             f"cache's {size} slots (max_len)")
        toks = np.zeros((b, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.prompt):] = r.prompt     # left-pad
        # the prefill's cache, length and first tokens into the prefix
        if self.prefill_graph is not None:
            self.prefill_graph(self.params, self.state, toks)
        else:
            prefill_on_device(self.cfg, self.params, self.state,
                              torch.from_numpy(toks).to(self.device), b)
        cur = self.state["cur"]
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
