"""Serving-mode discrete-event simulator: the inference sibling of
``simulate()``.

Where the training engine times ONE pipelined iteration and multiplies,
serving must be simulated over a *horizon*: requests arrive from a diurnal
traffic model, join and leave decode batches at step boundaries
(continuous batching), occupy paged KV-cache blocks while resident, and
interfere with prefill work when prefill and decode share a replica.  The
report is therefore tail latency (p50/p99 TTFT and TPOT), sustained
tokens/s and $/token — not iteration time.

Mechanics per decode replica:

- a ``PagedKVAllocator`` (shared accounting code with the real server in
  ``serve/paged_cache``) sized from the KV headroom that
  ``serving_stage_peak_bytes`` leaves under usable HBM;
- admission at step boundaries while a slot AND the prompt's pages are
  free; page-exhausted growth preempts the most recently admitted
  sequence back to the queue (vLLM-style recompute);
- unified replicas stall the whole decode batch for the admitted batch's
  prefill (the interference term); disaggregated plans run prefill on a
  separate FIFO pool and pay a KV-page transfer (time + egress $) into
  the decode replica's zone;
- requests are routed to the replica with the smallest work/throughput
  ratio (throughput-proportional assignment under heterogeneity).

Deterministic given ``seed``: arrivals come from a seeded thinning of the
inhomogeneous Poisson rate; nothing reads wall-clock.

A copy of ``repro/core/simulator/serving.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.plan import ServingPlan, StageReplica
from repro_torch.core.profiler.analytic import JobProfile
from repro_torch.core.simulator import memory as mem
from repro_torch.core.simulator.network import p2p_time
from repro_torch.serve.paged_cache import (PagedKVAllocator, kv_headroom_bytes,
                                     page_bytes, replica_page_budget)


# --- traffic ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Diurnal request process: rate(t) = base * (1 + amp * sin(2πt/T))."""

    base_rps: float
    diurnal_amp: float = 0.5
    period_s: float = 86400.0
    seed: int = 0

    @classmethod
    def from_job(cls, job, seed: int = 0) -> "TrafficModel":
        return cls(base_rps=job.arrival_rps, diurnal_amp=job.diurnal_amp,
                   period_s=job.diurnal_period_s, seed=seed)

    def rate(self, t: float) -> float:
        return max(self.base_rps * (1.0 + self.diurnal_amp * math.sin(
            2.0 * math.pi * t / self.period_s)), 0.0)

    @property
    def peak_rps(self) -> float:
        return self.base_rps * (1.0 + abs(self.diurnal_amp))

    @property
    def peak_time_s(self) -> float:
        """First time the sinusoid tops out (plan for the worst window)."""
        return self.period_s / 4.0

    def arrivals(self, t0: float, horizon_s: float) -> List[float]:
        """Relative arrival offsets in [0, horizon) starting at absolute
        ``t0``, via thinning of the peak-rate Poisson process."""
        rng = np.random.default_rng(self.seed)
        lam = max(self.peak_rps, 1e-12)
        out: List[float] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / lam)
            if t >= horizon_s:
                return out
            if rng.random() * lam <= self.rate(t0 + t):
                out.append(t)


# --- result -------------------------------------------------------------------

@dataclasses.dataclass
class ServingSimResult:
    """What the serving planner ranks on (sibling of ``SimResult``)."""

    valid: bool
    ttft_p50: float = math.inf      # time-to-first-token, seconds
    ttft_p99: float = math.inf
    tpot_p50: float = math.inf      # time-per-output-token, seconds
    tpot_p99: float = math.inf
    tokens_per_s: float = 0.0       # sustained generated tokens/s
    cost_per_token: float = math.inf
    cost_comp: float = 0.0          # $ over the horizon (reserved chips)
    cost_comm: float = 0.0          # $ KV-transfer egress (disaggregated)
    n_requests: int = 0
    n_finished: int = 0
    n_preempted: int = 0
    peak_mem_bytes: float = 0.0     # worst replica-shard peak (KV-aware)
    pages_per_replica: int = 0
    queue_peak: int = 0
    horizon_s: float = 0.0
    plan: Optional[ServingPlan] = None
    cluster_fp: Optional[Tuple] = None
    oom: bool = False               # memory gate failed
    degenerate: bool = False        # backlog still growing at horizon end


# --- engine -------------------------------------------------------------------

class _Request:
    __slots__ = ("rid", "t_arr", "prompt", "max_new", "generated",
                 "t_first", "t_finish", "t_ready")

    def __init__(self, rid: int, t_arr: float, prompt: int, max_new: int):
        self.rid = rid
        self.t_arr = t_arr
        self.prompt = prompt
        self.max_new = max_new
        self.generated = 0          # decode tokens produced so far
        self.t_first = -1.0         # first token (prefill completion)
        self.t_finish = -1.0
        self.t_ready = t_arr        # when it may enter a decode queue

    @property
    def decode_needed(self) -> int:
        # prefill emits the first token; decode produces the rest
        return max(self.max_new - 1, 1)


class _DecodeReplica:
    def __init__(self, idx: int, rep: StageReplica, pages: int,
                 page_size: int):
        self.idx = idx
        self.rep = rep
        self.alloc = PagedKVAllocator(pages, page_size)
        self.queue: List[_Request] = []
        self.live: List[_Request] = []   # admission order (LIFO preempt)
        self.busy = False
        self.weight = 1.0                # relative decode throughput

    def load(self) -> float:
        work = 0
        for r in self.live + self.queue:
            work += r.decode_needed - r.generated
        return work / self.weight


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else math.inf


def _round_to_page(n: int, page: int) -> int:
    return max(-(-n // page), 1) * page


def simulate_serving(profile: JobProfile, splan: ServingPlan,
                     cluster: ClusterSpec,
                     traffic: Optional[TrafficModel] = None,
                     mem_cfg: Optional[mem.MemoryModelConfig] = None,
                     horizon_s: float = 600.0,
                     t0: Optional[float] = None,
                     seed: int = 0) -> ServingSimResult:
    """Simulate ``splan`` serving ``profile.job`` (a ``ServeJob``) for
    ``horizon_s`` seconds starting at ``t0`` (default: the diurnal peak,
    so plans are sized for the worst window)."""
    job = profile.job
    cfg = profile.cfg
    splan.validate()
    if traffic is None:
        traffic = TrafficModel.from_job(job, seed=seed)
    if mem_cfg is None:
        mem_cfg = mem.serving_mem_cfg()
    L = profile.n_partition_units
    slots = splan.decode_batch
    page = splan.page_size
    pb = page_bytes(cfg, page)

    # ---- memory gate: params + KV residency through stage_peak_bytes ----
    result = ServingSimResult(valid=False, plan=splan,
                              cluster_fp=cluster.fingerprint(),
                              horizon_s=horizon_s)
    need_pages = max(-(-splan.max_ctx // page), 1)
    replicas: List[_DecodeReplica] = []
    for i, rep in enumerate(splan.decode):
        headroom = kv_headroom_bytes(profile, 0, L, slots, rep.tp,
                                     rep.gpu_type, mem_cfg)
        pages = replica_page_budget(cfg, headroom, page)
        kv_used = min(pages * pb,
                      mem.kv_cache_bytes(cfg, slots, splan.max_ctx, page))
        peak = mem.serving_stage_peak_bytes(profile, 0, L, slots, rep.tp,
                                            kv_used, mem_cfg)
        result.peak_mem_bytes = max(result.peak_mem_bytes, peak)
        if pages < need_pages:        # cannot hold even ONE full request
            result.oom = True
            return result
        r = _DecodeReplica(i, rep, pages, page)
        r.weight = 1.0 / max(profile.stage_decode_time(
            0, L, rep.gpu_type, rep.tp, slots,
            _round_to_page(splan.max_ctx, page)), 1e-9)
        replicas.append(r)
        result.pages_per_replica = pages if not result.pages_per_replica \
            else min(result.pages_per_replica, pages)
    for rep in splan.prefill:
        kv_one = mem.kv_cache_bytes(cfg, 1, job.prompt_len, page)
        peak = mem.serving_stage_peak_bytes(profile, 0, L, 1, rep.tp,
                                            kv_one, mem_cfg)
        result.peak_mem_bytes = max(result.peak_mem_bytes, peak)
        from repro_torch.core.profiler.hw_specs import get_accelerator
        if peak > get_accelerator(rep.gpu_type).usable_mem_bytes:
            result.oom = True
            return result

    # ---- workload ----
    if t0 is None:
        t0 = traffic.peak_time_s
    offs = traffic.arrivals(t0, horizon_s)
    reqs = [_Request(i, t, job.prompt_len, job.max_new_tokens)
            for i, t in enumerate(offs)]
    result.n_requests = len(reqs)
    if not reqs:
        return result

    # ---- event loop ----
    # heap entries: (time, serial, kind, payload)
    heap: List[Tuple[float, int, str, object]] = []
    serial = 0

    def push(t: float, kind: str, payload) -> None:
        nonlocal serial
        heapq.heappush(heap, (t, serial, kind, payload))
        serial += 1

    prefill_free = [0.0] * len(splan.prefill)   # next-free time per worker
    kv_xfer_bytes = mem.kv_cache_bytes(cfg, 1, job.prompt_len, page)

    def route_decode(req: _Request, now: float) -> None:
        r = min(replicas, key=lambda r: (r.load(), r.idx))
        r.queue.append(req)
        kick(r, now)

    def kick(r: _DecodeReplica, now: float) -> None:
        """Start a decode step (preceded by admission and, on unified
        replicas, the admitted batch's prefill stall)."""
        if r.busy or (not r.live and not r.queue):
            return
        admitted: List[_Request] = []
        while r.queue and len(r.live) < slots:
            req = r.queue[0]
            if not r.alloc.alloc(req.rid, req.prompt):
                break                  # wait for pages to free up
            r.queue.pop(0)
            r.live.append(req)
            admitted.append(req)
        if not r.live:
            return
        t_pref = 0.0
        if admitted and not splan.disaggregated:
            # prefill shares the replica: the decode batch stalls for it
            t_pref = profile.stage_prefill_time(
                0, L, r.rep.gpu_type, r.rep.tp, len(admitted))
            for req in admitted:
                req.t_first = now + t_pref
        b = len(r.live)
        ctx = sum(q.prompt + q.generated for q in r.live) // b
        t_step = profile.stage_decode_time(
            0, L, r.rep.gpu_type, r.rep.tp, b, _round_to_page(ctx, page))
        r.busy = True
        push(now + t_pref + t_step, "step", r)

    finished: List[_Request] = []

    def on_step(r: _DecodeReplica, now: float) -> None:
        r.busy = False
        still: List[_Request] = []
        for req in r.live:
            req.generated += 1
            if req.generated >= req.decode_needed:
                req.t_finish = now
                r.alloc.release(req.rid)
                finished.append(req)
                continue
            # grow the KV allocation; preempt LIFO on page exhaustion
            while not r.alloc.extend(req.rid, req.prompt + req.generated):
                victim = None
                for cand in reversed(still):
                    if cand is not req:
                        victim = cand
                        break
                if victim is None:
                    break             # nothing to evict; stay at capacity
                still.remove(victim)
                r.alloc.release(victim.rid)
                victim.generated = 0  # recompute-style preemption
                victim.t_first = -1.0
                r.queue.insert(0, victim)
                result.n_preempted += 1
            still.append(req)
        r.live = still
        kick(r, now)

    for req in reqs:
        push(req.t_arr, "arrive", req)

    queue_peak = 0
    while heap:
        now, _, kind, payload = heapq.heappop(heap)
        if now > horizon_s:
            break
        if kind == "arrive":
            req = payload
            if splan.disaggregated:
                # FIFO prefill pool, then KV pages stream to the decoders
                w = min(range(len(prefill_free)),
                        key=lambda i: (prefill_free[i], i))
                rep = splan.prefill[w]
                t_pref = profile.stage_prefill_time(
                    0, L, rep.gpu_type, rep.tp, 1)
                done = max(now, prefill_free[w]) + t_pref
                prefill_free[w] = done
                push(done, "prefill_done", (req, w))
            else:
                route_decode(req, now)
        elif kind == "prefill_done":
            req, w = payload
            req.t_first = now
            # ship the built KV pages to the cheapest-loaded decoder
            r = min(replicas, key=lambda r: (r.load(), r.idx))
            link = cluster.link_between(splan.prefill[w].zone, r.rep.zone)
            t_x = p2p_time(link, kv_xfer_bytes)
            result.cost_comm += kv_xfer_bytes * cluster.egress_price(
                splan.prefill[w].zone, r.rep.zone)
            req.t_ready = now + t_x
            push(req.t_ready, "enqueue", (req, r))
        elif kind == "enqueue":
            req, r = payload
            r.queue.append(req)
            kick(r, now)
        else:                          # "step"
            on_step(payload, now)
        queue_peak = max(queue_peak, sum(len(r.queue) for r in replicas))

    # ---- metrics ----
    result.queue_peak = queue_peak
    result.n_finished = len(finished)
    backlog = sum(len(r.queue) + len(r.live) for r in replicas)
    result.degenerate = backlog > 2 * len(replicas) * slots
    if not finished:
        return result
    ttfts = [q.t_first - q.t_arr for q in finished]
    tpots = [(q.t_finish - q.t_first) / q.decode_needed for q in finished]
    result.ttft_p50 = _pct(ttfts, 50)
    result.ttft_p99 = _pct(ttfts, 99)
    result.tpot_p50 = _pct(tpots, 50)
    result.tpot_p99 = _pct(tpots, 99)
    total_tokens = sum(1 + q.generated for q in reqs if q.t_first >= 0
                       or q.generated > 0)
    result.tokens_per_s = total_tokens / horizon_s
    # reserved-capacity compute cost over the horizon
    rate = 0.0
    for rep in splan.decode + splan.prefill:
        rate += rep.n_chips * cluster.zone(rep.zone).price_per_sec(
            rep.gpu_type)
    result.cost_comp = rate * horizon_s
    result.cost_per_token = (result.cost_comp + result.cost_comm) \
        / max(total_tokens, 1)
    result.valid = True
    return result
