"""Discrete-event iteration-time engine (paper §4.3, Fig. 5/6).

The closed-form 1F1B formula (kept as ``timing.closed_form_iteration_time``)
systematically mispredicts iteration time: it serializes compute and
communication (every p2p is charged twice on the straggler's critical path,
the DP all-reduce is appended after the whole pipeline drains), and it never
models hierarchical cross-zone collectives.  Since the planner, the
warm-start replanner and the transition model all rank candidates by
``simulate()``, that bias silently picks wrong plans everywhere downstream.

This module replaces the formula with a small discrete-event simulation:

* **Tasks** — per-microbatch forward/backward on per-worker *compute
  resources*, activation/gradient transfers on per-boundary *link
  resources*, bucketed DP gradient all-reduces on per-stage *ring
  resources*, and per-worker optimizer updates.
* **Overlap** — with ``overlap_comm=True`` transfers occupy only the link
  (the sender fires and forgets, the receiver's next task depends on the
  transfer), and the backward of the *last* microbatch is split into
  ``dp_buckets`` chunks so bucket ``k``'s all-reduce starts as soon as the
  layers it covers have produced gradients — DP sync overlaps the tail of
  the backward pass exactly like a bucketed NCCL/`psum` implementation.
  With ``overlap_comm=False`` transfers run on the receiving worker and the
  sync is a single post-barrier ring: the 1F1B engine then degrades to the
  closed-form model (the analytic-limit equivalence tested in
  ``tests/test_engine.py``).  The interleaved schedule always models
  overlapped communication — it has no closed-form analog.
* **Schedules** — ``"1f1b"`` builds the classic one-forward-one-backward
  per-worker order; ``"interleaved"`` splits every worker into
  ``virtual_stages`` chunks (Megatron-style virtual pipeline) and uses a
  greedy earliest-start list scheduler, shrinking the fill/drain bubble by
  the interleaving factor.

Engine core: tasks on FIFO resources form a DAG (explicit dependency edges
plus resource-order edges), so start times are a single topological
longest-path pass — no event heap needed.  The greedy scheduler is only
used for interleaved schedules where the per-worker order is not fixed a
priori.

Steady-state extrapolation: 1F1B schedules are periodic once the pipeline
fills, so for large microbatch counts the caller simulates
``max_exact_microbatches`` exactly and extends by ``period`` — the
bottleneck resource's per-microbatch busy time (the cycle time of the
underlying marked graph).  Cost per call is O(pp * min(M, 2 pp + 4))
regardless of the global batch.

Calibration: ``fixed_overhead_s`` and ``per_task_overhead_s`` are fitted by
``core/profiler/measured.calibrate_engine`` against real ``MPMDPipeline``
wall-clock on host devices (dispatch of one jitted program / one
``device_put`` per task dominates on CPU rigs).

A copy of ``repro/core/simulator/engine.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of the event engine (the calibratable surface)."""

    schedule: str = "1f1b"            # "1f1b" | "interleaved"
    virtual_stages: int = 1           # model chunks per worker (interleaved)
    dp_buckets: int = 4               # max gradient AR buckets overlapped
    bucket_bytes: float = 25e6        # DDP-style min bucket size: small
    #                                   payloads collapse to one bucket so
    #                                   the ring latency term is paid once
    overlap_comm: bool = True         # False -> closed-form analytic limit
    fixed_overhead_s: float = 0.0     # calibrated per-iteration overhead
    per_task_overhead_s: float = 0.0  # calibrated per-task dispatch overhead
    max_exact_microbatches: int = 0   # 0 = auto (2 * n_stages * v + 4)
    record_timeline: bool = False     # keep tagged (tag, start, end) events
    #                                   in PipelineResult.timeline — the
    #                                   telemetry layer's sample source
    sync_lag: int = 0                 # bounded-staleness DP sync: updates
    #                                   may apply gradients lagging <= k
    #                                   steps, so the all-reduce tail drops
    #                                   off the iteration critical path
    #                                   (0 = fully synchronous, the default
    #                                   path is untouched)

    def exact_cap(self, n_stages: int) -> int:
        if self.max_exact_microbatches > 0:
            return self.max_exact_microbatches
        return 2 * n_stages * max(self.virtual_stages, 1) + 4


DEFAULT_ENGINE = EngineConfig()


@dataclasses.dataclass(frozen=True)
class WorkerCost:
    """Per-microbatch compute cost of one (stage, replica) worker."""

    fwd: float
    bwd: float
    upd: float


@dataclasses.dataclass
class PipelineSpec:
    """Schedule-independent description of one training iteration.

    ``assign(stage, m)`` routes global microbatch ``m`` to a replica of
    ``stage`` — stages may have *unequal* replica counts (boundary traffic
    then fans in/out along this explicit sender->receiver mapping instead
    of assuming index ``d`` exists everywhere).  ``p2p(sa, sb, ra, rb)``
    is the transfer seconds for one microbatch between adjacent (possibly
    wrapping, for interleaved) stages.  ``sync[s]`` lists the per-bucket
    all-reduce seconds of stage ``s`` (empty when dp == 1).
    """

    n_stages: int
    n_replicas: Tuple[int, ...]
    cost: Mapping[Tuple[int, int], WorkerCost]
    total_micro: int
    assign: Callable[[int, int], int]
    p2p: Callable[[int, int, int, int], float]
    sync: Sequence[Sequence[float]]


@dataclasses.dataclass
class PipelineResult:
    t_total: float                    # makespan incl. sync + update
    t_pp: float                       # last backward end (pipeline phase)
    bwd_end: List[float]              # per stage: last backward end
    sync_end: List[float]             # per stage: last AR bucket end
    busy_per_micro: Dict[Tuple[int, int], float]   # steady busy per worker
    period: float                     # steady-state cycle time (per micro)
    n_tasks: int
    # with cfg.record_timeline: every tagged task as (tag, start, end) —
    # tags: ("F"|"B", stage, replica, micro), ("PF"|"PB", boundary, ra, rb,
    # micro), ("AR", stage, bucket), ("U", stage, replica).  This is the
    # event timeline the telemetry layer converts into bus samples.
    timeline: Optional[List[Tuple[Tuple, float, float]]] = None


# --- core: tasks on serialized resources --------------------------------------

class _Task:
    __slots__ = ("dur", "deps", "prio", "start", "end", "seq", "tag")

    def __init__(self, dur: float, prio: Tuple = (), seq: int = 0,
                 tag: Optional[Tuple] = None):
        self.dur = dur
        self.deps: List["_Task"] = []
        self.prio = prio
        self.start = -1.0
        self.end = -1.0
        self.seq = seq
        self.tag = tag


class _Resource:
    __slots__ = ("fifo", "queue")

    def __init__(self, fifo: bool = True):
        self.fifo = fifo
        self.queue: List[_Task] = []


class Sim:
    """Tasks on serialized resources; FIFO resources solve as a DAG pass."""

    def __init__(self) -> None:
        self._resources: Dict = {}
        self._tasks: List[_Task] = []

    def resource(self, key, fifo: bool = True) -> _Resource:
        r = self._resources.get(key)
        if r is None:
            r = self._resources[key] = _Resource(fifo)
        return r

    def task(self, dur: float, prio: Tuple = (),
             tag: Optional[Tuple] = None) -> _Task:
        t = _Task(dur, prio, seq=len(self._tasks), tag=tag)
        self._tasks.append(t)
        return t

    def timeline(self) -> List[Tuple[Tuple, float, float]]:
        """Tagged tasks as (tag, start, end), start-ordered (after run)."""
        rows = [(t.tag, t.start, t.end) for t in self._tasks
                if t.tag is not None]
        rows.sort(key=lambda r: (r[1], r[2], r[0]))
        return rows

    def place(self, task: _Task, res: _Resource) -> _Task:
        res.queue.append(task)
        return task

    @property
    def n_tasks(self) -> int:
        return len(self._tasks)

    def run(self) -> float:
        if all(r.fifo for r in self._resources.values()):
            return self._run_fifo()
        return self._run_greedy()

    def _run_fifo(self) -> float:
        """Longest path over the task DAG (Kahn).

        Callers must have chained resource-order edges into ``deps`` via
        ``_chain_fifo_deps`` — a FIFO resource starts its head task as soon
        as its dependencies are met, so timing is exactly a longest-path
        computation; no event heap is needed.
        """
        indeg = [len(t.deps) for t in self._tasks]
        succ: List[List[int]] = [[] for _ in self._tasks]
        for t in self._tasks:
            for d in t.deps:
                succ[d.seq].append(t.seq)
        ready = [t.seq for t in self._tasks if indeg[t.seq] == 0]
        makespan = 0.0
        done = 0
        while ready:
            i = ready.pop()
            t = self._tasks[i]
            start = 0.0
            for d in t.deps:
                if d.end > start:
                    start = d.end
            t.start = start
            t.end = start + t.dur
            done += 1
            if t.end > makespan:
                makespan = t.end
            for j in succ[i]:
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.append(j)
        if done != len(self._tasks):
            raise RuntimeError("engine deadlock: cyclic task graph")
        return makespan

    def _run_greedy(self) -> float:
        """Earliest-start list scheduling for priority resources."""
        pending: Dict[int, List[_Task]] = {}
        res_free: Dict[int, float] = {}
        res_list = list(self._resources.values())
        for ri, r in enumerate(res_list):
            pending[ri] = list(r.queue)
            res_free[ri] = 0.0
        scheduled = set()
        remaining = sum(len(q) for q in pending.values())
        makespan = 0.0
        while remaining:
            best = None
            best_key = None
            for ri, r in enumerate(res_list):
                q = pending[ri]
                if not q:
                    continue
                cands = [q[0]] if r.fifo else q
                for t in cands:
                    if any(d.seq not in scheduled for d in t.deps):
                        continue
                    ready = max((d.end for d in t.deps), default=0.0)
                    start = max(res_free[ri], ready)
                    key = (start, t.prio, t.seq)
                    if best_key is None or key < best_key:
                        best_key = key
                        best = (ri, t, start)
            if best is None:
                raise RuntimeError("engine deadlock: no startable task")
            ri, t, start = best
            t.start = start
            t.end = start + t.dur
            res_free[ri] = t.end
            pending[ri].remove(t)
            scheduled.add(t.seq)
            remaining -= 1
            if t.end > makespan:
                makespan = t.end
        return makespan


def _chain_fifo_deps(sim: Sim) -> None:
    """Materialize FIFO resource order as dependency edges for _run_fifo."""
    for r in sim._resources.values():
        for a, b in zip(r.queue, r.queue[1:]):
            b.deps.append(a)


# --- 1F1B order ---------------------------------------------------------------

def one_f_one_b_order(n_own: int, warmup: int) -> List[Tuple[str, int]]:
    """Per-worker 1F1B op order over its local microbatch indices."""
    w = min(max(warmup, 1), n_own)
    order: List[Tuple[str, int]] = [("F", m) for m in range(w)]
    for m in range(n_own - w):
        order.append(("B", m))
        order.append(("F", m + w))
    for m in range(n_own - w, n_own):
        order.append(("B", m))
    return order


# --- pipeline builders --------------------------------------------------------

def _steady_period(spec: PipelineSpec, cfg: EngineConfig) -> float:
    """Cycle time of the steady state: the bottleneck resource's busy time
    per microbatch (workers incl. non-overlapped receives; links).

    1F1B task graphs are marked graphs, whose asymptotic cycle time is the
    maximum per-token resource occupancy — so for M microbatches beyond the
    exactly-simulated window, makespan grows by exactly this period."""
    ov = cfg.per_task_overhead_s
    v = max(cfg.virtual_stages, 1) if cfg.schedule == "interleaved" else 1
    period = 0.0
    for (s, r), c in spec.cost.items():
        busy = c.fwd + c.bwd + 2 * v * ov + _worker_recv(spec, cfg, s, r)
        if busy > period:
            period = busy
    # links: in overlap mode transfers serialize per boundary channel (the
    # interleaved schedule adds the wrap-around boundary P-1 -> 0)
    if cfg.overlap_comm or v > 1:
        for s in range(spec.n_stages - 1):
            for r in range(spec.n_replicas[s]):
                rb = min(r, spec.n_replicas[s + 1] - 1)
                t = spec.p2p(s, s + 1, r, rb) + ov
                if t > period:
                    period = t
        if v > 1 and spec.n_stages > 1:
            for r in range(spec.n_replicas[-1]):
                rb = min(r, spec.n_replicas[0] - 1)
                t = spec.p2p(spec.n_stages - 1, 0, r, rb) + ov
                if t > period:
                    period = t
    return period


def _worker_recv(spec: PipelineSpec, cfg: EngineConfig,
                 s: int, r: int) -> float:
    """Per-microbatch transfer time charged to worker (s, r) when comm is
    not overlapped (receives run on the compute resource).  The
    interleaved schedule always models overlapped transfers (see
    :func:`run_interleaved`), so nothing is charged there."""
    if cfg.overlap_comm or cfg.schedule == "interleaved":
        return 0.0
    ov = cfg.per_task_overhead_s
    t = 0.0
    if s > 0:
        ra = min(r, spec.n_replicas[s - 1] - 1)
        t += spec.p2p(s - 1, s, ra, r) + ov
    if s < spec.n_stages - 1:
        rb = min(r, spec.n_replicas[s + 1] - 1)
        t += spec.p2p(s, s + 1, r, rb) + ov
    return t


def run_1f1b(spec: PipelineSpec, cfg: EngineConfig) -> PipelineResult:
    """Event-driven 1F1B with optional comm overlap and bucketed DP sync."""
    sim = Sim()
    P = spec.n_stages
    ov = cfg.per_task_overhead_s
    total = spec.total_micro

    # microbatch routing: per stage, the local list each replica handles
    local: Dict[Tuple[int, int], List[int]] = {
        (s, r): [] for s in range(P) for r in range(spec.n_replicas[s])}
    route: Dict[Tuple[int, int], int] = {}
    for m in range(total):
        for s in range(P):
            r = spec.assign(s, m)
            local[(s, r)].append(m)
            route[(s, m)] = r

    worker = {k: sim.resource(("w",) + k) for k in local}
    fwd: Dict[Tuple[int, int], _Task] = {}
    bwd_last: Dict[Tuple[int, int], List[_Task]] = {}   # worker -> buckets
    bwd: Dict[Tuple[int, int], _Task] = {}              # (s, m) -> final task
    xf: Dict[Tuple[int, int], _Task] = {}               # act transfer into s
    xb: Dict[Tuple[int, int], _Task] = {}               # grad transfer into s

    # create transfer tasks
    for m in range(total):
        for s in range(P - 1):
            ra, rb = route[(s, m)], route[(s + 1, m)]
            dur = spec.p2p(s, s + 1, ra, rb) + ov
            xf[(s + 1, m)] = sim.task(dur, tag=("PF", s, ra, rb, m))
            xb[(s, m)] = sim.task(dur, tag=("PB", s, ra, rb, m))

    # per-worker ordered compute queues; the last backward splits into one
    # part per sync bucket so bucket k's all-reduce starts as soon as the
    # gradients it covers exist
    for (s, r), ms in sorted(local.items()):
        res = worker[(s, r)]
        c = spec.cost[(s, r)]
        n_buckets = len(spec.sync[s])
        for kind, i in one_f_one_b_order(len(ms), P - s):
            m = ms[i]
            if kind == "F":
                if s > 0 and not cfg.overlap_comm:
                    sim.place(xf[(s, m)], res)
                t = sim.place(sim.task(c.fwd + ov, tag=("F", s, r, m)), res)
                fwd[(s, m)] = t
            else:
                if s < P - 1 and not cfg.overlap_comm:
                    sim.place(xb[(s, m)], res)
                split = (n_buckets > 0 and cfg.overlap_comm
                         and i == len(ms) - 1)
                k = n_buckets if split else 1
                parts = [sim.place(sim.task(c.bwd / k + (ov if j == 0 else 0),
                                            tag=("B", s, r, m)),
                                   res)
                         for j in range(k)]
                bwd[(s, m)] = parts[-1]
                if i == len(ms) - 1:
                    bwd_last[(s, r)] = parts

    # overlap mode: transfers live on per-channel link resources
    if cfg.overlap_comm:
        for m in range(total):
            for s in range(P - 1):
                ra, rb = route[(s, m)], route[(s + 1, m)]
                sim.place(xf[(s + 1, m)], sim.resource(("lf", s, ra, rb)))
                sim.place(xb[(s, m)], sim.resource(("lb", s, ra, rb)))

    # dependencies: forward chain via activation transfers, backward chain
    # via gradient transfers; a split backward attaches them to its first
    # bucket (the parts chain on the worker resource).
    for m in range(total):
        for s in range(P):
            if s > 0:
                x = xf[(s, m)]
                x.deps.append(fwd[(s - 1, m)])
                fwd[(s, m)].deps.append(x)
            if s < P - 1:
                xb[(s, m)].deps.append(bwd[(s + 1, m)])
    for (s, m), t_final in bwd.items():
        r = route[(s, m)]
        parts = bwd_last.get((s, r))
        first = parts[0] if parts is not None and parts[-1] is t_final \
            else t_final
        first.deps.append(fwd[(s, m)])
        if s < P - 1:
            first.deps.append(xb[(s, m)])

    # DP sync: bucketed all-reduce per stage on a ring resource
    ar: Dict[int, List[_Task]] = {}
    all_final_bwd = [bwd[(s, local[(s, r)][-1])]
                     for s in range(P) for r in range(spec.n_replicas[s])
                     if local[(s, r)]]
    for s in range(P):
        buckets = list(spec.sync[s])
        if not buckets:
            continue
        ring = sim.resource(("ring", s))
        ar[s] = []
        for k, dur in enumerate(buckets):
            t = sim.task(dur, tag=("AR", s, k))
            if cfg.overlap_comm:
                for r in range(spec.n_replicas[s]):
                    parts = bwd_last.get((s, r))
                    if parts:
                        t.deps.append(parts[min(k, len(parts) - 1)])
            else:
                t.deps.extend(all_final_bwd)   # post-pipeline barrier
            sim.place(t, ring)
            ar[s].append(t)

    # optimizer update per worker, after that stage's sync
    upd_tasks: Dict[Tuple[int, int], _Task] = {}
    for (s, r), ms in local.items():
        if not ms:
            continue
        t = sim.place(sim.task(spec.cost[(s, r)].upd + ov, tag=("U", s, r)),
                      worker[(s, r)])
        if s in ar and cfg.sync_lag == 0:
            # synchronous: the update waits for this stage's gradient sync.
            # Under bounded staleness (sync_lag > 0) it applies a gradient
            # from <= k steps ago instead, so the AR tail is decoupled.
            t.deps.append(ar[s][-1])
        upd_tasks[(s, r)] = t

    _chain_fifo_deps(sim)
    t_total = sim.run()
    if cfg.sync_lag > 0:
        # compute-only makespan: the sync tail runs concurrently with the
        # next iteration's compute; timing.iteration_time re-adds whatever
        # stall the k-step lag window cannot hide.
        t_total = max((t.end for t in sim._tasks
                       if not (t.tag and t.tag[0] == "AR")),
                      default=t_total)

    bwd_end = [max((bwd[(s, local[(s, r)][-1])].end
                    for r in range(spec.n_replicas[s]) if local[(s, r)]),
                   default=0.0)
               for s in range(P)]
    sync_end = [max((t.end for t in ar[s]), default=bwd_end[s])
                if s in ar else bwd_end[s] for s in range(P)]
    busy = {(s, r): c.fwd + c.bwd + 2 * ov + _worker_recv(spec, cfg, s, r)
            for (s, r), c in spec.cost.items()}
    return PipelineResult(
        t_total=t_total,
        t_pp=max(bwd_end) if bwd_end else 0.0,
        bwd_end=bwd_end, sync_end=sync_end,
        busy_per_micro=busy,
        period=_steady_period(spec, cfg),
        n_tasks=sim.n_tasks,
        timeline=sim.timeline() if cfg.record_timeline else None)


def interleaved_order(P: int, v: int, w: int, M: int
                      ) -> List[Tuple[str, int, int]]:
    """Megatron-style interleaved 1F1B op order for worker ``w``.

    Returns (kind, logical_stage, microbatch) tuples.  Microbatches are
    processed in groups of ``P``; chunk j of worker w is logical stage
    ``j * P + w``.  Warmup runs ``(P - w - 1) * 2 + (v - 1) * P`` forwards
    so every chunk fills before the first backward — this is the order
    whose flush bubble is ``(P - 1) * (f + b) / v``, the whole point of
    virtual stages.  Requires ``M % P == 0`` (Megatron's own constraint).
    """
    total = M * v

    def fwd_at(k: int) -> Tuple[int, int]:
        g, rem = divmod(k, P * v)
        chunk, mb = divmod(rem, P)
        return chunk * P + w, g * P + mb

    def bwd_at(k: int) -> Tuple[int, int]:
        g, rem = divmod(k, P * v)
        chunk, mb = divmod(rem, P)
        return (v - 1 - chunk) * P + w, g * P + mb

    warmup = min((P - w - 1) * 2 + (v - 1) * P, total)
    order: List[Tuple[str, int, int]] = []
    for k in range(warmup):
        order.append(("F",) + fwd_at(k))
    for k in range(total - warmup):
        order.append(("F",) + fwd_at(k + warmup))
        order.append(("B",) + bwd_at(k))
    for k in range(total - warmup, total):
        order.append(("B",) + bwd_at(k))
    return order


def run_interleaved(spec: PipelineSpec, cfg: EngineConfig) -> PipelineResult:
    """Interleaved virtual-stage schedule (uniform replica counts only).

    Every worker holds ``virtual_stages`` chunks of 1/v of its stage's
    layers, so the fill/drain bubble shrinks by the interleaving factor.
    Per-worker order is the static Megatron interleaved 1F1B when the
    per-chain microbatch count divides by P; otherwise a greedy
    earliest-start list scheduler (backwards preferred on ties) is used.
    Transfers always live on link resources (``overlap_comm=False`` has
    no interleaved analog and is ignored here).
    """
    if len(set(spec.n_replicas)) != 1:
        raise ValueError("interleaved schedule requires uniform dp per stage")
    v = max(cfg.virtual_stages, 1)
    P = spec.n_stages
    L = P * v
    D = spec.n_replicas[0]
    ov = cfg.per_task_overhead_s
    total = spec.total_micro
    sim = Sim()

    local: Dict[int, List[int]] = {r: [] for r in range(D)}
    for m in range(total):
        local[spec.assign(0, m)].append(m)
    counts = {len(ms) for ms in local.values() if ms}
    static = len(counts) == 1 and next(iter(counts)) % P == 0

    fwd: Dict[Tuple[int, int, int], _Task] = {}
    bwd: Dict[Tuple[int, int, int], _Task] = {}
    for r, ms in local.items():
        if not ms:
            continue
        workers = [sim.resource(("w", w, r), fifo=static) for w in range(P)]
        if static:
            for w in range(P):
                for kind, l, mi in interleaved_order(P, v, w, len(ms)):
                    m = ms[mi]
                    c = spec.cost[(w, r)]
                    if kind == "F":
                        t = sim.place(sim.task(c.fwd / v + ov,
                                               tag=("F", w, r, m)), workers[w])
                        fwd[(l, m, r)] = t
                    else:
                        t = sim.place(sim.task(c.bwd / v + ov,
                                               tag=("B", w, r, m)), workers[w])
                        bwd[(l, m, r)] = t
                        t.deps.append(fwd[(l, m, r)])
        else:
            for m in ms:
                for l in range(L):
                    w = l % P
                    c = spec.cost[(w, r)]
                    tf = sim.task(c.fwd / v + ov, prio=(1, m, l),
                                  tag=("F", w, r, m))
                    tb = sim.task(c.bwd / v + ov, prio=(0, m, L - 1 - l),
                                  tag=("B", w, r, m))
                    sim.place(tf, workers[w])
                    sim.place(tb, workers[w])
                    fwd[(l, m, r)] = tf
                    bwd[(l, m, r)] = tb
                    tb.deps.append(tf)
        for m in ms:
            for l in range(L):
                w = l % P
                if l > 0:
                    wa = (l - 1) % P
                    dur = spec.p2p(wa, w, r, r) + ov
                    x = sim.task(dur, tag=("PF", wa, r, r, m))
                    sim.place(x, sim.resource(("lf", l, r)))
                    x.deps.append(fwd[(l - 1, m, r)])
                    fwd[(l, m, r)].deps.append(x)
                if l < L - 1:
                    wb = (l + 1) % P
                    dur = spec.p2p(w, wb, r, r) + ov
                    x = sim.task(dur, tag=("PB", w, r, r, m))
                    sim.place(x, sim.resource(("lb", l, r)))
                    x.deps.append(bwd[(l + 1, m, r)])
                    bwd[(l, m, r)].deps.append(x)

    # DP sync after each worker's last backward chunk
    ar: Dict[int, List[_Task]] = {}
    for s in range(P):
        buckets = list(spec.sync[s])
        if not buckets:
            continue
        ring = sim.resource(("ring", s))
        deps = []
        for r, ms in local.items():
            if not ms:
                continue
            for l in range(L):
                if l % P == s:
                    deps.append(bwd[(l, ms[-1], r)])
        ar[s] = []
        for k, dur in enumerate(buckets):
            t = sim.task(dur, tag=("AR", s, k))
            t.deps.extend(deps)
            sim.place(t, ring)
            ar[s].append(t)

    upd: List[_Task] = []
    for r, ms in local.items():
        if not ms:
            continue
        for s in range(P):
            t = sim.task(spec.cost[(s, r)].upd + ov, prio=(2, total, s),
                         tag=("U", s, r))
            t.deps.extend(bwd[(l, ms[-1], r)] for l in range(L) if l % P == s)
            if s in ar and cfg.sync_lag == 0:
                t.deps.append(ar[s][-1])
            sim.place(t, sim.resource(("w", s, r), fifo=False))
            upd.append(t)

    if static:
        _chain_fifo_deps(sim)
    t_total = sim.run()
    if cfg.sync_lag > 0:
        t_total = max((t.end for t in sim._tasks
                       if not (t.tag and t.tag[0] == "AR")),
                      default=t_total)
    bwd_end = []
    for s in range(P):
        ends = [bwd[(l, ms[-1], r)].end for r, ms in local.items() if ms
                for l in range(L) if l % P == s]
        bwd_end.append(max(ends, default=0.0))
    sync_end = [max((t.end for t in ar[s]), default=bwd_end[s])
                if s in ar else bwd_end[s] for s in range(P)]
    busy = {(s, r): spec.cost[(s, r)].fwd + spec.cost[(s, r)].bwd + 2 * v * ov
            for s in range(P) for r in range(D)}
    return PipelineResult(
        t_total=t_total, t_pp=max(bwd_end) if bwd_end else 0.0,
        bwd_end=bwd_end, sync_end=sync_end, busy_per_micro=busy,
        period=_steady_period(spec, cfg), n_tasks=sim.n_tasks,
        timeline=sim.timeline() if cfg.record_timeline else None)


def run_pipeline(spec: PipelineSpec, cfg: EngineConfig = DEFAULT_ENGINE
                 ) -> PipelineResult:
    if cfg.schedule == "interleaved" and cfg.virtual_stages > 1:
        return run_interleaved(spec, cfg)
    return run_1f1b(spec, cfg)
