"""Deterministic fault injection + the closed-loop chaos harness.

Injected faults perturb a *simulated world*: the event engine re-times the
committed plan every step under seeded lognormal noise plus whatever
faults are active, and the tagged task timeline is converted into the
exact telemetry samples the real ``dist.MPMDPipeline`` emits — so the
monitor -> detect -> RCA -> replan loop is exercised end-to-end against
known ground truth, deterministically (same seed, same bytes).

Fault taxonomy (``FaultSpec.kind``):

  ============== ======================== ============================
  kind           target                   detected as / remediation
  ============== ======================== ============================
  compute_delay  (zone, acc_type) pool    Straggler -> slow-chip ->
                                          route-around (replan w/o pool)
  link_degrade   (zone, zone_b) pair      LinkDegraded -> slow-link ->
                                          route-around (replan with the
                                          degraded link model)
  worker_hang    (zone, acc_type) pool    missed heartbeats ->
                                          NodeFailure -> rollback+replan
  data_stall     global input pipeline    step_time up, compute/p2p
                                          flat -> data-stall -> defer
  ============== ======================== ============================

:class:`ChaosHarness` runs one fault through the full loop and reports
whether the achieved post-remediation step time converged within a
bounded factor of the *fault-aware optimum* — what the planner would pick
if it were told about the fault up front.  ``benchmarks/chaos_suite.py``
gates this for every fault class.

A copy of ``repro/telemetry/faults.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import statistics
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.objectives import MAX_THROUGHPUT, Objective
from repro_torch.core.planner.plan import ParallelPlan
from repro_torch.core.profiler.analytic import DTYPE_BYTES, JobProfile, TrainJob
from repro_torch.core.simulator import engine as eng
from repro_torch.core.simulator import memory as mem_mod
from repro_torch.core.simulator import timing
from repro_torch.manager.events import EventBus, NodeFailure
from repro_torch.manager.monitor import AvailabilityMonitor
from repro_torch.manager.replan import IncrementalReplanner
from repro_torch.manager.transition import TransitionModel
from repro_torch.telemetry.bus import Sample, TelemetryBus
from repro_torch.telemetry.detectors import DetectorBank, DetectorConfig
from repro_torch.telemetry import rca as rca_mod

FAULT_KINDS = ("compute_delay", "link_degrade", "worker_hang", "data_stall")

# fault kind -> RCA verdict the loop must reach (chaos ground truth)
EXPECTED_VERDICT = {
    "compute_delay": rca_mod.SLOW_CHIP,
    "link_degrade": rca_mod.SLOW_LINK,
    "worker_hang": rca_mod.NODE_FAILURE,
    "data_stall": rca_mod.DATA_STALL,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injected fault, active on ``[start_step, start_step + duration)``
    (``duration <= 0`` = forever).  ``factor`` is the slowdown multiplier
    for compute/link faults and, for ``data_stall``, the stall length as a
    fraction of the fault-free step time."""
    kind: str
    zone: str = ""               # pool zone (compute_delay / worker_hang)
    acc_type: str = ""           # pool type (compute_delay / worker_hang)
    zone_b: str = ""             # far end of the link (link_degrade)
    start_step: int = 0
    duration: int = 0
    factor: float = 2.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")

    def active(self, step: int) -> bool:
        if step < self.start_step:
            return False
        return self.duration <= 0 or step < self.start_step + self.duration

    def describe(self) -> str:
        tgt = {"compute_delay": f"{self.zone}/{self.acc_type}",
               "worker_hang": f"{self.zone}/{self.acc_type}",
               "link_degrade": f"{self.zone}<->{self.zone_b}",
               "data_stall": "input"}[self.kind]
        return f"{self.kind}@{tgt} x{self.factor} from step {self.start_step}"


class FaultInjector:
    """Seeded noise + fault activation queries, shared by the simulated
    world and (via sleep-based delays) the real pipeline instrumentation.

    Every noise draw is keyed by ``(seed, step, stream)`` so a run is
    byte-reproducible regardless of evaluation order.
    """

    def __init__(self, faults: Sequence[FaultSpec] = (), seed: int = 0,
                 noise_frac: float = 0.04):
        self.faults = list(faults)
        self.seed = int(seed)
        self.noise_frac = float(noise_frac)

    # --- seeded noise ---------------------------------------------------------
    def noise(self, step: int, stream: Tuple) -> float:
        """Lognormal multiplier (mean ~1) for one stream at one step."""
        if self.noise_frac <= 0:
            return 1.0
        tag = zlib.crc32(repr(stream).encode())
        rng = np.random.default_rng([self.seed, step, tag])
        return float(np.exp(rng.normal(0.0, self.noise_frac)))

    # --- activation queries ---------------------------------------------------
    def _active(self, step: int, kind: str) -> List[FaultSpec]:
        return [f for f in self.faults if f.kind == kind and f.active(step)]

    def compute_factor(self, step: int, zone: str, acc_type: str) -> float:
        out = 1.0
        for f in self._active(step, "compute_delay"):
            if f.zone == zone and f.acc_type == acc_type:
                out *= f.factor
        return out

    def link_factor(self, step: int, zone_a: str, zone_b: str) -> float:
        out = 1.0
        for f in self._active(step, "link_degrade"):
            if {f.zone, f.zone_b} == {zone_a, zone_b}:
                out *= f.factor
        return out

    def hung(self, step: int, zone: str, acc_type: str) -> bool:
        return any(f.zone == zone and f.acc_type == acc_type
                   for f in self._active(step, "worker_hang"))

    def stall_s(self, step: int, base_iter_s: float) -> float:
        return sum(f.factor * base_iter_s
                   for f in self._active(step, "data_stall"))

    def compute_delay_s(self, step: int, zone: str, acc_type: str,
                        base_s: float) -> float:
        """Extra seconds a real worker should sleep (pipeline injection)."""
        return base_s * (self.compute_factor(step, zone, acc_type) - 1.0)


def degrade_link(cluster: ClusterSpec, zone_a: str, zone_b: str,
                 factor: float) -> ClusterSpec:
    """Cluster with the link *class* between two zones degraded by
    ``factor`` (bandwidth divided, latency multiplied) — the fault-aware
    world model handed to the planner when routing around a slow link."""
    link = cluster.link_between(zone_a, zone_b)
    slow = dataclasses.replace(link, alpha=link.alpha * factor,
                               beta=link.beta / factor)
    links = dict(cluster.links)
    for name, spec in links.items():
        if spec.name == link.name:
            links[name] = slow
    return dataclasses.replace(cluster, links=links)


class SimulatedWorld:
    """Steps one plan through the event engine under noise + faults and
    emits the resulting telemetry onto a bus.

    Every step rebuilds the engine spec with the injector's perturbations
    (per-stream noise, active fault factors), runs it with
    ``record_timeline=True`` and converts the tagged task timeline into
    the shared :class:`~repro_torch.telemetry.bus.Sample` schema — fwd/bwd per
    worker, p2p per boundary channel, sync per stage, plus heartbeats
    (suppressed for hung pools), HBM headroom, step time and data-stall
    seconds.  The cluster passed here is the *physical* world; remediated
    planner views never change the physics, only the plan.
    """

    def __init__(self, profile: JobProfile, plan: ParallelPlan,
                 cluster: ClusterSpec, bus: TelemetryBus,
                 injector: FaultInjector,
                 engine_cfg: Optional[eng.EngineConfig] = None):
        self.profile = profile
        self.cluster = cluster
        self.bus = bus
        self.injector = injector
        self.cfg = dataclasses.replace(engine_cfg or eng.DEFAULT_ENGINE,
                                       record_timeline=True)
        self.step_i = 0
        self.time_s = 0.0
        self.set_plan(plan)

    # --- plan adoption --------------------------------------------------------
    def set_plan(self, plan: ParallelPlan) -> None:
        self.plan = plan
        self._uniform = len({st.dp for st in plan.stages}) == 1
        if self._uniform:
            spec, reps, M, m_eff = timing._engine_spec_uniform(
                self.profile, plan, self.cluster, self.cfg)
            self.chain_of = [timing._chain_replicas(plan, d) for d in reps]
            self._m_extra = M - m_eff
        else:
            spec, total, total_eff = timing._engine_spec_uneven(
                self.profile, plan, self.cluster, self.cfg)
            self.chain_of = None
            self._m_extra = total - total_eff
        self.base_spec = spec
        mem = mem_mod.plan_memory(self.profile, plan, mem_mod.DEFAULT_MEM)
        self._headroom = {
            (s, r): (row["usable"] - row["peak"])
            for s in range(spec.n_stages)
            for r in range(spec.n_replicas[s])
            for row in [mem[s][self._rep_idx(s, r)]]}
        # chips the plan places in each (zone, type) pool — the heartbeat
        # meta a NodeFailure needs to shrink the availability snapshot
        self._pool_chips: Dict[Tuple[str, str], int] = {}
        for st in plan.stages:
            for rep in st.replicas:
                key = (rep.zone, rep.gpu_type)
                self._pool_chips[key] = self._pool_chips.get(key, 0) + rep.tp

    def _rep_idx(self, s: int, r: int) -> int:
        return self.chain_of[r][s] if self.chain_of is not None else r

    def _rep(self, s: int, r: int):
        return self.plan.stages[s].replicas[self._rep_idx(s, r)]

    # --- one step -------------------------------------------------------------
    def step(self) -> float:
        """Advance one training step; returns its wall seconds."""
        step, inj = self.step_i, self.injector
        cost = {}
        for (s, r), wc in self.base_spec.cost.items():
            rep = self._rep(s, r)
            f = inj.compute_factor(step, rep.zone, rep.gpu_type)
            cost[(s, r)] = eng.WorkerCost(
                wc.fwd * f * inj.noise(step, ("F", s, r)),
                wc.bwd * f * inj.noise(step, ("B", s, r)), wc.upd)
        base_p2p = self.base_spec.p2p

        def p2p(sa: int, sb: int, ra: int, rb: int) -> float:
            za, zb = self._rep(sa, ra).zone, self._rep(sb, rb).zone
            return (base_p2p(sa, sb, ra, rb)
                    * inj.link_factor(step, za, zb)
                    * inj.noise(step, ("P", sa, sb, ra, rb)))

        spec = dataclasses.replace(self.base_spec, cost=cost, p2p=p2p)
        res = eng.run_pipeline(spec, self.cfg)
        period = res.period if self._uniform \
            else timing._uneven_period(spec, self.cfg)
        t_iter = res.t_total + max(self._m_extra, 0) * period
        stall = inj.stall_s(step, t_iter)
        t_step = t_iter + stall
        t_end = self.time_s + t_step
        self._emit(step, t_end, res, stall, t_step)
        self.bus.end_step(step, t_end)
        self.time_s = t_end
        self.step_i += 1
        return t_step

    def run(self, n: int) -> List[float]:
        return [self.step() for _ in range(n)]

    # --- timeline -> samples --------------------------------------------------
    def _emit(self, step: int, t: float, res: eng.PipelineResult,
              stall: float, t_step: float) -> None:
        emit = self.bus.emit
        for tag, start, end in res.timeline or ():
            kind = tag[0]
            if kind in ("F", "B"):
                _, s, r, _m = tag
                rep = self._rep(s, r)
                emit(Sample("fwd_time" if kind == "F" else "bwd_time",
                            (s, r), t, step, end - start,
                            {"zone": rep.zone, "acc_type": rep.gpu_type}))
            elif kind in ("PF", "PB"):
                _, s, ra, rb, _m = tag
                sb = min(s + 1, self.plan.pp - 1)
                emit(Sample("p2p_time", (s, sb, ra, rb), t, step,
                            end - start,
                            {"zone": self._rep(s, ra).zone,
                             "zone_b": self._rep(sb, rb).zone}))
            elif kind == "AR":
                emit(Sample("sync_time", (tag[1],), t, step, end - start))
        for (s, r) in sorted(self.base_spec.cost):
            rep = self._rep(s, r)
            pool = (rep.zone, rep.gpu_type)
            if not self.injector.hung(step, rep.zone, rep.gpu_type):
                emit(Sample("heartbeat", (s, r), t, step, 1.0,
                            {"zone": rep.zone, "acc_type": rep.gpu_type,
                             "chips": self._pool_chips[pool]}))
            emit(Sample("hbm_headroom", (s, r), t, step,
                        self._headroom[(s, r)],
                        {"zone": rep.zone, "acc_type": rep.gpu_type}))
        emit(Sample("data_stall", (), t, step, stall))
        emit(Sample("step_time", (), t, step, t_step))


# --- the closed loop ----------------------------------------------------------

@dataclasses.dataclass
class ChaosReport:
    """What one chaos run did, for gating and the README table."""
    fault: Optional[FaultSpec]
    detected_step: Optional[int]      # step of the first detector event
    detect_delay: Optional[int]       # steps from fault start to detection
    event: str                        # describe() of the triggering event
    verdict: Optional[rca_mod.RootCause]
    decision: str                     # transition kind ("-" = none taken)
    baseline_s: float                 # fault-free planner optimum t_iter
    achieved_s: float                 # median step time post-remediation
    oracle_s: float                   # fault-aware optimum under the fault
    n_events: int                     # total manager events raised
    steps: int

    @property
    def ratio(self) -> float:
        return self.achieved_s / max(self.oracle_s, 1e-12)

    @property
    def verdict_kind(self) -> str:
        return self.verdict.kind if self.verdict else "-"

    def row(self) -> Dict:
        return {"fault": self.fault.describe() if self.fault else "clean",
                "detected_step": self.detected_step,
                "detect_delay": self.detect_delay,
                "verdict": self.verdict_kind, "decision": self.decision,
                "baseline_s": self.baseline_s, "achieved_s": self.achieved_s,
                "oracle_s": self.oracle_s, "ratio": self.ratio,
                "n_events": self.n_events}


class ChaosHarness:
    """monitor -> detect -> RCA -> replan, end to end, under one fault.

    The loop mirrors ``manager.Controller``'s event handling but drives
    the simulated world instead of host devices, so it runs anywhere the
    planner runs: detectors watch the telemetry bus, the first manager
    event is root-caused, the verdict picks the remediation from
    :data:`~repro_torch.telemetry.rca.REMEDIATION` (threaded into
    ``TransitionModel.decide`` via ``root_cause=``), the replanner is
    re-invoked on the remediated *view* of the cluster, and the world
    adopts the new plan — while the fault stays physically active, so a
    wrong remediation shows up as a bad convergence ratio.
    """

    def __init__(self, job: TrainJob, cluster: ClusterSpec,
                 fault: Optional[FaultSpec] = None, *, seed: int = 0,
                 objective: Optional[Objective] = None,
                 noise_frac: float = 0.04, max_steps: int = 40,
                 settle_steps: int = 6,
                 det_cfg: Optional[DetectorConfig] = None,
                 heartbeat_miss: int = 3,
                 engine_cfg: Optional[eng.EngineConfig] = None):
        self.job = job
        self.cluster = cluster
        self.fault = fault
        self.seed = seed
        self.noise_frac = noise_frac
        self.max_steps = max_steps
        self.settle_steps = settle_steps
        self.det_cfg = det_cfg or DetectorConfig()
        self.heartbeat_miss = heartbeat_miss
        self.engine_cfg = engine_cfg
        self.replanner = IncrementalReplanner(
            job, objective or Objective(MAX_THROUGHPUT))
        self.transition = TransitionModel()
        self.decisions: List[Dict] = []

    # --- remediation ----------------------------------------------------------
    def _decide(self, verdict: rca_mod.RootCause, t_old: float,
                t_new: Optional[float], state_lost: bool):
        profile = self.replanner.planner.profile
        state = profile.stage_params(0, profile.n_partition_units) \
            * DTYPE_BYTES * 3
        return self.transition.decide(
            mandatory=state_lost, state_lost=state_lost,
            state_bytes=state, link=self.cluster.links["intra-zone"],
            movers=4, steps_since_ckpt=2, t_iter_old_s=t_old,
            t_iter_new_s=t_new, root_cause=verdict.kind)

    def _planner_view(self, verdict: rca_mod.RootCause, event,
                      world: SimulatedWorld,
                      monitor: AvailabilityMonitor) -> Optional[ClusterSpec]:
        """The remediated cluster handed to the replanner (None = keep)."""
        kind = verdict.kind
        if kind == rca_mod.NODE_FAILURE:
            # observe_failure already shrank the snapshot by the dead
            # chips; drain the rest of the pool too — a pool that hangs
            # is unhealthy, and replanning back into it would re-hang.
            zone = getattr(event, "zone", "")
            acc = getattr(event, "acc_type", "")
            if zone and acc:
                return monitor.current.with_capacity({(zone, acc): 0})
            return monitor.current
        if kind == rca_mod.SLOW_CHIP:
            s, r = verdict.target if len(verdict.target) == 2 else (0, 0)
            rep = world._rep(s, r)
            return self.cluster.with_capacity(
                {(rep.zone, rep.gpu_type): 0})
        if kind == rca_mod.SLOW_LINK:
            za = getattr(event, "zone_a", "") or verdict.evidence.get(
                "link_at", ("", "", 0, 0))[0]
            zb = getattr(event, "zone_b", "")
            if not (za and zb):
                return None
            return degrade_link(self.cluster, za, zb,
                                max(verdict.factor, 1.0))
        return None                     # data-stall / unknown: defer

    def _oracle(self, view: Optional[ClusterSpec],
                baseline_plan: ParallelPlan, injector: FaultInjector,
                measure_from: int) -> float:
        """Median step time of the fault-aware optimum *under the fault*:
        replan on the remediated view (the plan an oracle that knew about
        the fault would pick), then time it in a fresh world with the
        same injector over the same step indices as the achieved
        measurement window."""
        plan = baseline_plan
        if view is not None:
            res = self.replanner.replan(view)
            if res.best is not None:
                plan = res.best.plan
        bus = TelemetryBus(capacity=8)
        world = SimulatedWorld(self.replanner.planner.profile, plan,
                               self.cluster, bus, injector, self.engine_cfg)
        world.step_i = measure_from
        return statistics.median(world.run(self.settle_steps))

    # --- the run --------------------------------------------------------------
    def run(self) -> ChaosReport:
        profile = self.replanner.planner.profile
        res0 = self.replanner.replan(self.cluster)
        if res0.best is None:
            raise RuntimeError("no feasible baseline plan for chaos run")
        plan = res0.best.plan
        baseline_s = res0.best.t_iter

        bus = TelemetryBus()
        events = EventBus()
        monitor = AvailabilityMonitor(self.cluster, feeds=[], bus=events)
        bank = DetectorBank(bus, events, monitor=monitor, cfg=self.det_cfg,
                            heartbeat_miss=self.heartbeat_miss)
        analyzer = rca_mod.RootCauseAnalyzer(bank)
        injector = FaultInjector([self.fault] if self.fault else [],
                                 self.seed, self.noise_frac)
        world = SimulatedWorld(profile, plan, self.cluster, bus, injector,
                               self.engine_cfg)

        detected = verdict = None
        decision_kind = "-"
        event_desc = "-"
        remediation_view: Optional[ClusterSpec] = None
        seen = 0
        times: List[float] = []
        for _ in range(self.max_steps):
            times.append(world.step())
            new = events.log[seen:]
            seen = len(events.log)
            if new and verdict is None:
                ev = new[0]
                detected = world.step_i - 1
                event_desc = ev.describe()
                verdict = analyzer.classify(ev)
                t_old = statistics.median(times[-3:])
                view = self._planner_view(verdict, ev, world, monitor)
                remediation_view = view
                res = self.replanner.replan(view) if view is not None \
                    else None
                t_new = res.best.t_iter if res and res.best else None
                dec = self._decide(
                    verdict, t_old, t_new,
                    state_lost=isinstance(ev, NodeFailure))
                decision_kind = dec.kind
                self.decisions.append({
                    "step": detected, "event": event_desc,
                    "verdict": verdict.describe(), "action": dec.kind,
                    "reason": dec.reason})
                if res is not None and res.best is not None and \
                        dec.kind != "defer":
                    world.set_plan(res.best.plan)
                bank.reset()

        achieved = statistics.median(times[-self.settle_steps:])
        measure_from = self.max_steps - self.settle_steps
        oracle = self._oracle(remediation_view, plan, injector, measure_from)
        delay = detected - self.fault.start_step \
            if detected is not None and self.fault is not None else None
        return ChaosReport(
            fault=self.fault, detected_step=detected, detect_delay=delay,
            event=event_desc, verdict=verdict, decision=decision_kind,
            baseline_s=baseline_s, achieved_s=achieved, oracle_s=oracle,
            n_events=len(events.log), steps=self.max_steps)
