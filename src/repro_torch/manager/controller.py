"""The control loop: monitor -> replan -> transition -> ElasticTrainer.

This is the cluster manager of paper Fig. 4 (right): it owns a simulated
clock (``step_time_s`` feed-seconds per training step), polls the
availability monitor between steps, re-invokes the (warm-started) planner
on every event, prices the transition, and drives the trainer:

  * NodeFailure shrinking the job's device set  -> rollback (state lost)
  * CapacityDown shrinking it                   -> kill-free reshard
  * CapacityUp / PriceChange (optional gains)   -> hysteresis: the gain is
    held ``pending`` and only committed if it persists; a blip that
    reverts first is dropped without touching the job
  * Straggler flags from the trainer's detector -> replan (the paper's
    "slow worker" path), recorded in the decision log

Every decision is appended to ``controller.decisions`` so tests, examples
and benchmarks can audit exactly what the loop did and why.

The runtime here drives in-process meshes over the trainer's device
list (``train/elastic.py``: mesh positions may repeat one card), so
cluster sizes are mapped to a power-of-two device count (``_n_devices``)
and the planner's ``ParallelPlan`` is projected onto a flat dp x tp
``RuntimePlan`` (``fit_runtime_plan``); on a real deployment the same
decisions drive multi-host device sets instead.

A copy of ``repro/manager/controller.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.planner.objectives import Objective
from repro_torch.core.planner.plan import ParallelPlan, adaptive_plan
from repro_torch.core.planner.search import PlanResult, plan_fits
from repro_torch.core.profiler.analytic import DTYPE_BYTES
from repro_torch.core.simulator.simulate import simulate
from repro_torch.manager.events import (CapacityDown, CapacityUp, ClusterEvent,
                                  LinkDegraded, NodeFailure, PriceChange,
                                  Straggler)
from repro_torch.manager.monitor import AvailabilityMonitor
from repro_torch.manager.replan import IncrementalReplanner
from repro_torch.manager.transition import (DEFER, REBALANCE, RESHARD, ROLLBACK,
                                      ROUTE_AROUND, TransitionDecision,
                                      TransitionModel)
from repro_torch.train.elastic import ElasticTrainer, RuntimePlan


def fit_runtime_plan(n_devices: int, global_batch: int,
                     num_microbatches: int,
                     plan: Optional[ParallelPlan] = None) -> RuntimePlan:
    """Project a planner plan onto ``n_devices`` flat host devices: honor
    the plan's stage-0 TP preference where it divides the device count,
    give the rest to DP (clamped so DP divides the global batch)."""
    tp_pref = 1
    if plan is not None and plan.stages:
        tp_pref = max(r.tp for r in plan.stages[0].replicas)
    tp = 1
    while tp * 2 <= min(tp_pref, n_devices) and n_devices % (tp * 2) == 0:
        tp *= 2
    dp = n_devices // tp
    while dp > 1 and global_batch % dp:
        dp //= 2
    tp = n_devices // dp
    return RuntimePlan(n_devices=n_devices, dp=dp, tp=tp,
                       num_microbatches=num_microbatches)


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    step_time_s: float = 60.0       # feed-clock seconds per training step
    max_devices: int = 8            # runtime cap (host devices in the demo)
    replan_on_straggler: bool = True
    # objective used for PriceChange-triggered replans; None = default
    price_objective: Optional[Objective] = None
    # stream every decision to this JSONL file (same trace format as the
    # telemetry bus export — one control-plane format end to end)
    audit_path: Optional[str] = None
    # static plan auditor, e.g. ``repro_torch.analysis.plan_audit``:
    # callable (plan, cluster) -> Report.  When set, every replan target of an
    # *optional* transition is audited and error findings veto the move
    # (transition.decide(audit_failed=True) -> DEFER).  Mandatory moves
    # (shrinks, failures) are never vetoed.
    plan_auditor: Optional[Any] = None


class Controller:
    def __init__(self, trainer: ElasticTrainer,
                 monitor: AvailabilityMonitor,
                 replanner: IncrementalReplanner,
                 transition: Optional[TransitionModel] = None,
                 config: ControllerConfig = ControllerConfig()):
        self.trainer = trainer
        self.monitor = monitor
        self.replanner = replanner
        self.transition = transition or TransitionModel()
        self.config = config
        self.bus = monitor.bus
        self.sim_time = 0.0
        self.decisions: List[Dict[str, Any]] = []
        self.pending: Optional[Dict[str, Any]] = None        # capacity gain
        self.pending_price: Optional[Dict[str, Any]] = None  # price gain
        self._committed: Optional[PlanResult] = None
        self.audit = None               # JsonlWriter when audit_path set
        if config.audit_path:
            from repro_torch.telemetry.bus import JsonlWriter
            self.audit = JsonlWriter(config.audit_path)
        self.telemetry = None           # TelemetryBus (attach_telemetry)
        self.det_bank = None            # telemetry.DetectorBank
        self.rca = None                 # telemetry.RootCauseAnalyzer
        self._polling = False           # suppress subscriber re-entry
        self._tel_events: List[ClusterEvent] = []   # detector-sourced queue
        trainer.plan_fn = self._plan_fn

    # --- telemetry wiring -----------------------------------------------------
    def attach_telemetry(self, bus, det_cfg=None,
                         heartbeat_miss: int = 3) -> None:
        """Wire a :class:`~repro_torch.telemetry.bus.TelemetryBus` into the loop:
        the trainer emits runtime samples onto ``bus``, a ``DetectorBank``
        turns sustained deviations into typed events on the manager bus,
        and ``RootCauseAnalyzer`` verdicts steer the transition decision
        (``root_cause``) when those events are handled after each step."""
        from repro_torch.telemetry.detectors import DetectorBank, DetectorConfig
        from repro_torch.telemetry.rca import RootCauseAnalyzer
        self.telemetry = bus
        self.det_bank = DetectorBank(
            bus, self.bus, monitor=self.monitor,
            cfg=det_cfg or DetectorConfig(), heartbeat_miss=heartbeat_miss)
        self.rca = RootCauseAnalyzer(self.det_bank)
        self.trainer.telemetry = bus
        # sample/event timestamps on the sim clock, so detector events
        # interleave time-ordered with feed events on the manager bus
        self.trainer.clock = lambda: self.sim_time
        self.bus.subscribe(self._on_telemetry_event)

    def _on_telemetry_event(self, ev: ClusterEvent) -> None:
        """Bus subscriber: queue detector-sourced events for handling after
        the in-flight step completes (acting mid-step would reconfigure the
        trainer underneath its own loop).  Feed-sourced events arrive while
        ``run`` drains ``monitor.poll`` (``_polling``) and are handled
        there; ``_after_step`` stragglers carry a cluster snapshot —
        detector events don't, which is how we tell them apart."""
        if self._polling or self.rca is None:
            return
        detector_sourced = (
            isinstance(ev, NodeFailure) or
            (isinstance(ev, (LinkDegraded, Straggler))
             and ev.cluster is None))
        if detector_sourced:
            self._tel_events.append(ev)

    def _drain_telemetry_events(self) -> None:
        evs, self._tel_events = self._tel_events, []
        for ev in evs:
            if isinstance(ev, NodeFailure):
                # monitor.observe_failure already shrank the snapshot;
                # price the mandatory move like any feed-sourced failure
                self._handle(ev)
                continue
            verdict = self.rca.classify(ev)
            cluster = self.monitor.current
            res = self.replanner.replan(cluster)
            t_rb, vplan = self._rebalance_option(cluster, verdict)
            dec = self._decide(
                cluster, mandatory=False, state_lost=False,
                t_new=res.best.t_iter if res.best else None,
                root_cause=verdict.kind, res=res, t_rebalance=t_rb)
            if dec.kind == REBALANCE:
                self._commit_rebalance(ev, vplan, dec,
                                       root_cause=verdict.kind,
                                       remediation=verdict.remediation)
            elif dec.kind in (RESHARD, ROUTE_AROUND):
                self._commit(ev, cluster, self._n_devices(cluster), res,
                             dec, root_cause=verdict.kind)
            else:
                self._record(ev, dec.kind, dec.reason, res,
                             root_cause=verdict.kind,
                             remediation=verdict.remediation)
        if evs and self.det_bank is not None:
            # detections are episodic: whatever was decided, the baselines
            # that produced them are stale now — start the bank fresh
            self.det_bank.reset()

    # --- runtime mapping ------------------------------------------------------
    def _n_devices(self, cluster: ClusterSpec) -> int:
        n = max(1, min(self.config.max_devices, cluster.total_chips()))
        while n & (n - 1):              # power of two for clean meshes
            n -= 1
        return n

    def _plan_fn(self, n_devices: int) -> RuntimePlan:
        best = self._committed.best if self._committed else None
        return fit_runtime_plan(
            n_devices, self.trainer.data_cfg.global_batch,
            self.trainer.data_cfg.num_microbatches,
            best.plan if best else None)

    # --- transition-model inputs ---------------------------------------------
    def _state_bytes(self) -> float:
        profile = self.replanner.planner.profile
        params = profile.stage_params(0, profile.n_partition_units)
        return params * DTYPE_BYTES * 3      # params + Adam m, v

    def _reshard_link(self, cluster: ClusterSpec):
        best = self._committed.best if self._committed else None
        if best is None:
            return cluster.links["intra-zone"]
        zones = sorted({r.zone for s in best.plan.stages
                        for r in s.replicas})
        link = cluster.links["intra-zone"]
        for i, za in enumerate(zones):
            for zb in zones[i + 1:]:
                cand = cluster.link_between(za, zb)
                if cand.beta < link.beta:
                    link = cand
        return link

    def _audit_failed(self, cluster: ClusterSpec,
                      res: Optional[PlanResult]) -> bool:
        """Static audit of an optional replan target (config.plan_auditor);
        True (veto) when the auditor reports errors.  The report rides on
        ``res.stats["audit"]`` either way so the decision log can show
        what was found."""
        fn = self.config.plan_auditor
        if fn is None or res is None or res.best is None:
            return False
        report = fn(res.best.plan, cluster)
        res.stats["audit"] = report.to_dict()
        return not report.ok

    def _rebalance_option(self, cluster: ClusterSpec, verdict=None):
        """``(t_iter_rebalance_s, plan)`` for keeping the committed layout
        and re-proportioning per-replica microbatches — the cheap
        remediation the transition model prices below a full reshard —
        or ``(None, None)`` when no such option exists.

        With a ``slow-chip`` verdict the profile rates of every DP chain
        touching the degraded ``(zone, acc_type)`` pool are derated by the
        verdict factor before proportioning, and the projected time is the
        rebalanced degraded closed form scaled into the committed plan's
        (nominal) time units so ``decide`` compares like with like.
        Without a verdict (straggler path) the option is the nominal-rate
        adaptive variant, priced by the simulator — it only surfaces when
        the committed plan left static heterogeneity on the table."""
        best = self._committed.best if self._committed else None
        if best is None:
            return None, None
        plan = best.plan
        base = dataclasses.replace(plan, assignment=None) \
            if plan.assignment is not None else plan
        if base.dp < 2 or len({s.dp for s in base.stages}) != 1:
            return None, None
        planner = self.replanner.planner
        rates = planner.profile.chain_rates(base)
        if min(rates) <= 0.0:
            return None, None
        if verdict is not None:
            if verdict.kind != "slow-chip" or len(verdict.target) < 2 \
                    or not (verdict.factor > 1.0):
                return None, None
            zone, acc = verdict.target[0], verdict.target[1]
            derate = 1.0 / verdict.factor
            deg = [r * derate
                   if any(s.replicas[d].zone == zone
                          and s.replicas[d].gpu_type == acc
                          for s in base.stages) else r
                   for d, r in enumerate(rates)]
            if deg == rates:
                return None, None       # verdict pool not in this plan
            vplan = adaptive_plan(base, deg)
            if vplan is None or vplan.assignment == plan.assignment:
                return None, None
            # closed-form compute bound per chain: uniform ends with the
            # slowest chain, proportional is work-conserving
            per_chain = base.global_batch / base.dp
            t_old_deg = per_chain / min(deg)
            t_rb_deg = base.global_batch / sum(deg)
            if not t_old_deg > 0.0 or t_rb_deg >= t_old_deg:
                return None, None
            return best.t_iter * (t_rb_deg / t_old_deg), vplan
        vplan = adaptive_plan(base, rates)
        if vplan is None or vplan.assignment == plan.assignment:
            return None, None
        vres = simulate(planner.profile, vplan, cluster,
                        planner.mem_cfg, planner.engine_cfg)
        if not vres.valid:
            return None, None
        return vres.t_iter, vplan

    def _commit_rebalance(self, ev: Optional[ClusterEvent],
                          vplan: ParallelPlan, dec: TransitionDecision,
                          **extra) -> None:
        """Swap the committed plan for its rebalanced variant in place:
        same devices, same stages, new per-replica microbatch assignment.
        The committed ``t_iter`` is kept — it prices the layout on the
        nominal profile, which the rebalance does not change."""
        assert self._committed is not None and self._committed.best
        new_best = dataclasses.replace(self._committed.best, plan=vplan)
        self._committed = dataclasses.replace(self._committed,
                                              best=new_best)
        self._record(ev, dec.kind, dec.reason, self._committed,
                     rebalance=vplan.describe(), **extra)

    def _decide(self, cluster: ClusterSpec, *, mandatory: bool,
                state_lost: bool, t_new: Optional[float],
                t_old: Optional[float] = None,
                event_age_s: float = 0.0,
                root_cause: Optional[str] = None,
                res: Optional[PlanResult] = None,
                t_rebalance: Optional[float] = None) -> TransitionDecision:
        best = self._committed.best if self._committed else None
        t_iter_old = t_old if t_old is not None else \
            (best.t_iter if best else 1.0)
        movers = best.plan.n_chips if best else 1
        audit_failed = (not mandatory and not state_lost
                        and self._audit_failed(cluster, res))
        return self.transition.decide(
            mandatory=mandatory, state_lost=state_lost,
            state_bytes=self._state_bytes(),
            link=self._reshard_link(cluster), movers=movers,
            steps_since_ckpt=self.trainer.step % max(
                1, self.trainer.checkpoint_every),
            t_iter_old_s=t_iter_old, t_iter_new_s=t_new,
            event_age_s=event_age_s, root_cause=root_cause,
            audit_failed=audit_failed,
            t_iter_rebalance_s=t_rebalance)

    def _record(self, event: Optional[ClusterEvent], action: str,
                reason: str, result: Optional[PlanResult] = None,
                **extra) -> None:
        rec = {
            "time_s": self.sim_time, "step": self.trainer.step,
            "event": event.describe() if event else "-",
            "action": action, "reason": reason,
            "n_devices": self.trainer.plan.n_devices if self.trainer.plan
            else 0,
            "cache": result.stats.get("cache") if result else None,
            "search_ms": result.search_time_s * 1e3 if result else None,
            **extra}
        self.decisions.append(rec)
        if self.audit is not None:
            from repro_torch.telemetry.bus import wall_clock
            self.audit.write({"kind": "decision",
                              "wall_time_s": wall_clock(), **rec})

    # --- event handling -------------------------------------------------------
    def _handle(self, ev: ClusterEvent) -> None:
        cluster = ev.cluster if ev.cluster is not None \
            else self.monitor.current
        n_cur = self.trainer.plan.n_devices
        n_new = self._n_devices(cluster)

        if isinstance(ev, PriceChange):
            self._handle_price(ev, cluster)
            return
        if n_new == n_cur:
            best = self._committed.best if self._committed else None
            if best is not None and not plan_fits(best.plan, cluster):
                # same device count, but the committed plan sits on chips
                # that no longer exist — replan and reconfigure in place
                # (rollback if the dead chips held state).
                self.pending = None
                res = self.replanner.replan(cluster)
                dec = self._decide(
                    cluster, mandatory=True,
                    state_lost=isinstance(ev, NodeFailure),
                    t_new=res.best.t_iter if res.best else None)
                self._commit(ev, cluster, n_new, res, dec)
                return
            # the change doesn't move the runtime's device count; a pending
            # upscale whose extra capacity vanished is a blip — drop it.
            if self.pending is not None and isinstance(
                    ev, (CapacityDown, NodeFailure)):
                self._record(ev, DEFER, "capacity blip reverted; "
                             "pending upscale dropped", blip=True)
                self.pending = None
            else:
                self._record(ev, DEFER, "no change to runtime device count")
            return

        if n_new < n_cur:
            self.pending = None          # shrinks override any pending gain
            res = self.replanner.replan(cluster)
            state_lost = isinstance(ev, NodeFailure)
            dec = self._decide(cluster, mandatory=True,
                               state_lost=state_lost,
                               t_new=res.best.t_iter if res.best else None)
            self._commit(ev, cluster, n_new, res, dec)
            return

        # n_new > n_cur: optional upscale — gate through hysteresis
        res = self.replanner.replan(cluster)
        dec = self._decide(cluster, mandatory=False, state_lost=False,
                           t_new=res.best.t_iter if res.best else None,
                           event_age_s=0.0, res=res)
        if dec.kind == DEFER and "hysteresis" in dec.reason:
            if self.pending is None:
                self.pending = {"cluster": cluster, "n": n_new,
                                "since_s": ev.time_s, "result": res,
                                "metric": "time"}
            else:                        # still pending; refresh the target
                self.pending.update(cluster=cluster, n=n_new, result=res)
            self._record(ev, DEFER, dec.reason, res, pending=True)
        elif dec.kind == RESHARD:
            self._commit(ev, cluster, n_new, res, dec)
        else:
            self._record(ev, dec.kind, dec.reason, res)

    def _handle_price(self, ev: PriceChange, cluster: ClusterSpec) -> None:
        obj = self.config.price_objective
        res = self.replanner.replan(cluster, objective=obj)
        old = self._committed.best if self._committed else None
        if res.best is None or old is None:
            self._record(ev, DEFER, "no plan to compare", res)
            return
        # normalize $/iter onto the time-gain gate: relative cost ratio
        # plays the role of t_new / t_old (same hysteresis semantics).
        ratio = res.best.cost_per_iter / max(old.cost_per_iter, 1e-12)
        dec = self._decide(cluster, mandatory=False, state_lost=False,
                           t_new=ratio, t_old=1.0, event_age_s=0.0,
                           res=res)
        if dec.kind == DEFER and "hysteresis" in dec.reason:
            if self.pending_price is None:
                self.pending_price = {"cluster": cluster,
                                      "n": self._n_devices(cluster),
                                      "since_s": ev.time_s, "result": res,
                                      "metric": "cost"}
            else:                        # refresh target, keep the clock
                self.pending_price.update(cluster=cluster, result=res)
            self._record(ev, DEFER, dec.reason, res, pending=True)
        elif dec.kind == RESHARD:
            self._commit(ev, cluster, self._n_devices(cluster), res, dec)
        else:
            # the gain is gone (price reverted / no cheaper plan): a price
            # blip must not leave its discount-era pending behind
            if self.pending_price is not None:
                self._record(ev, DEFER, "price blip reverted; pending "
                             "min-cost reshard dropped", res, blip=True)
                self.pending_price = None
            else:
                self._record(ev, dec.kind, dec.reason, res)

    def _commit(self, ev: Optional[ClusterEvent], cluster: ClusterSpec,
                n_new: int, res: PlanResult,
                dec: TransitionDecision, **extra) -> None:
        self._committed = res
        # whatever gains were pending were computed against the state this
        # commit just replaced — stale, so drop them (fresh events re-open)
        self.pending = None
        self.pending_price = None
        self.trainer.on_availability_change(
            n_new, failure=dec.kind == ROLLBACK)
        self._record(ev, dec.kind, dec.reason, res,
                     transition_cost_s=dec.cost_s, **extra)

    def _commit_pending_if_due(self) -> None:
        for attr in ("pending", "pending_price"):
            p = getattr(self, attr)
            if p is None:
                continue
            age = self.sim_time - p["since_s"]
            if age < self.transition.cfg.hysteresis_s:
                continue
            # re-validate against the *present* state, not the snapshot
            # that opened the pending — prices/capacity may have moved
            # since (typically an exact-hit replan, so this is cheap).
            cluster = self.monitor.current
            res = self.replanner.replan(
                cluster, objective=(self.config.price_objective
                                    if p["metric"] == "cost" else None))
            if p["metric"] == "cost":
                old = self._committed.best if self._committed else None
                ratio = res.best.cost_per_iter / \
                    max(old.cost_per_iter, 1e-12) \
                    if (res.best and old) else None
                dec = self._decide(cluster, mandatory=False,
                                   state_lost=False, t_new=ratio,
                                   t_old=1.0, event_age_s=age, res=res)
            else:
                dec = self._decide(
                    cluster, mandatory=False, state_lost=False,
                    t_new=res.best.t_iter if res.best else None,
                    event_age_s=age, res=res)
            setattr(self, attr, None)
            if dec.kind == RESHARD:
                self._commit(None, cluster, self._n_devices(cluster), res,
                             dec)
            else:
                self._record(None, dec.kind, "pending gain no longer "
                             f"clears gates: {dec.reason}")

    # --- straggler path -------------------------------------------------------
    def _after_step(self) -> None:
        rec = self.trainer.log[-1]
        if not rec.get("straggler_flag"):
            return
        det = self.trainer.detector
        hist = det.times[:-1]            # history the flag was judged on
        median = float(np.median(hist)) if hist else 0.0
        ev = Straggler(time_s=self.sim_time, cluster=self.monitor.current,
                       step=rec["step"], t_step_s=rec["time_s"],
                       t_median_s=median)
        self.bus.publish(ev)
        if self.config.replan_on_straggler:
            cluster = self.monitor.current
            res = self.replanner.replan(cluster)
            # layout unchanged, but a microbatch rebalance may still pay:
            # t_new=None keeps decide() from proposing a reshard here —
            # the straggler carries no availability change to act on.
            t_rb, vplan = self._rebalance_option(cluster)
            dec = self._decide(cluster, mandatory=False, state_lost=False,
                               t_new=None, t_rebalance=t_rb)
            if dec.kind == REBALANCE:
                self._commit_rebalance(ev, vplan, dec, straggler=True)
            else:
                self._record(ev, DEFER, "straggler replan (plan unchanged: "
                             "slow step, same availability)", res,
                             straggler=True)

    # --- the loop -------------------------------------------------------------
    def start(self) -> None:
        """Initial plan + build on the monitor's starting availability."""
        cluster = self.monitor.current
        self._committed = self.replanner.replan(cluster)
        self.trainer.build(self._n_devices(cluster))
        self._record(None, "start", "initial plan", self._committed)

    def run(self, num_steps: int) -> List[Dict[str, Any]]:
        if self.trainer.mesh is None:
            self.start()
        for _ in range(num_steps):
            self._polling = True
            try:
                for ev in self.monitor.poll(self.sim_time):
                    self._handle(ev)
            finally:
                self._polling = False
            self._commit_pending_if_due()
            self.trainer.train(1)
            self._drain_telemetry_events()
            self._after_step()
            self.sim_time += self.config.step_time_s
        self.trainer.ckpt.wait()
        return self.trainer.log

    # --- audit helpers --------------------------------------------------------
    def outcomes(self) -> List[str]:
        return [d["action"] for d in self.decisions]

    def summary(self) -> str:
        lines = [f"{len(self.decisions)} decisions, "
                 f"replanner {self.replanner.stats}"]
        for d in self.decisions:
            ms = f" search {d['search_ms']:.0f}ms ({d['cache']})" \
                if d.get("search_ms") is not None else ""
            lines.append(f"  t={d['time_s']:5.0f}s step {d['step']:3d} "
                         f"{d['event']}: {d['action']} — {d['reason']}{ms}")
        return "\n".join(lines)
