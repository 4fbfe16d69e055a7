"""Plan-transition cost model: reshard vs rollback vs defer (paper §4.4).

When the planner proposes a new plan, switching to it is not free.  The
controller weighs three outcomes:

* **reshard** (kill-free): live params + optimizer state are re-laid-out
  onto the new device set.  Cost = bytes moved over the interconnect
  (alpha-beta model from ``simulator.network``, parallel over the movers)
  plus communicator teardown/re-setup.
* **rollback**: devices died with state on them — restore the latest async
  checkpoint and replay the steps since.  Cost = restore read + setup +
  lost work.
* **defer**: do nothing (yet).  Optional improvements (capacity grew, a
  price moved) must clear two hysteresis gates before the job reconfigures,
  so a 30-second capacity blip never thrashes it: the projected gain over
  ``commit_horizon_s`` must exceed the transition cost by
  ``min_gain_frac``, and the new state must persist for ``hysteresis_s``
  (the controller re-checks persistence; this model only prices and
  gates).

Mandatory shrinks (the chips are going away) are never deferred: the only
question is whether state survives (reshard) or not (rollback).

A copy of ``repro/manager/transition.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.profiler.hw_specs import LinkSpec
from repro_torch.core.simulator import network

RESHARD = "reshard"
ROLLBACK = "rollback"
DEFER = "defer"
ROUTE_AROUND = "route-around"   # reshard variant: move off a slow pool/link
REBALANCE = "rebalance"         # keep the layout, reassign microbatches


@dataclasses.dataclass(frozen=True)
class TransitionConfig:
    comm_setup_s: float = 2.0       # communicator teardown + re-init
    restore_bw: float = 1e9         # checkpoint restore read, bytes/s
    hysteresis_s: float = 120.0     # optional changes must persist this long
    min_gain_frac: float = 0.05     # and beat cost by this margin
    commit_horizon_s: float = 1800.0  # window the gain is amortized over
    rebalance_cost_s: float = 5.0   # drain in-flight micros + swap loaders:
    # no state moves and no communicator rebuild, so a per-replica
    # microbatch reassignment is priced at a small flat drain cost


@dataclasses.dataclass(frozen=True)
class TransitionDecision:
    kind: str                       # RESHARD | ROLLBACK | DEFER
    cost_s: float                   # price of the chosen outcome
    reason: str
    details: Dict = dataclasses.field(default_factory=dict)


class TransitionModel:
    def __init__(self, cfg: TransitionConfig = TransitionConfig()):
        self.cfg = cfg

    # --- costs ----------------------------------------------------------------
    def reshard_cost_s(self, state_bytes: float, link: LinkSpec,
                       movers: int = 1) -> float:
        """Kill-free re-layout: every byte of live state crosses ``link``
        once (upper bound — overlap between old and new shardings only
        lowers this), split across ``movers`` parallel senders."""
        per_mover = state_bytes / max(1, movers)
        return network.p2p_time(link, per_mover) + self.cfg.comm_setup_s

    def rollback_cost_s(self, state_bytes: float, steps_since_ckpt: int,
                        t_iter_s: float) -> float:
        """Restore + replay: read the checkpoint, rebuild communicators,
        redo every step since the last save."""
        restore = state_bytes / self.cfg.restore_bw
        lost_work = max(0, steps_since_ckpt) * t_iter_s
        return restore + self.cfg.comm_setup_s + lost_work

    # --- decision -------------------------------------------------------------
    def decide(self, *, mandatory: bool, state_lost: bool,
               state_bytes: float, link: LinkSpec, movers: int,
               steps_since_ckpt: int, t_iter_old_s: float,
               t_iter_new_s: Optional[float],
               event_age_s: float = 0.0,
               root_cause: Optional[str] = None,
               audit_failed: bool = False,
               t_iter_rebalance_s: Optional[float] = None
               ) -> TransitionDecision:
        """Pick the cheapest sound outcome for one proposed transition.

        ``mandatory``: capacity shrank below what the job runs on.
        ``state_lost``: the shrink took devices holding live state.
        ``t_iter_new_s``: simulated iteration time under the new plan
        (None when the replanner found nothing — with spare capacity gone
        the job just continues as-is unless the move is mandatory).
        ``event_age_s``: how long the triggering state has persisted.
        ``root_cause``: RCA verdict kind (``telemetry.rca``), when the
        transition was triggered by a telemetry detector rather than an
        availability feed.  A ``data-stall`` verdict defers outright —
        reconfiguring the job cannot feed the input pipeline faster — and
        a ``slow-chip``/``slow-link`` verdict returns ``ROUTE_AROUND``
        with the persistence gate waived: the detector's own persistence
        + cooldown already established that the degradation is sustained.
        ``audit_failed``: the static audit (not ported) of the
        replan target reported errors.  An *optional* move onto a plan
        whose program the simulator provably mispriced is vetoed (DEFER)
        — its projected gain can't be trusted.  Mandatory moves and
        rollbacks still proceed: a broken-but-running layout beats no
        capacity at all, and the veto is recorded for the operator.
        ``t_iter_rebalance_s``: simulated iteration time if the job keeps
        its layout and only re-proportions per-replica microbatches
        (``plan.adaptive_plan`` from measured rates).  No state moves and
        no communicators rebuild, so it is priced at the flat
        ``rebalance_cost_s`` and waives the hysteresis gate (trivially
        reverted).  It wins over a full reshard whenever its net
        amortized gain is at least as large.
        """
        reshard = self.reshard_cost_s(state_bytes, link, movers)
        details = {"reshard_cost_s": reshard}
        if root_cause is not None:
            details["root_cause"] = root_cause
        if root_cause == "data-stall":
            return TransitionDecision(
                DEFER, 0.0,
                "data stall: reconfiguration cannot help the input pipeline",
                details)
        if state_lost:
            cost = self.rollback_cost_s(state_bytes, steps_since_ckpt,
                                        t_iter_old_s)
            return TransitionDecision(
                ROLLBACK, cost, "state lost with failed devices",
                {**details, "lost_steps": steps_since_ckpt})
        if mandatory:
            return TransitionDecision(
                RESHARD, reshard, "capacity below current plan; state intact",
                details)
        # price the layout-preserving rebalance (if the caller simulated
        # one): same stages, same devices, only the per-replica microbatch
        # assignment changes.
        rb_net: Optional[float] = None
        rb_gain = 0.0
        if t_iter_rebalance_s is not None \
                and t_iter_rebalance_s < t_iter_old_s:
            rb_gain = (t_iter_old_s - t_iter_rebalance_s) / t_iter_old_s \
                * self.cfg.commit_horizon_s
            if rb_gain >= self.cfg.rebalance_cost_s \
                    * (1.0 + self.cfg.min_gain_frac):
                rb_net = rb_gain - self.cfg.rebalance_cost_s
                details.update(rebalance_gain_s=rb_gain,
                               rebalance_cost_s=self.cfg.rebalance_cost_s,
                               t_rebalance=t_iter_rebalance_s)
        if audit_failed:
            if rb_net is not None:
                return TransitionDecision(
                    REBALANCE, self.cfg.rebalance_cost_s,
                    "replan target failed static audit; rebalancing "
                    "microbatches on the current layout instead",
                    {**details, "audit_failed": True})
            return TransitionDecision(
                DEFER, 0.0,
                "replan target failed static audit; optional move vetoed",
                {**details, "audit_failed": True})
        if t_iter_new_s is None or t_iter_new_s >= t_iter_old_s:
            if rb_net is not None:
                return TransitionDecision(
                    REBALANCE, self.cfg.rebalance_cost_s,
                    f"no faster layout, but microbatch rebalance gains "
                    f"{rb_gain:.1f}s over horizon for "
                    f"{self.cfg.rebalance_cost_s:.1f}s",
                    details)
            return TransitionDecision(
                DEFER, 0.0, "no faster plan available", details)
        # optional improvement: amortized gain vs transition cost ...
        gain = (t_iter_old_s - t_iter_new_s) / t_iter_old_s \
            * self.cfg.commit_horizon_s
        details.update(gain_s=gain, t_old=t_iter_old_s, t_new=t_iter_new_s)
        if rb_net is not None and rb_net >= gain - reshard:
            return TransitionDecision(
                REBALANCE, self.cfg.rebalance_cost_s,
                f"rebalance net gain {rb_net:.1f}s >= reshard net "
                f"{gain - reshard:.1f}s: keeping the layout",
                details)
        if gain < reshard * (1.0 + self.cfg.min_gain_frac):
            return TransitionDecision(
                DEFER, 0.0,
                f"gain {gain:.1f}s over horizon < reshard {reshard:.1f}s",
                details)
        if root_cause in ("slow-chip", "slow-link"):
            return TransitionDecision(
                ROUTE_AROUND, reshard,
                f"{root_cause}: route around the degraded "
                f"{'pool' if root_cause == 'slow-chip' else 'link'} "
                f"(gain {gain:.1f}s over horizon clears reshard "
                f"{reshard:.1f}s; detector persistence waives hysteresis)",
                details)
        # ... and the persistence gate (anti-thrash)
        if event_age_s < self.cfg.hysteresis_s:
            return TransitionDecision(
                DEFER, 0.0,
                f"within hysteresis window ({event_age_s:.0f}s "
                f"< {self.cfg.hysteresis_s:.0f}s)", details)
        return TransitionDecision(
            RESHARD, reshard,
            f"gain {gain:.1f}s over horizon clears reshard {reshard:.1f}s",
            details)
