"""Online detectors: noisy telemetry streams -> typed manager events.

Replaces the trainer's single-stream ``StragglerDetector`` factor test for
control-plane purposes: every stream gets a robust-statistics state
machine (rolling median/MAD baseline, warmup, persistence, hysteresis
release, cooldown) so a single-sample spike never raises an event while a
sustained degradation always does — the properties the chaos suite pins.

Detector state machine per stream::

    healthy --[deviation > k*MAD and > min_rel*median,
               persist consecutive samples]--> degraded (emit anomaly)
    degraded --[value < release_rel*baseline, persist samples]--> healthy
    (baseline frozen while degraded; cooldown samples after release
     before the stream may fire again)

The MAD is floored at ``mad_floor_frac * median`` so a freakishly quiet
warmup window cannot make the detector hypersensitive, and anomalous
samples never enter the baseline window (a slow worker must not drag its
own baseline up — the bug class the old detector's history slice had).

:class:`DetectorBank` wires streams to events: per-worker compute streams
-> ``Straggler``, per-boundary ``p2p_time`` -> ``LinkDegraded``, missed
heartbeats -> ``NodeFailure`` (routed through
``AvailabilityMonitor.observe_failure`` when a monitor is attached, so
the control plane's cluster snapshot shrinks with the failure).

A copy of ``repro/telemetry/detectors.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.manager.events import (EventBus, LinkDegraded, NodeFailure,
                                  Straggler)
from repro_torch.telemetry.bus import Sample, TelemetryBus

HEALTHY, SUSPECT, DEGRADED = "healthy", "suspect", "degraded"


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    window: int = 64          # baseline ring size
    warmup: int = 12          # healthy samples required before judging
    k_mad: float = 6.0        # deviation threshold in (scaled) MADs
    min_rel: float = 1.35     # and at least this factor over the median
    mad_floor_frac: float = 0.02   # MAD floor as a fraction of the median
    persist: int = 3          # consecutive anomalous samples to fire
    release_rel: float = 1.15  # hysteresis: healthy below this factor
    cooldown: int = 20        # samples after release before re-firing


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """A sustained deviation on one stream (the detector's event)."""
    metric: str
    key: Tuple
    step: int
    time_s: float
    value: float              # median of the persisting anomalous samples
    baseline: float           # frozen healthy median
    factor: float             # value / baseline
    meta: Dict = dataclasses.field(default_factory=dict, compare=False)


class StreamDetector:
    """Robust anomaly state machine for one scalar stream."""

    def __init__(self, cfg: DetectorConfig = DetectorConfig()):
        self.cfg = cfg
        self._window: Deque[float] = collections.deque(maxlen=cfg.window)
        self._run: List[float] = []      # consecutive anomalous samples
        self._calm = 0                   # consecutive sub-release samples
        self._cool = 0                   # cooldown samples remaining
        self.state = HEALTHY
        self.baseline: float = 0.0       # frozen at degradation time
        self.n_events = 0

    # --- baseline ------------------------------------------------------------
    def median(self) -> float:
        return statistics.median(self._window) if self._window else 0.0

    def mad(self) -> float:
        if len(self._window) < 2:
            return 0.0
        m = statistics.median(self._window)
        raw = statistics.median([abs(x - m) for x in self._window])
        return max(1.4826 * raw, self.cfg.mad_floor_frac * abs(m))

    def _anomalous(self, x: float) -> bool:
        m = self.median()
        return x > m + self.cfg.k_mad * self.mad() \
            and x > self.cfg.min_rel * m

    # --- the state machine ----------------------------------------------------
    def observe(self, step: int, time_s: float, x: float
                ) -> Optional[Anomaly]:
        """Feed one sample; returns an :class:`Anomaly` exactly once per
        sustained episode (at the persistence threshold)."""
        cfg = self.cfg
        if self.state == DEGRADED:
            # baseline frozen; wait for sustained recovery
            if x < cfg.release_rel * self.baseline:
                self._calm += 1
                if self._calm >= cfg.persist:
                    self.state = HEALTHY
                    self._calm = 0
                    self._cool = cfg.cooldown
                    self._window.append(x)
            else:
                self._calm = 0
            return None
        if len(self._window) < cfg.warmup:
            # warmup: observe only — no judgement, no events
            self._window.append(x)
            return None
        if self._cool > 0:
            self._cool -= 1
            self._window.append(x)
            return None
        if self._anomalous(x):
            self._run.append(x)
            if len(self._run) >= cfg.persist:
                self.baseline = self.median()
                value = statistics.median(self._run)
                self.state = DEGRADED
                self._run = []
                self.n_events += 1
                return Anomaly(metric="", key=(), step=step, time_s=time_s,
                               value=value, baseline=self.baseline,
                               factor=value / max(self.baseline, 1e-12))
            self.state = SUSPECT
        else:
            self._run = []
            self.state = HEALTHY
            self._window.append(x)   # only healthy samples feed the baseline
        return None

    def reset(self) -> None:
        """Forget everything (after a reconfiguration the scale changes)."""
        self._window.clear()
        self._run = []
        self._calm = 0
        self._cool = 0
        self.state = HEALTHY
        self.baseline = 0.0


class HeartbeatDetector:
    """Missed-heartbeat -> worker hang.  A worker that emitted heartbeats
    and then goes silent for ``miss_limit`` consecutive steps is declared
    failed (fires once per silence episode)."""

    def __init__(self, miss_limit: int = 3):
        self.miss_limit = miss_limit
        self._last_seen: Dict[Tuple, int] = {}
        self._meta: Dict[Tuple, Dict] = {}
        self._fired: Dict[Tuple, bool] = {}

    def beat(self, key: Tuple, step: int, meta: Dict) -> None:
        self._last_seen[key] = step
        self._meta[key] = dict(meta)
        self._fired[key] = False

    def missing(self, step: int) -> List[Tuple[Tuple, Dict]]:
        """Workers silent for >= miss_limit steps as of ``step`` (each
        reported once until it beats again)."""
        out = []
        for key, last in self._last_seen.items():
            if step - last >= self.miss_limit and not self._fired[key]:
                self._fired[key] = True
                out.append((key, self._meta.get(key, {})))
        return out

    def reset(self) -> None:
        self._last_seen.clear()
        self._meta.clear()
        self._fired.clear()


# metric -> per-step aggregation over that step's samples (a step may emit
# one sample per microbatch; detectors judge one robust value per step)
_STEP_AGG = {
    "fwd_time": statistics.median,
    "bwd_time": statistics.median,
    "p2p_time": statistics.median,
    "sync_time": statistics.median,
    "step_time": max,
    "data_stall": sum,
}

# metrics whose sustained elevation turns into a manager event
_EVENT_METRICS = ("fwd_time", "bwd_time", "p2p_time", "step_time")


class DetectorBank:
    """One detector per stream; turns bus streams into manager events.

    Consumes the bus via :meth:`TelemetryBus.on_step` (so heartbeat
    *absence* is observable), aggregates each stream's per-step samples,
    and publishes typed events onto ``events``:

      * ``fwd_time`` / ``bwd_time`` / ``step_time`` anomaly -> ``Straggler``
      * ``p2p_time`` anomaly                               -> ``LinkDegraded``
      * heartbeat silence                                  -> ``NodeFailure``
        (via ``monitor.observe_failure`` when a monitor is attached, so
        the availability snapshot loses the chips too)

    ``data_stall`` streams are tracked (their anomalies are recorded and
    visible to the RCA layer) but raise no event of their own: a stall
    shows up in ``step_time``, and root-causing it is rca.py's job.
    """

    def __init__(self, bus: TelemetryBus, events: EventBus,
                 monitor=None, cfg: DetectorConfig = DetectorConfig(),
                 heartbeat_miss: int = 3,
                 on_anomaly: Optional[Callable[[Anomaly], None]] = None):
        self.bus = bus
        self.events = events
        self.monitor = monitor
        self.cfg = cfg
        self.on_anomaly = on_anomaly
        self.heartbeats = HeartbeatDetector(heartbeat_miss)
        self.detectors: Dict[Tuple[str, Tuple], StreamDetector] = {}
        self.anomalies: List[Anomaly] = []
        self._pending: Dict[Tuple[str, Tuple], List[Sample]] = {}
        self._meta: Dict[Tuple[str, Tuple], Dict] = {}
        bus.subscribe(self._on_sample)
        bus.on_step(self.observe_step)

    # --- ingest ---------------------------------------------------------------
    def _on_sample(self, s: Sample) -> None:
        if s.metric == "heartbeat":
            self.heartbeats.beat(s.key, s.step, dict(s.meta))
            return
        if s.metric in _STEP_AGG:
            self._pending.setdefault((s.metric, s.key), []).append(s)
            if s.meta:
                self._meta[(s.metric, s.key)] = dict(s.meta)

    def detector(self, metric: str, key: Tuple) -> StreamDetector:
        det = self.detectors.get((metric, key))
        if det is None:
            det = self.detectors[(metric, key)] = StreamDetector(self.cfg)
        return det

    # --- per-step judgement -----------------------------------------------------
    def observe_step(self, step: int, time_s: float) -> None:
        for (metric, key), samples in sorted(self._pending.items()):
            agg = _STEP_AGG[metric]([s.value for s in samples])
            det = self.detector(metric, key)
            an = det.observe(step, time_s, agg)
            if an is not None:
                an = dataclasses.replace(
                    an, metric=metric, key=key,
                    meta=self._meta.get((metric, key), {}))
                self.anomalies.append(an)
                if self.on_anomaly is not None:
                    self.on_anomaly(an)
                if metric in _EVENT_METRICS:
                    self._publish(an)
        self._pending.clear()
        for key, meta in self.heartbeats.missing(step):
            self._node_failure(step, time_s, key, meta)

    # --- event mapping ----------------------------------------------------------
    def _publish(self, an: Anomaly) -> None:
        if an.metric == "p2p_time":
            self.events.publish(LinkDegraded(
                time_s=an.time_s, zone_a=an.meta.get("zone", ""),
                zone_b=an.meta.get("zone_b", ""),
                boundary=an.key[0] if an.key else -1,
                observed_s=an.value, baseline_s=an.baseline))
        else:
            self.events.publish(Straggler(
                time_s=an.time_s, step=an.step, t_step_s=an.value,
                t_median_s=an.baseline))

    def _node_failure(self, step: int, time_s: float, key: Tuple,
                      meta: Dict) -> None:
        zone = meta.get("zone", "")
        acc = meta.get("acc_type", "")
        lost = int(meta.get("chips", 1))
        if self.monitor is not None and zone and acc:
            self.monitor.observe_failure(time_s, zone, acc, lost)
        else:
            self.events.publish(NodeFailure(
                time_s=time_s, zone=zone, acc_type=acc, lost=lost))

    # --- lifecycle --------------------------------------------------------------
    def reset(self) -> None:
        """After a reconfiguration every stream changes scale: drop all
        per-stream state (mirrors the trainer clearing its detector)."""
        self.detectors.clear()
        self.heartbeats.reset()
        self._pending.clear()

    def n_events(self) -> int:
        return len(self.anomalies)
