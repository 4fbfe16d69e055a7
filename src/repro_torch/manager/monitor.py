"""Availability monitoring: feeds -> diff -> typed events (paper §4.4).

A *feed* is anything iterable as ``(time_s, ClusterSpec)`` snapshots —
``TraceFeed`` adapts the seeded ``AvailabilityTrace`` (replacing the
hand-rolled change-point translation the elasticity example used to do),
``ListFeed`` replays an explicit script (tests, recorded cloud logs).  The
monitor merges feeds time-sorted, diffs consecutive snapshots per
(zone, type) pool, classifies each delta, and publishes typed events:

  * capacity grew                         -> CapacityUp
  * shrank by < failure_drop_frac of pool -> CapacityDown (graceful drain:
    the cluster manager got notice, live state can be moved kill-free)
  * shrank by >= failure_drop_frac        -> NodeFailure (bulk preemption:
    state on those chips is gone)
  * effective price moved                 -> PriceChange

The classification threshold mirrors the trace generator: its random walk
drifts in single-node increments while preemptions cut a pool to at most
half its quota in one step.

A copy of ``repro/manager/monitor.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Iterable, Iterator, List, Sequence, Tuple

from repro_torch.core.cluster import AvailabilityTrace, ClusterSpec
from repro_torch.manager.events import (CapacityDown, CapacityUp, ClusterEvent,
                                  EventBus, NodeFailure, PriceChange)

Snapshot = Tuple[float, ClusterSpec]

_tiebreak = itertools.count()


class TraceFeed:
    """Adapt ``AvailabilityTrace.change_points()`` into a snapshot feed."""

    def __init__(self, trace: AvailabilityTrace):
        self.trace = trace

    def __iter__(self) -> Iterator[Snapshot]:
        return iter(self.trace.change_points())


class ListFeed:
    """Replay an explicit, time-sorted list of snapshots."""

    def __init__(self, snapshots: Sequence[Snapshot]):
        self.snapshots = list(snapshots)

    def __iter__(self) -> Iterator[Snapshot]:
        return iter(self.snapshots)


class AvailabilityMonitor:
    """Merge feeds, diff snapshots, publish typed events onto a bus."""

    def __init__(self, initial: ClusterSpec, feeds: Iterable,
                 bus: EventBus = None, failure_drop_frac: float = 0.5):
        self.initial = initial
        self.current = initial
        self.bus = bus if bus is not None else EventBus()
        self.failure_drop_frac = failure_drop_frac
        # heapq.merge keeps the multi-feed stream time-sorted; the counter
        # breaks ties so ClusterSpecs are never compared.
        counted = [((t, next(_tiebreak), c) for t, c in feed)
                   for feed in feeds]
        self._stream = heapq.merge(*counted)
        self._pending: List[Snapshot] = []   # lookahead buffer

    # --- polling -------------------------------------------------------------
    def poll(self, until_s: float) -> List[ClusterEvent]:
        """Consume every snapshot with ``time_s <= until_s``; diff, classify
        and publish the resulting events; return them in order."""
        out: List[ClusterEvent] = []
        while True:
            snap = self._next_snapshot(until_s)
            if snap is None:
                return out
            t, cluster = snap
            out.extend(self._emit(t, cluster))

    def drain(self) -> List[ClusterEvent]:
        """Consume the entire remaining stream."""
        return self.poll(float("inf"))

    def _next_snapshot(self, until_s: float):
        if self._pending:
            if self._pending[0][0] <= until_s:
                return self._pending.pop(0)
            return None
        for t, _, cluster in self._stream:
            if t <= until_s:
                return (t, cluster)
            self._pending.append((t, cluster))
            return None
        return None

    # --- diff + classify -----------------------------------------------------
    def _emit(self, t: float, cluster: ClusterSpec) -> List[ClusterEvent]:
        events: List[ClusterEvent] = []
        for (zone, acc), (old, new) in sorted(
                self.current.capacity_diff(cluster).items()):
            if new > old:
                events.append(CapacityUp(
                    time_s=t, cluster=cluster, zone=zone, acc_type=acc,
                    available=new, delta=new - old))
            elif old - new >= max(1, self.failure_drop_frac * old):
                events.append(NodeFailure(
                    time_s=t, cluster=cluster, zone=zone, acc_type=acc,
                    available=new, lost=old - new))
            else:
                events.append(CapacityDown(
                    time_s=t, cluster=cluster, zone=zone, acc_type=acc,
                    available=new, delta=old - new))
        events.extend(self._price_events(t, cluster))
        self.current = cluster
        for e in events:
            self.bus.publish(e)
        return events

    # --- detector-driven failures (telemetry path) ----------------------------
    def observe_failure(self, t: float, zone: str, acc_type: str,
                        lost: int) -> NodeFailure:
        """A *detected* failure (missed heartbeats, ``telemetry``
        detectors) rather than a feed-diffed one: shrink the current
        snapshot by ``lost`` chips and publish ``NodeFailure`` with the
        post-event cluster, exactly like a feed-sourced bulk preemption —
        so controller handling and audit are identical for both paths."""
        old = self.current.zone(zone).capacity.get(acc_type, 0)
        lost = max(0, min(int(lost), old))
        new = old - lost
        cluster = self.current.with_capacity({(zone, acc_type): new})
        ev = NodeFailure(time_s=t, cluster=cluster, zone=zone,
                         acc_type=acc_type, available=new, lost=lost)
        self.current = cluster
        self.bus.publish(ev)
        return ev

    def _price_events(self, t: float,
                      cluster: ClusterSpec) -> List[ClusterEvent]:
        return [PriceChange(time_s=t, cluster=cluster, zone=zone,
                            acc_type=acc, price_per_hour=new,
                            old_price_per_hour=old)
                for (zone, acc), (old, new) in sorted(
                    self.current.price_diff(cluster).items())]
