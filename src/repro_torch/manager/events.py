"""Typed cluster events and an ordered event bus (paper §4.4, Fig. 2).

The control plane is event-driven: feeds (availability traces, price feeds,
the in-training straggler detector) are diffed by the monitor into typed
events, published onto a bus in (time, sequence) order, and consumed by the
controller.  Events carry the post-event ``ClusterSpec`` snapshot so a
handler never has to re-derive cluster state from the delta.

A copy of ``repro/manager/events.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Type

from repro_torch.core.cluster import ClusterSpec


@dataclasses.dataclass(frozen=True)
class ClusterEvent:
    """Base event: something happened at ``time_s`` (feed/sim clock)."""
    time_s: float
    cluster: Optional[ClusterSpec] = dataclasses.field(
        default=None, compare=False)

    def describe(self) -> str:
        return f"{type(self).__name__}@{self.time_s:.0f}s"


@dataclasses.dataclass(frozen=True)
class CapacityUp(ClusterEvent):
    """Allocatable chips in one (zone, type) pool grew (quota filled)."""
    zone: str = ""
    acc_type: str = ""
    available: int = 0           # new pool size
    delta: int = 0               # chips gained (> 0)

    def describe(self) -> str:
        return (f"CapacityUp@{self.time_s:.0f}s {self.zone}/{self.acc_type} "
                f"+{self.delta} -> {self.available}")


@dataclasses.dataclass(frozen=True)
class CapacityDown(ClusterEvent):
    """Gradual shrink (allocations denied / drained); live state intact."""
    zone: str = ""
    acc_type: str = ""
    available: int = 0
    delta: int = 0               # chips lost (> 0)

    def describe(self) -> str:
        return (f"CapacityDown@{self.time_s:.0f}s {self.zone}/{self.acc_type} "
                f"-{self.delta} -> {self.available}")


@dataclasses.dataclass(frozen=True)
class NodeFailure(ClusterEvent):
    """Bulk preemption / node crash: chips vanished with state on them."""
    zone: str = ""
    acc_type: str = ""
    available: int = 0
    lost: int = 0

    def describe(self) -> str:
        return (f"NodeFailure@{self.time_s:.0f}s {self.zone}/{self.acc_type} "
                f"lost {self.lost} -> {self.available}")


@dataclasses.dataclass(frozen=True)
class PriceChange(ClusterEvent):
    """Spot/preemptible price moved for one (zone, type) pool."""
    zone: str = ""
    acc_type: str = ""
    price_per_hour: float = 0.0
    old_price_per_hour: float = 0.0

    def describe(self) -> str:
        return (f"PriceChange@{self.time_s:.0f}s {self.zone}/{self.acc_type} "
                f"${self.old_price_per_hour:.2f} -> "
                f"${self.price_per_hour:.2f}/h")


@dataclasses.dataclass(frozen=True)
class Straggler(ClusterEvent):
    """A training step ran ``factor``x slower than the running median."""
    step: int = 0
    t_step_s: float = 0.0
    t_median_s: float = 0.0

    def describe(self) -> str:
        return (f"Straggler@{self.time_s:.0f}s step {self.step} "
                f"{self.t_step_s * 1e3:.0f}ms vs median "
                f"{self.t_median_s * 1e3:.0f}ms")


@dataclasses.dataclass(frozen=True)
class LinkDegraded(ClusterEvent):
    """Sustained p2p/collective latency elevation on one link.

    Raised by the telemetry detectors (``telemetry/detectors.py``) when a
    per-boundary transfer stream stays above its robust baseline —
    ``observed_s`` vs ``baseline_s`` for the affected ``boundary`` (the
    pipeline-stage index the stream crosses; -1 when unknown)."""
    zone_a: str = ""
    zone_b: str = ""
    boundary: int = -1
    observed_s: float = 0.0
    baseline_s: float = 0.0

    @property
    def factor(self) -> float:
        return self.observed_s / max(self.baseline_s, 1e-12)

    def describe(self) -> str:
        return (f"LinkDegraded@{self.time_s:.0f}s {self.zone_a}->"
                f"{self.zone_b} boundary {self.boundary} "
                f"{self.observed_s * 1e3:.1f}ms vs "
                f"{self.baseline_s * 1e3:.1f}ms ({self.factor:.1f}x)")


class EventBus:
    """Ordered pub/sub.  Publishes are delivered to subscribers immediately
    and appended to ``log``; ``publish`` rejects a time earlier than the
    last published (feeds are merged time-sorted upstream, so a violation
    is a programming error).

    Ordering contract (chaos runs depend on byte-reproducibility): events
    are totally ordered by ``(time_s, seq)`` where ``seq`` is the
    monotonically increasing publish sequence number — i.e. ties on
    ``time_s`` break by *insertion order*, stably, for ``log``,
    ``of_type`` and subscriber delivery alike.  ``publish`` returns the
    assigned ``seq``; pinned by ``tests/test_telemetry.py``.
    """

    def __init__(self):
        self.log: List[ClusterEvent] = []
        self.seqs: List[int] = []        # seq of log[i] (parallel list)
        self._subs: List[Dict] = []
        self._last_t = float("-inf")
        self._next_seq = 0

    def subscribe(self, handler: Callable[[ClusterEvent], None],
                  event_type: Optional[Type[ClusterEvent]] = None) -> None:
        """Call ``handler`` for every published event (optionally only for
        instances of ``event_type``)."""
        self._subs.append({"fn": handler, "type": event_type})

    def publish(self, event: ClusterEvent) -> int:
        if event.time_s < self._last_t:
            raise ValueError(
                f"event bus requires time-ordered publishes: "
                f"{event.time_s} < {self._last_t}")
        self._last_t = event.time_s
        seq = self._next_seq
        self._next_seq += 1
        self.log.append(event)
        self.seqs.append(seq)
        for sub in self._subs:
            if sub["type"] is None or isinstance(event, sub["type"]):
                sub["fn"](event)
        return seq

    def of_type(self, event_type: Type[ClusterEvent]) -> List[ClusterEvent]:
        return [e for e in self.log if isinstance(e, event_type)]
