"""Cluster topology, quotas, pricing and dynamic availability.

This is the planner's view of the world (paper Fig. 4, left input): resource
quotas per (zone, accelerator type), the zone->region topology, and a live
availability feed.  ``AvailabilityTrace`` replays Figure-2-style fluctuating
availability from a seeded generator so elasticity experiments are
reproducible without live cloud polling.

A copy of ``repro/core/cluster.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.profiler.hw_specs import (
    ACCELERATORS, LINKS, AcceleratorSpec, LinkSpec, get_accelerator, get_link)


@dataclasses.dataclass(frozen=True)
class ZoneSpec:
    """One availability zone: a pool of accelerators of various types."""

    name: str
    region: str
    # accelerator type -> number of *chips* currently allocatable.
    capacity: Mapping[str, int]
    # optional per-type price override ($/chip-hour); falls back to catalog.
    price_override: Mapping[str, float] = dataclasses.field(default_factory=dict)

    def price_per_sec(self, acc_type: str) -> float:
        hourly = self.price_override.get(
            acc_type, get_accelerator(acc_type).price_per_hour)
        return hourly / 3600.0


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """The full fleet: zones grouped into regions plus link classes.

    Link-class resolution implements the paper's hierarchy:
    same node > same zone > same region (H6 treats zones of one region as
    one zone) > cross-region.
    """

    zones: Tuple[ZoneSpec, ...]
    # override link models; defaults pulled from hw_specs.LINKS
    links: Mapping[str, LinkSpec] = dataclasses.field(
        default_factory=lambda: dict(LINKS))

    # ---- topology helpers ----------------------------------------------------
    def zone(self, name: str) -> ZoneSpec:
        for z in self.zones:
            if z.name == name:
                return z
        raise KeyError(f"unknown zone {name!r}")

    @property
    def regions(self) -> List[str]:
        seen: List[str] = []
        for z in self.zones:
            if z.region not in seen:
                seen.append(z.region)
        return seen

    def zones_in_region(self, region: str) -> List[ZoneSpec]:
        return [z for z in self.zones if z.region == region]

    def link_between(self, zone_a: str, zone_b: str,
                     same_node: bool = False) -> LinkSpec:
        if same_node:
            return self.links["intra-node"]
        if zone_a == zone_b:
            return self.links["intra-zone"]
        za, zb = self.zone(zone_a), self.zone(zone_b)
        if za.region == zb.region:
            return self.links["inter-zone"]
        return self.links["inter-region"]

    def egress_price(self, zone_a: str, zone_b: str) -> float:
        return self.link_between(zone_a, zone_b).price_per_byte

    # ---- capacity helpers ----------------------------------------------------
    def total_chips(self, acc_type: Optional[str] = None) -> int:
        tot = 0
        for z in self.zones:
            for t, n in z.capacity.items():
                if acc_type is None or t == acc_type:
                    tot += n
        return tot

    def gpu_types(self) -> List[str]:
        out: List[str] = []
        for z in self.zones:
            for t in z.capacity:
                if t not in out:
                    out.append(t)
        return out

    def with_capacity(self, capacity: Mapping[Tuple[str, str], int]) -> "ClusterSpec":
        """New ClusterSpec with capacity[(zone, type)] replaced."""
        new_zones = []
        for z in self.zones:
            cap = dict(z.capacity)
            for (zn, t), n in capacity.items():
                if zn == z.name:
                    cap[t] = n
            new_zones.append(dataclasses.replace(z, capacity=cap))
        return dataclasses.replace(self, zones=tuple(new_zones))

    def with_price(self, prices: Mapping[Tuple[str, str], float]) -> "ClusterSpec":
        """New ClusterSpec with price_override[(zone, type)] applied."""
        new_zones = []
        for z in self.zones:
            ovr = dict(z.price_override)
            for (zn, t), p in prices.items():
                if zn == z.name:
                    ovr[t] = p
            new_zones.append(dataclasses.replace(z, price_override=ovr))
        return dataclasses.replace(self, zones=tuple(new_zones))

    # ---- control-plane helpers (repro.manager) -------------------------------
    def fingerprint(self) -> Tuple:
        """Hashable identity of everything the planner's answer depends on:
        per-(zone, type) capacity AND effective price.  Two clusters with
        equal fingerprints yield identical plans, which is what the
        warm-start replan cache keys on."""
        rows = []
        for z in sorted(self.zones, key=lambda z: z.name):
            for t in sorted(z.capacity):
                rows.append((z.name, z.region, t, z.capacity[t],
                             round(z.price_per_sec(t), 12)))
        return tuple(rows)

    def capacity_diff(self, other: "ClusterSpec"
                      ) -> Dict[Tuple[str, str], Tuple[int, int]]:
        """Per-(zone, type) capacity delta from ``self`` to ``other``:
        {(zone, type): (old, new)} for every pool whose size changed."""
        old = {(z.name, t): n for z in self.zones
               for t, n in z.capacity.items()}
        new = {(z.name, t): n for z in other.zones
               for t, n in z.capacity.items()}
        out: Dict[Tuple[str, str], Tuple[int, int]] = {}
        for key in sorted(set(old) | set(new)):
            o, n = old.get(key, 0), new.get(key, 0)
            if o != n:
                out[key] = (o, n)
        return out

    def price_diff(self, other: "ClusterSpec"
                   ) -> Dict[Tuple[str, str], Tuple[float, float]]:
        """Per-(zone, type) effective $/chip-hour delta from ``self`` to
        ``other``: {(zone, type): (old, new)} where the price moved."""
        out: Dict[Tuple[str, str], Tuple[float, float]] = {}
        for z in self.zones:
            try:
                nz = other.zone(z.name)
            except KeyError:
                continue
            for t in z.capacity:
                o = z.price_per_sec(t) * 3600.0
                n = nz.price_per_sec(t) * 3600.0
                if abs(n - o) > 1e-12:
                    out[(z.name, t)] = (o, n)
        return out


def single_zone(acc_type: str, chips: int, zone: str = "us-central1-a",
                region: str = "us-central1") -> ClusterSpec:
    """Convenience: one zone with one accelerator type."""
    return ClusterSpec(zones=(
        ZoneSpec(name=zone, region=region, capacity={acc_type: chips}),))


def heterogeneous_zone(capacity: Mapping[str, int],
                       zone: str = "us-central1-a",
                       region: str = "us-central1") -> ClusterSpec:
    return ClusterSpec(zones=(
        ZoneSpec(name=zone, region=region, capacity=dict(capacity)),))


def multi_zone(per_zone: Mapping[str, Tuple[str, Mapping[str, int]]]) -> ClusterSpec:
    """per_zone: zone_name -> (region, {type: chips})."""
    return ClusterSpec(zones=tuple(
        ZoneSpec(name=zn, region=rg, capacity=dict(cap))
        for zn, (rg, cap) in per_zone.items()))


# --- dynamic availability (Figure 2) -----------------------------------------
@dataclasses.dataclass
class AvailabilityEvent:
    time_s: float
    zone: str
    acc_type: str
    available: int             # new number of allocatable chips


class AvailabilityTrace:
    """Seeded replay of fluctuating capacity, one series per (zone, type).

    Models the paper's Figure 2: capacity random-walks between 0 and the
    quota, with occasional bulk preemptions.  Deterministic given ``seed``.
    """

    def __init__(self, cluster: ClusterSpec, seed: int = 0,
                 step_s: float = 60.0, horizon_s: float = 8 * 3600.0,
                 preempt_prob: float = 0.02):
        self.cluster = cluster
        self.step_s = step_s
        rng = np.random.default_rng(seed)
        self.events: List[AvailabilityEvent] = []
        for z in cluster.zones:
            for t, quota in z.capacity.items():
                level = quota
                for k in range(int(horizon_s / step_s)):
                    if rng.random() < preempt_prob:
                        level = int(rng.integers(0, max(1, quota // 2) + 1))
                    else:
                        # drift up toward quota (allocation requests filling)
                        node = get_accelerator(t).chips_per_node
                        level = min(quota, level + int(rng.integers(0, node + 1)))
                    self.events.append(AvailabilityEvent(
                        time_s=k * step_s, zone=z.name, acc_type=t,
                        available=level))
        self.events.sort(key=lambda e: e.time_s)

    def capacity_at(self, time_s: float) -> Dict[Tuple[str, str], int]:
        """Latest availability per (zone, type) at ``time_s``."""
        state: Dict[Tuple[str, str], int] = {
            (z.name, t): n for z in self.cluster.zones
            for t, n in z.capacity.items()}
        for e in self.events:
            if e.time_s > time_s:
                break
            state[(e.zone, e.acc_type)] = e.available
        return state

    def cluster_at(self, time_s: float) -> ClusterSpec:
        return self.cluster.with_capacity(self.capacity_at(time_s))

    def change_points(self) -> Iterator[Tuple[float, ClusterSpec]]:
        """Yield (time, cluster) at every point where availability changed."""
        last: Dict[Tuple[str, str], int] = {}
        for e in self.events:
            key = (e.zone, e.acc_type)
            if last.get(key) != e.available:
                last[key] = e.available
                yield e.time_s, self.cluster.with_capacity(
                    {k: v for k, v in last.items()})
