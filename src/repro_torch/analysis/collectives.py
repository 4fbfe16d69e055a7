"""Structured collective IR over a collective record + physical topology
mapping (counterpart of ``repro/analysis/collectives.py``).

``launch/comm.py`` answers "how many bytes of collectives" — this module
answers *which* collectives: one :class:`CollectiveOp` per recorded
collective (``dist.placement.record_collectives``) with its groups as
flat mesh positions and its result bytes.  The reference parses replica
groups out of HLO text (iota ``[G,S]<=[dims]T(perm)`` and explicit
lists) and weights each op by the trip counts of its enclosing loops; a
record holds its groups resolved already (``Mesh.groups``), and the
eager program runs every layer and microbatch as calls of their own, so
every ``trip_mult`` is 1 and a collective that runs 48 times is 48 ops.

:class:`DeviceTopology` maps flat positions onto the physical hierarchy
(node -> zone) so each group can be classified as ``intra-node``,
``intra-zone`` or ``cross-zone`` — the domain the simulator would have to
price it in.  Build it with :meth:`DeviceTopology.from_mesh`, which
indexes by flat position as the record does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.comm import ring_traffic

INTRA_NODE = "intra-node"
INTRA_ZONE = "intra-zone"
CROSS_ZONE = "cross-zone"


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One collective of the program."""
    name: str                     # "<kind>#<index in the record>"
    kind: str                     # all-reduce, all-gather, reduce-scatter
    phase: Optional[str]          # the record's fwd | bwd | recompute
    computation: str              # the mesh axes it ran over
    nbytes: int                   # result bytes (one member's)
    group_size: int
    groups: Tuple[Tuple[int, ...], ...]   # flat mesh positions
    trip_mult: float = 1.0        # always 1: the eager program unrolls
    unknown_dtypes: Tuple[str, ...] = ()

    @property
    def traffic(self) -> float:
        """Ring-scaled wire bytes of ONE execution."""
        return ring_traffic(self.kind, self.nbytes, self.group_size)

    @property
    def total_traffic(self) -> float:
        """Ring-scaled wire bytes over the whole step (trip-weighted)."""
        return self.traffic * self.trip_mult


def extract_collectives(record) -> List[CollectiveOp]:
    """Every collective of a record (a ``placement.CollectiveRecord`` or
    its ``entries``), in the order it ran (counterpart of the reference's
    ``extract_collectives(hlo_text)``).  The max and min reductions are
    all-reduces on the wire: their kind here is ``all-reduce``, and their
    name keeps the record's kind."""
    out: List[CollectiveOp] = []
    for i, e in enumerate(getattr(record, "entries", record)):
        kind = "all-reduce" if e.kind.startswith("all-reduce") else e.kind
        out.append(CollectiveOp(
            name=f"{e.kind}#{i}", kind=kind, phase=e.phase,
            computation=",".join(e.axes), nbytes=int(e.nbytes),
            group_size=max(len(g) for g in e.groups), groups=e.groups))
    return out


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Flat position -> physical location (node, zone).

    ``zones[p]`` is the zone of position ``p``; nodes are contiguous
    ``chips_per_node`` runs of positions (how the launcher packs hosts).
    Built from a mesh via :meth:`from_mesh` or given explicitly in tests.
    """
    zones: Tuple[str, ...]
    chips_per_node: int = 4

    @property
    def n_devices(self) -> int:
        return len(self.zones)

    def zone_of(self, p: int) -> str:
        return self.zones[p] if 0 <= p < len(self.zones) else f"?{p}"

    def node_of(self, p: int) -> int:
        return p // max(1, self.chips_per_node)

    def domain(self, group: Sequence[int]) -> str:
        """Widest link class a group spans."""
        zs = {self.zone_of(p) for p in group}
        if len(zs) > 1:
            return CROSS_ZONE
        nodes = {self.node_of(p) for p in group}
        return INTRA_NODE if len(nodes) <= 1 else INTRA_ZONE

    def op_domain(self, op: CollectiveOp) -> str:
        """Widest domain across all of an op's groups."""
        order = (INTRA_NODE, INTRA_ZONE, CROSS_ZONE)
        worst = INTRA_NODE
        for g in op.groups:
            d = self.domain(g)
            if order.index(d) > order.index(worst):
                worst = d
        return worst

    @classmethod
    def from_mesh(cls, mesh, zone_axes: Sequence[str] = ("pod",),
                  chips_per_node: int = 4) -> "DeviceTopology":
        """Topology of a mesh (``dist.mesh.Mesh``): position = flat index
        into ``mesh.devices`` (C order, as ``Mesh.groups`` numbers them),
        zone = the position's coordinates along ``zone_axes`` (the 'pod'
        axis crosses zones in this repo's production meshes)."""
        zidx = [a for a in zone_axes if a in mesh.axis_names]
        zones: List[str] = []
        for p in range(mesh.size):
            coords = mesh.coords(p)
            key = tuple(coords[a] for a in zidx)
            zones.append("zone-" + "-".join(map(str, key)) if key
                         else "zone-0")
        return cls(zones=tuple(zones), chips_per_node=chips_per_node)


def volumes_by_kind(ops: Sequence[CollectiveOp],
                    topology: Optional[DeviceTopology] = None,
                    min_bytes: int = 0) -> Dict[str, Dict]:
    """Aggregate trip-weighted traffic per op kind (and per domain when a
    topology is given).  Ops smaller than ``min_bytes`` (control scalars)
    are excluded."""
    out: Dict[str, Dict] = {}
    for op in ops:
        if op.nbytes < min_bytes:
            continue
        rec = out.setdefault(op.kind, {"count": 0, "bytes": 0.0,
                                       "traffic": 0.0, "domains": {}})
        rec["count"] += 1
        rec["bytes"] += op.nbytes * op.trip_mult
        rec["traffic"] += op.total_traffic
        if topology is not None:
            dom = topology.op_domain(op)
            rec["domains"][dom] = rec["domains"].get(dom, 0.0) \
                + op.total_traffic
    return out
