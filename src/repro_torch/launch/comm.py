"""Collective traffic of a recorded program (counterpart of
``repro/launch/hlo.py``).

The reference parses the compiled post-SPMD HLO text and sums the result
bytes of every collective by op kind.  The port has no HLO: every
collective of its mesh goes through ``dist.placement._collective``, and a
``placement.record_collectives()`` record holds each one (the backward's
transposes too) with its groups already resolved.  ``collective_bytes``
aggregates such a record as ``hlo.collective_bytes`` aggregates the HLO:

    all-reduce       2 (k-1)/k * bytes     (k = group size)
    all-gather       (k-1)/k * bytes       (bytes = gathered result)
    reduce-scatter   (k-1)/k * bytes       (bytes = the scattered result)

The max and min reductions (the vocab-parallel loss's) are all-reduces on
the wire and are priced as one; they keep their own kind in the record
and in ``by_kind``.  The reference's regexes, its ``-start`` / ``-done``
rules and its ``_DTYPE_BYTES`` catalog have no counterpart: an entry's
bytes are its tensor's, read from the tensor, and a record holds no
split-phase pairs, so the reference's ``unknown_dtypes`` (the dtypes
missing from its catalog) has nothing to hold and is left out.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple


def ring_traffic(kind: str, nbytes: float, k: int) -> float:
    """Ring-scaled wire traffic of one collective (matches network.py)."""
    if kind == "collective-permute":
        return float(nbytes)
    if k <= 1:
        return 0.0
    if kind.startswith("all-reduce"):
        return 2.0 * (k - 1) / k * nbytes
    return (k - 1) / k * nbytes


@dataclasses.dataclass
class CollectiveStats:
    # op kind -> (count, raw result bytes, ring-scaled traffic bytes)
    by_kind: Dict[str, Tuple[int, int, float]]

    @property
    def total_bytes(self) -> int:
        return sum(v[1] for v in self.by_kind.values())

    @property
    def total_traffic(self) -> float:
        return sum(v[2] for v in self.by_kind.values())


def collective_bytes(entries: Iterable) -> CollectiveStats:
    """Count, raw result bytes and ring traffic by kind of a record's
    entries (``placement.CollectiveEntry``, or ``record.entries``)."""
    by_kind: Dict[str, List[float]] = {}
    for e in getattr(entries, "entries", entries):
        cur = by_kind.setdefault(e.kind, [0, 0, 0.0])
        cur[0] += 1
        cur[1] += e.nbytes
        cur[2] += ring_traffic(e.kind, e.nbytes, len(e.groups[0]))
    return CollectiveStats(by_kind={k: (int(v[0]), int(v[1]), float(v[2]))
                                    for k, v in by_kind.items()})
