"""Measured per-op kernel cost tables (the third calibration leg); a copy of
``repro/core/profiler/kernel_costs.py``, so tables saved by either package
load in the other with identical lookups.

``measured.calibrate_kernels`` times the port's CUDA kernels into a
:class:`KernelCostTable` per chip — rows keyed by (op, shape, dtype) with
a measured wall-clock.  ``analytic.JobProfile.cost`` consults the
registered table for the chip it is pricing *before* falling back to the
roofline guess, so planner/simulator rankings inherit measured per-op
costs wherever the table has coverage (Poplar's measured-throughput-table
insight, arXiv:2408.12596).

Lookup rules (the reference's DESIGN.md §13):

  1. exact (op, shape, dtype) hit -> the measured time, verbatim;
  2. same (op, dtype) but unseen shape -> log-log linear interpolation of
     time vs the op's scalar *work* measure (its FLOP count), between the
     two bracketing measured points — kernel time is near power-law in
     work, so interpolating in log space keeps relative error flat across
     the decade gaps a small calibration grid leaves;
  3. work outside the measured range, or op/dtype/chip not measured at
     all -> ``None``, and the caller keeps the roofline estimate
     (extrapolating a measured curve past its support is how tables go
     wrong silently — refuse instead).

Table JSON schema (``KernelCostTable.save``)::

    {"chip": "cpu-host",
     "entries": [{"op": "flash_attention", "dtype": "float32",
                  "shape": [4, 256, 256, 64, 1], "time_s": 2.1e-3}, ...]}
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.core.profiler.hw_specs import AcceleratorSpec

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}

#: ops with measured coverage; shape-key conventions per op:
#:   flash_attention   (bh, sq, sk, head_dim, causal01)
#:   flash_decode      (bh, sk, head_dim)
#:   rmsnorm           (rows, d)
#:   fused_add_rmsnorm (rows, d)
#:   ssd_scan          (batch, seq, heads, headdim, state)
KERNEL_OPS = ("flash_attention", "flash_decode", "rmsnorm",
              "fused_add_rmsnorm", "ssd_scan")

_SSD_NOMINAL_CHUNK = 128      # default chunk for the quadratic in-chunk term


def op_flops_bytes(op: str, shape: Tuple[int, ...],
                   dtype: str) -> Tuple[float, float]:
    """(FLOPs, HBM bytes) of one kernel invocation — the roofline inputs."""
    b = DTYPE_BYTES.get(dtype, 2)
    if op == "flash_attention":
        bh, sq, sk, d, causal = shape
        flops = 4.0 * bh * sq * sk * d * (0.5 if causal else 1.0)
        byts = b * bh * d * (2 * sq + 2 * sk)      # q in, o out, k+v in
        return flops, byts
    if op == "flash_decode":
        bh, sk, d = shape
        return 4.0 * bh * sk * d, b * bh * d * (2 * sk + 2)
    if op == "rmsnorm":
        rows, d = shape
        return 4.0 * rows * d, b * (2 * rows * d + d)
    if op == "fused_add_rmsnorm":
        rows, d = shape                            # two reads, two writes
        return 5.0 * rows * d, b * (4 * rows * d + d)
    if op == "ssd_scan":
        bs, s, h, p, n = shape
        q = _SSD_NOMINAL_CHUNK
        flops = bs * h * s * (2.0 * q * (n + p) + 4.0 * p * n)
        byts = b * bs * s * (2 * h * p + h + 2 * n)
        return flops, byts
    raise ValueError(f"unknown kernel op {op!r}; known: {KERNEL_OPS}")


def op_work(op: str, shape: Tuple[int, ...]) -> float:
    """Scalar interpolation axis: the op's FLOP count (monotone in size)."""
    return op_flops_bytes(op, shape, "bfloat16")[0]


def roofline_time(op: str, shape: Tuple[int, ...], dtype: str,
                  acc: AcceleratorSpec) -> float:
    """The analytic guess the table replaces: max(compute, bandwidth)."""
    return acc.roofline_time(*op_flops_bytes(op, shape, dtype))


@dataclasses.dataclass
class KernelCostTable:
    """Measured (op, shape, dtype) -> seconds for one chip."""

    chip: str
    entries: Dict[Tuple[str, str], List[Tuple[Tuple[int, ...], float]]] = \
        dataclasses.field(default_factory=dict)

    def add(self, op: str, shape: Tuple[int, ...], dtype: str,
            time_s: float) -> None:
        shape = tuple(int(s) for s in shape)
        rows = self.entries.setdefault((op, dtype), [])
        rows[:] = [(sh, t) for sh, t in rows if sh != shape]   # re-measure
        rows.append((shape, float(time_s)))
        rows.sort(key=lambda r: (op_work(op, r[0]), r[0]))

    def lookup(self, op: str, shape: Tuple[int, ...],
               dtype: str) -> Optional[float]:
        rows = self.entries.get((op, dtype))
        if not rows:
            return None
        shape = tuple(int(s) for s in shape)
        for sh, t in rows:
            if sh == shape:
                return t
        if len(rows) < 2:
            return None
        w = op_work(op, shape)
        lo_w = op_work(op, rows[0][0])
        hi_w = op_work(op, rows[-1][0])
        if not (lo_w <= w <= hi_w):
            return None                    # outside support: roofline
        for (s0, t0), (s1, t1) in zip(rows, rows[1:]):
            w0, w1 = op_work(op, s0), op_work(op, s1)
            if w0 <= w <= w1:
                if w1 <= w0:               # duplicate work value
                    return t0
                f = (math.log(w) - math.log(w0)) / (math.log(w1)
                                                    - math.log(w0))
                return math.exp(math.log(t0) + f * (math.log(t1)
                                                    - math.log(t0)))
        return None                        # pragma: no cover

    def n_points(self) -> int:
        return sum(len(rows) for rows in self.entries.values())

    # --- persistence ----------------------------------------------------------
    def save(self, path: os.PathLike) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        rows = [{"op": op, "dtype": dt, "shape": list(sh), "time_s": t}
                for (op, dt), lst in sorted(self.entries.items())
                for sh, t in lst]
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps({"chip": self.chip, "entries": rows},
                                  indent=1))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: os.PathLike) -> "KernelCostTable":
        data = json.loads(Path(path).read_text())
        table = cls(chip=data["chip"])
        for row in data["entries"]:
            table.add(row["op"], tuple(row["shape"]), row["dtype"],
                      row["time_s"])
        return table


# --- per-chip registry the analytic profiler consults -------------------------

_TABLES: Dict[str, KernelCostTable] = {}
_EPOCH = 0          # bumped on any registry change; LayerCost caches key on it


def register_kernel_table(table: KernelCostTable) -> None:
    global _EPOCH
    _TABLES[table.chip] = table
    _EPOCH += 1


def get_kernel_table(chip: str) -> Optional[KernelCostTable]:
    return _TABLES.get(chip)


def clear_kernel_tables() -> None:
    global _EPOCH
    _TABLES.clear()
    _EPOCH += 1


def epoch() -> int:
    """Cache-invalidation token for memoized consumers (analytic.cost)."""
    return _EPOCH
