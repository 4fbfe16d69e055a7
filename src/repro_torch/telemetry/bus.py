"""Telemetry bus: typed time-series samples from runtime and simulator.

The control plane's sensing layer (ROADMAP: "telemetry, fault injection
and self-healing ops").  Producers — the real ``dist.MPMDPipeline`` /
``train.ElasticTrainer`` step loops and the discrete-event engine's task
timeline (``core/simulator/engine.py`` with ``record_timeline=True``) —
emit one shared :class:`Sample` schema, so the online detectors in
``telemetry/detectors.py`` are testable against simulated ground truth
before they ever see production noise.

Metrics (the schema):

  ============= ========================== ==============================
  metric        key                        value
  ============= ========================== ==============================
  step_time     ()                         wall seconds of one step
  fwd_time      (stage, replica)           per-microbatch forward seconds
  bwd_time      (stage, replica)           per-microbatch backward seconds
  p2p_time      (stage_a, stage_b, ra, rb) per-microbatch transfer seconds
  sync_time     (stage,)                   DP all-reduce seconds
  data_stall    ()                         input-pipeline wait seconds
  hbm_headroom  (stage, replica)           usable HBM minus peak, bytes
  heartbeat     (stage, replica)           1.0 (presence; absence = hang)
  ============= ========================== ==============================

Buffers are bounded rings (``capacity`` samples per stream), so a
long-running trainer never grows the bus; the JSONL writer
(:class:`JsonlWriter`) is shared with the controller's decision audit log
so the whole control plane exports one trace format.

A copy of ``repro/telemetry/bus.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import (Callable, Deque, Dict, Iterable, List, Mapping,
                    Optional, Tuple)

METRICS = ("step_time", "fwd_time", "bwd_time", "p2p_time", "sync_time",
           "data_stall", "hbm_headroom", "heartbeat")


@dataclasses.dataclass(frozen=True)
class Sample:
    """One time-series point: ``metric`` stream ``key`` at ``(step, time_s)``.

    ``key`` identifies the stream within the metric (see the schema table
    in the module docstring); ``meta`` carries side data the detectors and
    the RCA layer need to map a stream back to cluster coordinates
    (``zone``, ``acc_type``, ``zone_b`` for links).
    """
    metric: str
    key: Tuple
    time_s: float
    step: int
    value: float
    meta: Mapping = dataclasses.field(default_factory=dict, compare=False)

    def to_json(self) -> Dict:
        rec = {"kind": "sample", "metric": self.metric,
               "key": list(self.key), "time_s": self.time_s,
               "step": self.step, "value": self.value}
        if self.meta:
            rec["meta"] = dict(self.meta)
        return rec


class JsonlWriter:
    """Append-only JSONL trace writer (one JSON object per line).

    Shared by the telemetry bus export and the controller's decision audit
    log so every control-plane artifact is the same format end-to-end.
    Opens lazily, flushes per record (a crashed run keeps its trace).
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._fh = None
        self.n_written = 0

    def write(self, record: Mapping) -> None:
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        self._fh.write(json.dumps(record, sort_keys=True) + "\n")
        self._fh.flush()
        self.n_written += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "JsonlWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_jsonl(path: str) -> List[Dict]:
    """Load a JSONL trace back into dicts (tests, offline analysis)."""
    out: List[Dict] = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class TelemetryBus:
    """Bounded ring buffers per (metric, key) stream + step boundaries.

    Producers call :meth:`emit` per sample and :meth:`end_step` once all
    samples of a step are in; step-aware consumers (the detector bank,
    which must notice *absent* heartbeats) subscribe via :meth:`on_step`.
    When constructed with a ``writer`` every sample is also streamed to
    JSONL as it is emitted.
    """

    def __init__(self, capacity: int = 512,
                 writer: Optional[JsonlWriter] = None):
        self.capacity = capacity
        self.writer = writer
        self._buffers: Dict[Tuple[str, Tuple], Deque[Sample]] = {}
        self._subs: List[Tuple[Optional[str], Callable[[Sample], None]]] = []
        self._step_subs: List[Callable[[int, float], None]] = []
        self.n_samples = 0

    # --- producing -----------------------------------------------------------
    def emit(self, sample: Sample) -> None:
        buf = self._buffers.get((sample.metric, sample.key))
        if buf is None:
            buf = self._buffers[(sample.metric, sample.key)] = \
                collections.deque(maxlen=self.capacity)
        buf.append(sample)
        self.n_samples += 1
        if self.writer is not None:
            self.writer.write(sample.to_json())
        for metric, fn in self._subs:
            if metric is None or metric == sample.metric:
                fn(sample)

    def emit_many(self, samples: Iterable[Sample]) -> None:
        for s in samples:
            self.emit(s)

    def end_step(self, step: int, time_s: float) -> None:
        """All samples of ``step`` are in; notify step-aware consumers."""
        for fn in self._step_subs:
            fn(step, time_s)

    # --- consuming -----------------------------------------------------------
    def subscribe(self, fn: Callable[[Sample], None],
                  metric: Optional[str] = None) -> None:
        self._subs.append((metric, fn))

    def on_step(self, fn: Callable[[int, float], None]) -> None:
        self._step_subs.append(fn)

    def series(self, metric: str, key: Tuple = ()) -> List[Sample]:
        return list(self._buffers.get((metric, tuple(key)), ()))

    def values(self, metric: str, key: Tuple = ()) -> List[float]:
        return [s.value for s in self.series(metric, key)]

    def keys(self, metric: str) -> List[Tuple]:
        return sorted(k for m, k in self._buffers if m == metric)

    def latest(self, metric: str, key: Tuple = ()) -> Optional[Sample]:
        buf = self._buffers.get((metric, tuple(key)))
        return buf[-1] if buf else None

    # --- export --------------------------------------------------------------
    def export_jsonl(self, path: str) -> int:
        """Dump every buffered sample, time-then-insertion ordered, to
        ``path``; returns the number of records written.  (For streaming
        export pass a :class:`JsonlWriter` at construction instead.)"""
        rows = [s for buf in self._buffers.values() for s in buf]
        rows.sort(key=lambda s: (s.time_s, s.step, s.metric, s.key))
        with JsonlWriter(path) as w:
            for s in rows:
                w.write(s.to_json())
            return w.n_written


def wall_clock() -> float:
    """The bus timestamp source for real (non-simulated) producers."""
    return time.time()
