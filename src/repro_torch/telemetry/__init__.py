"""Telemetry, online detection, root-cause analysis and fault injection.

The control plane's sensing layer (ROADMAP: "telemetry, fault injection
and self-healing ops"): runtime and simulator producers emit one shared
sample schema onto :class:`TelemetryBus`; :class:`DetectorBank` turns the
noisy streams into typed manager events; :class:`RootCauseAnalyzer`
classifies each event into a remediation; :class:`ChaosHarness` closes
the loop against injected ground-truth faults.

A copy of ``repro/telemetry/__init__.py``: the same names,
signatures and arithmetic; only its imports point at ``repro_torch``.
"""
from repro_torch.telemetry.bus import (METRICS, JsonlWriter, Sample, TelemetryBus,
                                 read_jsonl, wall_clock)
from repro_torch.telemetry.detectors import (Anomaly, DetectorBank, DetectorConfig,
                                       HeartbeatDetector, StreamDetector)
from repro_torch.telemetry.faults import (EXPECTED_VERDICT, FAULT_KINDS,
                                    ChaosHarness, ChaosReport, FaultInjector,
                                    FaultSpec, SimulatedWorld, degrade_link)
from repro_torch.telemetry.rca import (DATA_STALL, NODE_FAILURE, REMEDIATION,
                                 SLOW_CHIP, SLOW_LINK, UNKNOWN, RootCause,
                                 RootCauseAnalyzer)

__all__ = [
    "METRICS", "JsonlWriter", "Sample", "TelemetryBus", "read_jsonl",
    "wall_clock",
    "Anomaly", "DetectorBank", "DetectorConfig", "HeartbeatDetector",
    "StreamDetector",
    "EXPECTED_VERDICT", "FAULT_KINDS", "ChaosHarness", "ChaosReport",
    "FaultInjector", "FaultSpec", "SimulatedWorld", "degrade_link",
    "DATA_STALL", "NODE_FAILURE", "REMEDIATION", "SLOW_CHIP", "SLOW_LINK",
    "UNKNOWN", "RootCause", "RootCauseAnalyzer",
]
