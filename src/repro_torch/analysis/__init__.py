"""Plan <-> program static analysis (counterpart of ``repro/analysis``).

Three layers, none needing a card:

* :mod:`repro_torch.analysis.collectives` + :mod:`repro_torch.analysis.audit`
  — the collective auditor: take every collective of the step's
  collective record (``dist.placement.record_collectives``), map its
  groups onto the physical topology, and diff against the simulator's
  predicted comm terms.
* :mod:`repro_torch.analysis.sharding_lint` — static rules over sharding
  declarations and specs (silent full replication, batch specs that
  replicate across the dp axes).
* :mod:`repro_torch.analysis.lint` — AST-based repo invariant checker
  (``python -m repro_torch.analysis.lint src/repro_torch``).
"""
from repro_torch.analysis.audit import (AuditError, audit_collectives,
                                        plan_audit)
from repro_torch.analysis.collectives import (CollectiveOp, DeviceTopology,
                                              extract_collectives)
from repro_torch.analysis.findings import Finding, Report

__all__ = [
    "AuditError", "audit_collectives", "plan_audit", "CollectiveOp",
    "DeviceTopology", "extract_collectives", "Finding", "Report",
]
