"""Typed findings + machine-readable reports for the static analyzers
(copy of ``repro/analysis/findings.py``).

Every analyzer in :mod:`repro_torch.analysis` (collective auditor, sharding
lint, plan audit) emits :class:`Finding`s collected into a
:class:`Report`.  A report serializes to JSON under
``artifacts/analysis/`` so CI and the controller can gate on it without
re-parsing human-readable output.

Finding kinds (the auditor taxonomy; DESIGN.md §15):

=====================  ========  =======================================
kind                   severity  meaning
=====================  ========  =======================================
VolumeMismatch         error     recorded collective volume for one kind
                                 disagrees with the simulator's predicted
                                 volume by more than ``tol``
CrossZoneAllGather     error     an all-gather / all-to-all replica group
                                 spans zones the plan never priced a
                                 gather across
UnpricedCollective     error     a kind present in the program with zero
                                 predicted volume (the simulator never
                                 charged for it at all)
SilentReshard          warning   an unpredicted gather that stays inside
                                 one zone — the program reshards where
                                 the plan didn't know about, cheap but
                                 unmodeled
UnknownDtype           warning   a collective shape whose dtype is not in
                                 the byte catalog — its traffic is NOT in
                                 the audited totals
=====================  ========  =======================================

Sharding-lint kinds: ``ReplicatedLargeTensor``, ``BatchReplicated``
(see :mod:`repro_torch.analysis.sharding_lint`); plan-audit kinds:
``PlanCapacity``, ``CrossRegionStage`` (see ``audit.plan_audit``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    kind: str                     # e.g. "VolumeMismatch"
    severity: str                 # ERROR | WARNING
    message: str                  # one human-readable sentence
    # machine-readable payload: volumes, replica groups, tensor names, ...
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # where it points (op name, decl path, file:line), when applicable
    where: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "severity": self.severity,
                "message": self.message, "where": self.where,
                "data": self.data}


@dataclasses.dataclass
class Report:
    """One analyzer run: findings plus the summary tables it derived."""
    tag: str                      # what was audited, e.g. "gpt__train__2zone"
    findings: List[Finding] = dataclasses.field(default_factory=list)
    summary: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, severity: str, message: str,
            where: Optional[str] = None, **data: Any) -> None:
        self.findings.append(Finding(kind, severity, message, data, where))

    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No errors (warnings do not fail an audit)."""
        return not self.errors()

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"tag": self.tag, "ok": self.ok,
                "n_errors": len(self.errors()),
                "n_warnings": len(self.warnings()),
                "by_kind": self.by_kind(),
                "findings": [f.to_dict() for f in self.findings],
                "summary": self.summary}

    def save(self, out_dir: str = "artifacts/analysis") -> str:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.tag or 'report'}.json")
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, default=_jsonable)
        return path

    def render(self) -> str:
        lines = [f"audit[{self.tag}]: "
                 f"{len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s)"]
        for f in self.findings:
            loc = f" @ {f.where}" if f.where else ""
            lines.append(f"  [{f.severity.upper():7s}] {f.kind}{loc}: "
                         f"{f.message}")
        return "\n".join(lines)


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, (set, frozenset, tuple)):
        return sorted(obj) if isinstance(obj, (set, frozenset)) else list(obj)
    return str(obj)
