"""Repo invariant linter: AST rules over the planner/simulator sources
(copy of ``repro/analysis/lint.py``).

The planner's correctness rests on invariants that code review keeps
re-litigating; this makes them mechanical.  Rules (scoped to the paths
where the invariant holds — DESIGN.md §15 has the full table):

==================  ===========================  =========================
rule                scope                        invariant
==================  ===========================  =========================
wallclock           core/planner, core/simulator  no ``time.time()`` /
                                                  ``time.time_ns()`` in
                                                  pure search/simulate
                                                  paths — plans must be
                                                  byte-identical across
                                                  runs.  (``perf_
                                                  counter`` for *stats*
                                                  fields is allowed: it
                                                  never feeds plan
                                                  content.)
unseeded-random     core/planner, core/simulator  no module-level
                                                  ``random.*`` /
                                                  ``np.random.*`` calls —
                                                  randomness must flow
                                                  through a seeded
                                                  ``default_rng``/``Random``
set-iteration       core/planner, core/simulator  no iteration directly
                                                  over ``set``-typed
                                                  expressions (literals,
                                                  ``set()``/``frozenset()``
                                                  calls, set ops) — order
                                                  is hash-seed dependent
                                                  and leaks into plan
                                                  tie-breaks.  Dicts are
                                                  insertion-ordered and
                                                  exempt.
mem-feasibility     core/planner                  feasibility comparisons
                                                  must go through
                                                  ``stage_peak_bytes`` /
                                                  ``usable_mem_bytes``,
                                                  never raw ``.mem_bytes``
                                                  (reserved HBM).
==================  ===========================  =========================

Suppression: append ``# lint: disable=<rule>[,<rule>...]`` to the
offending line, or put ``# lint: disable-file=<rule>`` on any line to
waive a rule for the whole file (both are themselves reported with
``--show-suppressed``).

The scopes are path fragments, so they hold for the port's tree
(``repro_torch/core/planner/``, ``repro_torch/core/simulator/``).

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.lint src/repro_torch
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
import sys
from typing import Dict, List, Sequence, Tuple

ALL_RULES = ("wallclock", "unseeded-random", "set-iteration",
             "mem-feasibility")

# rule -> path fragments (posix) it applies to
_SCOPES: Dict[str, Tuple[str, ...]] = {
    "wallclock": ("core/planner/", "core/simulator/"),
    "unseeded-random": ("core/planner/", "core/simulator/"),
    "set-iteration": ("core/planner/", "core/simulator/"),
    "mem-feasibility": ("core/planner/",),
}

_WALLCLOCK_FNS = {"time", "time_ns"}
_SEEDED_RANDOM_FNS = {"default_rng", "Random", "RandomState", "PRNGKey"}
_SET_BINOPS = (ast.BitOr, ast.BitAnd, ast.Sub, ast.BitXor)

_DISABLE_LINE = re.compile(r"#\s*lint:\s*disable=([\w,\-]+)")
_DISABLE_FILE = re.compile(r"#\s*lint:\s*disable-file=([\w,\-]+)")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    rule: str
    message: str
    suppressed: bool = False

    def render(self) -> str:
        sup = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{sup}"


def _dotted(node: ast.AST) -> str:
    """'np.random.shuffle' for an Attribute/Name chain, '' otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
            and node.func.id in ("set", "frozenset"):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, _SET_BINOPS):
        return _is_set_expr(node.left) or _is_set_expr(node.right)
    return False


class _Checker(ast.NodeVisitor):
    def __init__(self, path: str, rules: Sequence[str]):
        self.path = path
        self.rules = set(rules)
        self.out: List[Violation] = []

    def _emit(self, rule: str, node: ast.AST, msg: str) -> None:
        if rule in self.rules:
            self.out.append(Violation(self.path, node.lineno, rule, msg))

    # --- wallclock / unseeded-random (both look at calls) ------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _dotted(node.func)
        if name in ("time.time", "time.time_ns"):
            self._emit("wallclock", node,
                       f"{name}() in a pure planner/simulator path breaks "
                       f"byte-identical-plan determinism; thread a clock "
                       f"in or move timing to the caller")
        # jax.random.* is exempt: every call takes an explicit PRNG key
        parts = name.split(".")
        if len(parts) >= 2 and parts[-2] == "random" \
                and parts[0] in ("random", "np", "numpy") \
                and parts[-1] not in _SEEDED_RANDOM_FNS:
            self._emit("unseeded-random", node,
                       f"{name}() draws from global (unseeded) state; use "
                       f"a seeded default_rng/Random instance")
        elif len(parts) == 2 and parts[0] == "random" \
                and parts[1] not in _SEEDED_RANDOM_FNS:
            self._emit("unseeded-random", node,
                       f"{name}() draws from the global random module; "
                       f"use a seeded Random instance")
        self.generic_visit(node)

    # --- set-iteration ------------------------------------------------------
    def _check_iter(self, it: ast.AST) -> None:
        if _is_set_expr(it):
            self._emit("set-iteration", it,
                       "iteration over a set is hash-order dependent and "
                       "leaks into tie-breaks; wrap in sorted(...)")

    def visit_For(self, node: ast.For) -> None:
        self._check_iter(node.iter)
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            self._check_iter(gen.iter)
        self.generic_visit(node)

    visit_ListComp = visit_SetComp = visit_DictComp = _visit_comp
    visit_GeneratorExp = _visit_comp

    # --- mem-feasibility ----------------------------------------------------
    def visit_Compare(self, node: ast.Compare) -> None:
        for side in [node.left, *node.comparators]:
            if isinstance(side, ast.Attribute) and side.attr == "mem_bytes":
                self._emit(
                    "mem-feasibility", node,
                    "feasibility check against raw .mem_bytes ignores the "
                    "runtime's reserved HBM; route through "
                    "stage_peak_bytes / usable_mem_bytes")
                break
        self.generic_visit(node)


def _rules_for(path: str) -> List[str]:
    posix = path.replace(os.sep, "/")
    return [r for r, frags in _SCOPES.items()
            if any(f in posix for f in frags)]


def lint_file(path: str, rules: Sequence[str] = None) -> List[Violation]:
    """Lint one file.  ``rules`` overrides the path-based scoping (used by
    tests); by default a file outside every rule's scope yields nothing."""
    rules = list(rules) if rules is not None else _rules_for(path)
    if not rules:
        return []
    with open(path) as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 0, "parse-error", str(e))]
    checker = _Checker(path, rules)
    checker.visit(tree)
    # apply suppression comments
    lines = src.splitlines()
    file_off = set()
    for ln in lines:
        m = _DISABLE_FILE.search(ln)
        if m:
            file_off.update(m.group(1).split(","))
    out: List[Violation] = []
    for v in checker.out:
        line_txt = lines[v.line - 1] if 0 < v.line <= len(lines) else ""
        m = _DISABLE_LINE.search(line_txt)
        line_off = set(m.group(1).split(",")) if m else set()
        out.append(dataclasses.replace(
            v, suppressed=v.rule in file_off | line_off))
    return out


def lint_paths(paths: Sequence[str],
               rules: Sequence[str] = None) -> List[Violation]:
    """Lint every ``.py`` file under ``paths`` (files or directories)."""
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
    out: List[Violation] = []
    for f in sorted(set(files)):
        out.extend(lint_file(f, rules))
    return out


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="repo invariant linter (DESIGN.md §15)")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to lint (default: src)")
    ap.add_argument("--rules", default=None,
                    help=f"comma-separated subset of {ALL_RULES}")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print violations waived by disable comments")
    args = ap.parse_args(argv)
    rules = args.rules.split(",") if args.rules else None
    if rules:
        unknown = set(rules) - set(ALL_RULES)
        if unknown:
            ap.error(f"unknown rules {sorted(unknown)}; known: {ALL_RULES}")
    vs = lint_paths(args.paths or ["src"], rules)
    active = [v for v in vs if not v.suppressed]
    shown = vs if args.show_suppressed else active
    for v in shown:
        print(v.render())
    n_sup = sum(v.suppressed for v in vs)
    print(f"lint: {len(active)} violation(s), {n_sup} suppressed")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
