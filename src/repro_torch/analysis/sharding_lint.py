"""Static sharding lint: catch silent replication before running
(counterpart of ``repro/analysis/sharding_lint.py``).

``dist/sharding.py`` resolves logical axes to PartitionSpecs with a
divisibility fallback: a dim that does not divide its mesh axis silently
replicates.  That is the right runtime behavior (no padding, no partial
shards) — and exactly the kind of silent degradation that makes a plan's
memory/comm model wrong.  These rules re-run the resolution statically
and report what fell back:

* ``ReplicatedLargeTensor`` — a tensor at least ``large_bytes`` big whose
  resolved spec is fully replicated.  ERROR when a policy rule *tried* to
  shard it (divisibility fallback fired: the planner thinks it is sharded
  over 'model' but every chip holds a full copy); WARNING when the policy
  simply has no rule for its axes (declared, never shardable).
* ``BatchReplicated`` — ``batch_spec`` resolved the batch dim to None
  while the mesh has dp axes: every data-parallel replica computes the
  same examples, i.e. the job silently stopped being data-parallel.

Run via :func:`lint_decls` / :func:`lint_batch` on the same (decls,
policy, mesh) triple the model builder uses.  The port's ``Decl`` trees
are nested dicts, walked by ``sharding.iter_decls`` (sorted keys,
"/"-joined paths: the reference's ``tree_flatten_with_path`` order and
names).
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.analysis.findings import ERROR, WARNING, Report
from repro_torch.dist import sharding as sh


def _nbytes(decl: sh.Decl, dtype_bytes: int) -> int:
    return math.prod(decl.shape) * dtype_bytes if decl.shape else dtype_bytes


def lint_decls(decls: Any, policy: str, mesh, *,
               large_bytes: int = 1 << 20,
               dtype_bytes: int = 2,
               tag: str = "sharding-lint") -> Report:
    """Lint a tree of :class:`~repro_torch.dist.sharding.Decl` against one
    (policy, mesh).  ``large_bytes`` is the replication-cost threshold at
    ``dtype_bytes``-wide parameters (default 1 MiB at bf16)."""
    rules = sh.policy_rules(policy)
    sizes = dict(mesh.shape)
    report = Report(tag=tag)
    leaves = list(sh.iter_decls(decls))
    n_large = n_replicated = 0
    for path, decl in leaves:
        if not isinstance(decl, sh.Decl):
            continue
        nbytes = _nbytes(decl, dtype_bytes)
        if nbytes < large_bytes:
            continue
        n_large += 1
        spec = sh.logical_to_spec(decl.shape, decl.axes, rules, mesh)
        if any(p is not None for p in tuple(spec)):
            continue
        n_replicated += 1
        where = path or "<root>"
        # which axes *tried* to shard (had a candidate on this mesh) and
        # lost to divisibility?
        fallbacks = []
        for dim, ax in zip(decl.shape, decl.axes):
            for cand in (rules.get(ax, ()) if ax else ()):
                if cand in sizes and dim % sizes[cand] != 0:
                    fallbacks.append((ax, cand, dim, sizes[cand]))
        if fallbacks:
            ax, cand, dim, n = fallbacks[0]
            report.add(
                "ReplicatedLargeTensor", ERROR,
                f"{where} ({nbytes / 1e6:.1f} MB) degraded to full "
                f"replication: logical axis {ax!r} dim {dim} does not "
                f"divide mesh axis {cand!r}={n} (divisibility fallback)",
                where=where, nbytes=nbytes, shape=list(decl.shape),
                axes=list(decl.axes),
                fallbacks=[list(f) for f in fallbacks])
        else:
            report.add(
                "ReplicatedLargeTensor", WARNING,
                f"{where} ({nbytes / 1e6:.1f} MB) is fully replicated: "
                f"policy {policy!r} has no rule sharding any of its axes "
                f"on this mesh",
                where=where, nbytes=nbytes, shape=list(decl.shape),
                axes=list(decl.axes))
    report.summary = {"policy": policy, "mesh": dict(sizes),
                      "n_decls": len(leaves), "n_large": n_large,
                      "n_replicated_large": n_replicated}
    return report


def lint_batch(mesh, global_batch: int, *,
               tag: str = "batch-lint") -> Report:
    """Check the batch dim actually shards over the dp axes of ``mesh``."""
    report = Report(tag=tag)
    axes = sh.dp_axes(mesh)
    sizes = dict(mesh.shape)
    spec = sh.batch_spec(mesh, global_batch)
    first = tuple(spec)[0] if len(tuple(spec)) else None
    if axes and first is None:
        dp_total = math.prod(sizes[a] for a in axes)
        report.add(
            "BatchReplicated", ERROR,
            f"global batch {global_batch} shards over none of the dp axes "
            f"{list(axes)} (sizes {[sizes[a] for a in axes]}): every "
            f"data-parallel replica would compute identical examples",
            batch=global_batch, dp_axes=list(axes), dp_total=dp_total)
    sharded_over = (first,) if isinstance(first, str) else tuple(first or ())
    report.summary = {"batch": global_batch, "dp_axes": list(axes),
                      "batch_sharded_over": list(sharded_over)}
    return report
