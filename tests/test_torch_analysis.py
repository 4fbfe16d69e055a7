"""The port's static analysis (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the same inputs, after
``tests/test_analysis.py``'s cases: the collective auditor on the same
synthetic collectives (``audit_collectives`` vs ``audit_hlo``), the
topology, ``predicted_comm``, ``plan_audit`` and the planner's and
controller's gates, the sharding lint and the AST lint give the
reference's findings (kinds, severities, messages, payloads).  The demo
runs on the CPU (its clean and seeded verdicts); the reference's demo
fails on jax 0.9.0 (R1), so it is held to its own exit rule.
"""
import dataclasses
import json
import textwrap

import pytest
import torch

from repro.analysis import audit as jaudit
from repro.analysis import collectives as jcoll
from repro.analysis import lint as jlint
from repro.analysis import sharding_lint as jslint
from repro.analysis.findings import Report as JReport
from repro.configs import get_config as jget
from repro.core import cluster as jcluster
from repro.core.planner import objectives as jobj
from repro.core.planner import search as jsearch
from repro.core.profiler import analytic as janalytic
from repro.dist.sharding import Decl as JDecl
from repro_torch.analysis import audit as taudit
from repro_torch.analysis import collectives as tcoll
from repro_torch.analysis import demo as tdemo
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import sharding_lint as tslint
from repro_torch.analysis.findings import ERROR, Report
from repro_torch.configs import get_config as tget
from repro_torch.core import cluster as tcluster
from repro_torch.core.planner import objectives as tobj
from repro_torch.core.planner import search as tsearch
from repro_torch.core.profiler import analytic as tanalytic
from repro_torch.dist import mesh as tmesh
from repro_torch.dist import placement as pm
from repro_torch.dist.sharding import P
from repro_torch.dist.sharding import Decl as TDecl



@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _norm(d):
    """A report's dict with the one message the port words otherwise (a
    reshard is the program's, not GSPMD's) put in the port's words."""
    out = json.loads(json.dumps(d, default=list))
    for f in out["findings"]:
        f["message"] = f["message"].replace(
            "GSPMD inserted a resharding the plan did not price",
            "the program reshards where the plan priced nothing")
    out.pop("tag")
    return out


# --- the auditor on synthetic collectives ------------------------------------------

def _op(mod, nbytes=4096, groups=((0, 1, 2, 3),), trips=1.0,
        kind="all-reduce", name="ar", unknown=()):
    k = max(len(g) for g in groups)
    return mod.CollectiveOp(name, kind, None, "main", nbytes, k, groups,
                            trips, unknown_dtypes=unknown)


def _topo(mod):
    # 8 positions, 2 zones, 2 chips per node
    return mod.DeviceTopology(zones=("z0",) * 4 + ("z1",) * 4,
                              chips_per_node=2)


_CASES = {
    "clean": (lambda m: [_op(m)], {"all-reduce": 6144.0}, {}),
    "mismatch": (lambda m: [_op(m)], {"all-reduce": 4000.0}, {}),
    "near": (lambda m: [_op(m)], {"all-reduce": 5500.0}, {"tol": 0.2}),
    "gathers": (lambda m: [_op(m, kind="all-gather", groups=((0, 4),),
                               name="xz"),
                           _op(m, kind="all-to-all", groups=((0, 1),),
                               name="local")], {}, {}),
    "unpriced": (lambda m: [_op(m, kind="reduce-scatter", name="rs")],
                 {"all-reduce": 100.0}, {}),
    "unknown_dtype": (lambda m: [_op(m, 2048, ((0, 1),), name="odd",
                                     unknown=("f4e2m1",))],
                      {"all-reduce": 2048.0}, {}),
    "min_bytes": (lambda m: [_op(m, nbytes=8, name="loss")], {},
                  {"min_bytes": 1024}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_audit_collectives_gives_the_reference_findings(case):
    ops, predicted, kw = _CASES[case]
    kw = dict({"min_bytes": 64}, **kw)
    want = jaudit.audit_hlo(ops(jcoll), _topo(jcoll), predicted, **kw)
    got = taudit.audit_collectives(ops(tcoll), _topo(tcoll), predicted,
                                   **kw)
    assert _norm(got.to_dict()) == _norm(want.to_dict())
    assert got.tag == "collective-audit"


def test_topology_and_volumes_are_the_references():
    ops = [_op(tcoll, groups=((0, 1), (2, 6)), kind="all-gather"),
           _op(tcoll, 4096, ((0, 1, 2, 3),), 2.0),
           _op(tcoll, 4, (tuple(range(8)),), name="tiny")]
    jops = [jcoll.CollectiveOp(*dataclasses.astuple(o)) for o in ops]
    t, j = _topo(tcoll), _topo(jcoll)
    for g in ((0, 1), (0, 2), (0, 4)):
        assert t.domain(g) == j.domain(g)
    assert [t.op_domain(o) for o in ops] == [j.op_domain(o) for o in jops]
    assert [o.total_traffic for o in ops] == [o.total_traffic for o in jops]
    assert tcoll.volumes_by_kind(ops, t, min_bytes=64) == \
        jcoll.volumes_by_kind(jops, j, min_bytes=64)


def test_topology_from_mesh_indexes_by_position():
    """The (pod, data, model) mesh's zones by the 'pod' coordinate of each
    flat position, as the reference's ``from_mesh`` reads a JAX mesh."""
    mesh = tmesh.pod_data_model_mesh(2, 2, 2, ["cpu"] * 8)
    topo = tcoll.DeviceTopology.from_mesh(mesh, zone_axes=("pod",))
    assert topo.zones == ("zone-0",) * 4 + ("zone-1",) * 4
    assert tcoll.DeviceTopology.from_mesh(
        tmesh.data_model_mesh(2, 2, ["cpu"] * 4)).zones == ("zone-0",) * 4


def test_extract_collectives_from_a_record():
    """A record's entries as ops, in order: groups resolved, the max
    reduction an all-reduce on the wire, the gather's transpose a
    reduce-scatter of the input block."""
    mesh = tmesh.data_model_mesh(2, 2, ["cpu"] * 4)
    xs = [b.requires_grad_() for b in
          pm.shard(torch.ones(4, 8), P(None, "model"), mesh).blocks]
    with pm.record_collectives() as rec:
        full = pm.all_gather(xs, mesh, "model", 1)
        pm.all_reduce_max([f.detach() for f in full], mesh, "data")
        sum(f.sum() for f in full).backward()
    ops = tcoll.extract_collectives(rec)
    assert [(o.name, o.kind, o.phase, o.nbytes, o.groups) for o in ops] == [
        ("all-gather#0", "all-gather", "fwd", 128, ((0, 1), (2, 3))),
        ("all-reduce-max#1", "all-reduce", "fwd", 128, ((0, 2), (1, 3))),
        ("reduce-scatter#2", "reduce-scatter", "bwd", 64, ((0, 1), (2, 3)))]
    assert all(o.trip_mult == 1.0 and o.computation in ("model", "data")
               for o in ops)


@pytest.mark.parametrize("tp,dp,mbs,n_micro", [(1, 1, 4, 1), (2, 2, 2, 2),
                                               (4, 8, 1, 4)])
def test_predicted_comm_is_the_references(tp, dp, mbs, n_micro):
    got = taudit.predicted_comm(tanalytic.JobProfile(tanalytic.TrainJob(
        cfg=tget("smollm_360m"), seq_len=1024, global_batch=64)),
        tp=tp, dp=dp, mbs=mbs, n_micro=n_micro)
    want = jaudit.predicted_comm(janalytic.JobProfile(janalytic.TrainJob(
        cfg=jget("smollm_360m"), seq_len=1024, global_batch=64)),
        tp=tp, dp=dp, mbs=mbs, n_micro=n_micro)
    assert got == want


# --- plan audit and the gates ------------------------------------------------------

def _planned(pkg, audit=None, auditor=None):
    job = pkg["an"].TrainJob(cfg=pkg["get"]("opt-350m"), seq_len=2048,
                             global_batch=256)
    return (pkg["search"].SailorPlanner(job, audit=audit, auditor=auditor),
            pkg["cl"].single_zone("A100-40", 8))


T = dict(an=tanalytic, get=tget, search=tsearch, cl=tcluster, obj=tobj,
         audit=taudit, Report=Report)
J = dict(an=janalytic, get=jget, search=jsearch, cl=jcluster, obj=jobj,
         audit=jaudit, Report=JReport)


def _bad(pkg):
    def auditor(plan, cluster):
        rep = pkg["Report"](tag="forced-failure")
        rep.add("PlanCapacity", ERROR, "injected failure")
        return rep
    return auditor


def test_planner_audit_gate_is_the_references():
    """``audit="error"`` plans and audits: the same ``stats["audit"]`` as
    the reference's on opt-350m over ``single_zone("A100-40", 8)``; a
    failing auditor raises ``AuditError`` under "error" and warns under
    "warn", recording the same report."""
    out = []
    for pkg in (T, J):
        obj = pkg["obj"].Objective(pkg["obj"].MAX_THROUGHPUT)
        planner, cluster = _planned(pkg, audit="error")
        res = planner.plan(cluster, obj)
        assert res.best is not None
        assert res.stats["audit"]["ok"] is True
        assert res.stats["audit"]["findings"] == []
        planner, cluster = _planned(pkg, audit="error", auditor=_bad(pkg))
        with pytest.raises(pkg["audit"].AuditError) as ei:
            planner.plan(cluster, obj)
        assert ei.value.report.by_kind() == {"PlanCapacity": 1}
        planner, cluster = _planned(pkg, audit="warn", auditor=_bad(pkg))
        with pytest.warns(UserWarning, match="injected failure"):
            warned = planner.plan(cluster, obj)
        out.append((res.stats["audit"], warned.stats["audit"]))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="audit must be"):
        _planned(T, audit="bogus")


def test_plan_audit_structural_is_the_references():
    reports = []
    for pkg in (T, J):
        planner, cluster = _planned(pkg)
        plan = planner.plan(cluster, pkg["obj"].Objective(
            pkg["obj"].MAX_THROUGHPUT)).best.plan
        ok = pkg["audit"].plan_audit(plan, cluster)
        assert ok.ok
        other = pkg["cl"].single_zone("A100-40", 8, zone="eu-west4-a")
        bad = pkg["audit"].plan_audit(plan, other)
        assert not bad.ok
        assert all(f.kind == "PlanCapacity" for f in bad.errors())
        reports.append((ok.to_dict(), bad.to_dict()))
    assert reports[0] == reports[1]


def test_controller_audit_wiring():
    from repro_torch.manager import Controller, ControllerConfig
    planner, cluster = _planned(T)
    res = planner.plan(cluster, tobj.Objective(tobj.MAX_THROUGHPUT))

    class _Stub:
        config = ControllerConfig(plan_auditor=_bad(T))

    assert Controller._audit_failed(_Stub(), cluster, res) is True
    assert res.stats["audit"]["ok"] is False

    class _Plain:
        config = ControllerConfig(plan_auditor=taudit.plan_audit)

    assert Controller._audit_failed(_Plain(), cluster, res) is False
    assert res.stats["audit"]["ok"] is True
    assert Controller._audit_failed(_Stub(), cluster, None) is False


# --- sharding lint -----------------------------------------------------------------

class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _decls(Decl):
    return {
        "attn": Decl(shape=(15, 256, 256), axes=("heads", None, None)),
        "conv": Decl(shape=(512, 512), axes=("mamba_conv", None)),
        "ff": Decl(shape=(16, 256, 256), axes=("heads", None, None)),
        "nested": {"bias": Decl(shape=(15,), axes=("heads",))},
    }


def test_sharding_lint_is_the_references():
    mesh = _FakeMesh({"pod": 2, "data": 2, "model": 8})
    for kw in ({"large_bytes": 1024}, {}):
        got = tslint.lint_decls(_decls(TDecl), "tp", mesh, **kw)
        want = jslint.lint_decls(_decls(JDecl), "tp", mesh, **kw)
        assert got.to_dict() == want.to_dict()
    assert got.summary["n_large"] == 2           # the 1 MiB default
    rep = tslint.lint_decls(_decls(TDecl), "tp", mesh, large_bytes=1024)
    assert rep.by_kind() == {"ReplicatedLargeTensor": 2}
    assert rep.errors()[0].data["fallbacks"] == [["heads", "model", 15, 8]]
    for batch in (3, 16, 2):
        assert tslint.lint_batch(mesh, batch).to_dict() == \
            jslint.lint_batch(mesh, batch).to_dict()
    assert [f.kind for f in tslint.lint_batch(mesh, 3).errors()] == \
        ["BatchReplicated"]


# --- AST lint ----------------------------------------------------------------------

_BAD_SRC = """\
import random
import time

import numpy as np


def f(xs, acc):
    t = time.time()
    r = random.random()
    n = np.random.randint(3)
    for x in {1, 2, 3}:
        pass
    ys = [y for y in set(xs)]
    if acc.mem_bytes > 5:
        pass
    return t, r, n, ys
"""

_SUP_SRC = textwrap.dedent("""\
    import time
    # lint: disable-file=set-iteration


    def f(xs):
        t = time.time()  # lint: disable=wallclock
        for x in {1, 2}:
            pass
        return t, time.time()
""")


def _rows(vs):
    return [(v.line, v.rule, v.message, v.suppressed, v.render())
            for v in vs]


def test_ast_lint_is_the_references(tmp_path):
    for name, src in (("bad.py", _BAD_SRC), ("sup.py", _SUP_SRC)):
        p = tmp_path / name
        p.write_text(src)
        assert _rows(tlint.lint_file(str(p), rules=tlint.ALL_RULES)) == \
            _rows(jlint.lint_file(str(p), rules=jlint.ALL_RULES))
    tree = tmp_path / "tree"
    d = tree / "core" / "planner"
    d.mkdir(parents=True)
    (d / "x.py").write_text("import time\nt = time.time()\n")
    sim = tree / "core" / "simulator"
    sim.mkdir()
    (sim / "y.py").write_text("ok = a.mem_bytes > 5\n")
    (tree / "launch.py").write_text("import time\nt = time.time()\n")
    assert _rows(tlint.lint_paths([str(tmp_path)])) == \
        _rows(jlint.lint_paths([str(tmp_path)]))
    assert [v.rule for v in tlint.lint_paths([str(tree)])] == ["wallclock"]
    assert tlint.main([str(tree)]) == 1
    assert tlint.main([str(tree), "--rules", "set-iteration"]) == 0
    with pytest.raises(SystemExit):
        tlint.main([str(tree), "--rules", "nope"])


def test_ast_lint_clean_on_the_port():
    """The invariant linter passes on the port's own tree (its planner and
    simulator copies), as the reference's does on ``src/``."""
    import repro_torch
    vs = tlint.lint_paths(repro_torch.__path__)
    active = [v for v in vs if not v.suppressed]
    assert active == [], "\n".join(v.render() for v in active)


# --- the demo ----------------------------------------------------------------------

def test_audit_demo_verdicts(tmp_path):
    """``python -m repro_torch.analysis.demo --device cpu``: exit 0; clean
    has zero findings and its all-reduce volume equals the closed form
    (once-a-step gradient sums); seeded has errors, a ``VolumeMismatch``
    among them; the reports land under ``--out``."""
    assert tdemo.main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    clean = json.load(open(tmp_path / "demo_clean.json"))
    seeded = json.load(open(tmp_path / "demo_seeded.json"))
    assert clean["ok"] and clean["findings"] == []
    assert clean["summary"]["rel_diff"]["all-reduce"] <= 0.2
    assert clean["summary"]["actual"]["all-reduce"]["traffic"] == \
        tdemo.predicted()["all-reduce"]
    assert not seeded["ok"]
    kinds = [f["kind"] for f in seeded["findings"]]
    assert "VolumeMismatch" in kinds and "UnpricedCollective" in kinds
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdemo.main(["--out", str(tmp_path)])
