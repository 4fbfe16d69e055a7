"""The port's planner (cluster model, heuristics, DP solver, the outer
search, the serving planner) vs the reference's.

The port keeps plain-Python copies of ``core/cluster.py`` and
``core/planner/*.py``; on the same inputs they must give the reference's
plans and numbers exactly (``==``).  The port's ``"H100"`` entry is added
to the reference's catalog with ``monkeypatch`` (its file is not edited),
so fleets that hold the port's card plan alike in both.  The post-plan
audit reads XLA HLO and is not ported: ``audit=`` other than None raises.
"""
import dataclasses
import types

import pytest

from repro.configs import get_config as jget
from repro.core import cluster as jcluster
from repro.core.planner import dp_solver as jdp
from repro.core.planner import heuristics as jH
from repro.core.planner import objectives as jobj
from repro.core.planner import search as jsearch
from repro.core.planner import serving as jpserving
from repro.core.profiler import analytic as janalytic
from repro.core.profiler import hw_specs as jhw
from repro.core.profiler import kernel_costs as jkc
from repro_torch.configs import get_config as tget
from repro_torch.core import cluster as tcluster
from repro_torch.core.planner import dp_solver as tdp
from repro_torch.core.planner import heuristics as tH
from repro_torch.core.planner import objectives as tobj
from repro_torch.core.planner import search as tsearch
from repro_torch.core.planner import serving as tpserving
from repro_torch.core.profiler import analytic as tanalytic
from repro_torch.core.profiler import hw_specs as thw
from repro_torch.core.profiler import kernel_costs as tkc

J = types.SimpleNamespace(get=jget, cl=jcluster, dp=jdp, H=jH, obj=jobj,
                          search=jsearch, serving=jpserving, an=janalytic)
T = types.SimpleNamespace(get=tget, cl=tcluster, dp=tdp, H=tH, obj=tobj,
                          search=tsearch, serving=tpserving, an=tanalytic)


@pytest.fixture(autouse=True)
def _h100_in_both_catalogs(monkeypatch):
    monkeypatch.setitem(jhw.ACCELERATORS, "H100", jhw.AcceleratorSpec(
        **dataclasses.asdict(thw.ACCELERATORS["H100"])))
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()
    yield
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()


def _job(P, arch="opt-350m", seq=2048, gbs=256):
    return P.an.TrainJob(cfg=P.get(arch), seq_len=seq, global_batch=gbs)


# --- the cluster model ------------------------------------------------------------

def _fleets(P):
    return {
        "hetero": P.cl.heterogeneous_zone(
            {"H100": 8, "A100-40": 8, "V100-16": 16}),
        "geo": P.cl.multi_zone({
            "us-central1-a": ("us-central1", {"H100": 8}),
            "europe-west4-a": ("europe-west4", {"A100-40": 8})}),
        "two_regions": P.cl.multi_zone({
            "z-a": ("region-1", {"A100-40": 16}),
            "z-b": ("region-2", {"A100-40": 16, "V100-16": 8})}),
    }


@pytest.mark.parametrize("fleet", ["hetero", "geo", "two_regions"])
def test_cluster_model_equal(fleet):
    out = []
    for P in (T, J):
        c = _fleets(P)[fleet]
        zones = [z.name for z in c.zones]
        out.append(dict(
            fp=c.fingerprint(), regions=c.regions, types=c.gpu_types(),
            total=c.total_chips(), per_type={t: c.total_chips(t)
                                             for t in c.gpu_types()},
            links={(a, b): dataclasses.asdict(c.link_between(a, b))
                   for a in zones for b in zones},
            egress={(a, b): c.egress_price(a, b) for a in zones
                    for b in zones},
            prices={(z.name, t): z.price_per_sec(t) for z in c.zones
                    for t in z.capacity},
            pools=P.H.region_pools(c)))
    assert out[0] == out[1]


def test_availability_trace_equal():
    got, want = ([(e.time_s, e.zone, e.acc_type, e.available)
                  for e in P.cl.AvailabilityTrace(
                      _fleets(P)["geo"], seed=3, horizon_s=3600.0).events]
                 for P in (T, J))
    assert got == want and got


# --- heuristics and the DP solver ---------------------------------------------------

@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_balanced_split_and_min_tp_equal(pp):
    out = []
    for P in (T, J):
        prof = P.an.JobProfile(_job(P))
        splits = P.H.balanced_split(prof, pp)
        table = P.H.TPTable(prof)
        out.append((splits, [table.min_tp(pp, i, lo, hi, 2, g)
                             for i, (lo, hi) in enumerate(splits)
                             for g in ("A100-40", "V100-16", "H100")]))
    assert out[0] == out[1]


@pytest.mark.parametrize("pp,d,types_", [
    (2, 2, {"A100-40": 8, "V100-16": 8}),
    (3, 1, {"A100-40": 8, "V100-16": 8}),
    (2, 4, {"A100-40": 16}),
    (2, 2, {"H100": 8, "A100-40": 8}),
])
def test_dp_solver_equal(pp, d, types_):
    """tests/test_planner.py's DP parametrization (plus an H100 fleet): the
    solver's frontier and best partial, by time and by cost."""
    out = []
    for P in (T, J):
        cluster = P.cl.heterogeneous_zone(types_)
        job = _job(P)
        profile = P.an.JobProfile(job)
        planner = P.search.SailorPlanner(job)
        splits = P.H.balanced_split(profile, pp)
        tp_sel = planner._tp_selection(pp, splits, 1, cluster.gpu_types())
        regions, caps = P.H.region_pools(cluster)
        solver = P.dp.DPSolver(profile, cluster, splits, 1, d, tp_sel,
                               regions, caps)
        best = solver.best()
        cheap = P.dp.DPSolver(profile, cluster, splits, 1, d, tp_sel,
                              regions, caps).best("cost")
        out.append((tp_sel, solver.solve(), dataclasses.asdict(best),
                    dataclasses.asdict(cheap), best.est_time(solver.n_micro)))
    assert out[0] == out[1]


# --- the outer search -----------------------------------------------------------------

def _best(res):
    b = res.best
    return dict(describe=b.plan.describe(), plan=dataclasses.asdict(b.plan),
                t_iter=b.t_iter, cost_per_iter=b.cost_per_iter,
                valid=b.valid, peak_mem=b.peak_mem,
                timing=dataclasses.asdict(b.timing),
                counts=(res.n_candidates, res.n_evaluated, res.n_oom))


@pytest.mark.parametrize("kind", ["max_throughput", "min_cost"])
@pytest.mark.parametrize("fleet", ["a100", "hetero_a100_v100"])
def test_plan_for_opt350m_equal(kind, fleet):
    out = []
    for P in (T, J):
        cluster = P.cl.single_zone("A100-40", 32) if fleet == "a100" else \
            P.cl.heterogeneous_zone({"A100-40": 8, "V100-16": 8})
        res = P.search.plan_for(P.get("opt-350m"), cluster,
                                P.obj.Objective(kind), 2048, 256)
        out.append(_best(res))
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", ["max_throughput", "min_cost"])
def test_plan_for_on_an_h100_fleet_equal(kind):
    """smollm-360M on H100s in one region and A100s in another: the fleet
    ``chip_smoke.py`` plans before and after the H100's fit."""
    out = []
    for P in (T, J):
        res = P.search.plan_for(P.get("smollm_360m"), _fleets(P)["geo"],
                                P.obj.Objective(kind), 1024, 64)
        out.append(_best(res))
    assert out[0] == out[1]
    assert "H100" in out[0]["describe"]


def test_plan_for_under_a_refitted_h100_equal(monkeypatch):
    """A fitted entry registered under ``"H100"`` in both catalogs (what
    ``calibrate_cpu_host`` on the card produces) reprices both planners
    alike, and moves the plan off the datasheet's."""
    fit = dict(peak_flops=1.3e14, efficiency=1.0)
    before = _best(tsearch.plan_for(tget("smollm_360m"),
                                    _fleets(T)["geo"],
                                    tobj.Objective("max_throughput"), 1024,
                                    64))
    monkeypatch.setitem(thw.ACCELERATORS, "H100", dataclasses.replace(
        thw.ACCELERATORS["H100"], **fit))
    monkeypatch.setitem(jhw.ACCELERATORS, "H100", dataclasses.replace(
        jhw.ACCELERATORS["H100"], **fit))
    out = [_best(P.search.plan_for(P.get("smollm_360m"), _fleets(P)["geo"],
                                   P.obj.Objective("max_throughput"), 1024,
                                   64)) for P in (T, J)]
    assert out[0] == out[1]
    assert out[0]["plan"] != before["plan"]


def test_serving_planner_equal():
    out = []
    for P in (T, J):
        job = P.an.ServeJob(cfg=P.get("smollm_360m"), prompt_len=256,
                            max_new_tokens=128, decode_batch=8,
                            arrival_rps=4.0)
        planner = P.search.SailorPlanner(job)
        cluster = P.cl.multi_zone({
            "us-central1-a": ("us-central1", {"A100-40": 8, "H100": 4}),
            "eu-west4-a": ("eu-west4", {"RTX-3090": 16})})
        objective = P.obj.ServingObjective(slo_ttft_p99_s=2.0,
                                           slo_tpot_p99_s=0.2)
        res = P.serving.plan_serving(planner, cluster, objective,
                                     horizon_s=60.0)
        naive = P.serving.naive_homogeneous_serving(planner, cluster,
                                                    horizon_s=60.0)
        out.append((res.best.plan.describe(), dataclasses.asdict(res.best),
                    res.n_candidates, res.n_evaluated, res.stats["peak_rps"],
                    dataclasses.asdict(naive)))
    assert out[0] == out[1]
    assert out[0][1]["valid"]


def test_audit_raises_until_the_audit_is_ported():
    job = _job(T)
    assert tsearch.SailorPlanner(job, audit=None).audit is None
    for audit in ("warn", "error"):
        with pytest.raises(NotImplementedError, match="item 13"):
            tsearch.SailorPlanner(job, audit=audit)
    with pytest.raises(ValueError):
        tsearch.SailorPlanner(job, audit="maybe")
