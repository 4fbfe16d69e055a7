"""The port's baseline planners (``repro_torch/core/planner/baselines/``,
plain copies) vs the reference's, on ``tests/test_baselines.py``'s
scenario: opt-350m, seq 2048, global batch 256, 16 A100-40 + 16 V100-16.

Each baseline's ranked plans, its first plan valid under the simulator
and its OOM count must be ``==`` to the reference's.  Metis searches
exhaustively under a wall-clock cap, so its results depend on the clock
unless the search ends first: it runs on the scenario's model cut to 3
layers (pipeline depths 1 and 2), where the search ends in well under a
second, with the reference's cap.  A fleet with the port's ``"H100"``
(added to the reference's catalog by ``monkeypatch``) is planned under
the datasheet entry and under a registered fit.
"""
import dataclasses

import pytest

from repro.configs import get_config as jget
from repro.core import cluster as jcluster
from repro.core.planner import baselines as jbase
from repro.core.planner.baselines import common as jcommon
from repro.core.planner import objectives as jobj
from repro.core.profiler import analytic as janalytic
from repro.core.profiler import hw_specs as jhw
from repro.core.profiler import kernel_costs as jkc
from repro_torch.configs import get_config as tget
from repro_torch.core import cluster as tcluster
from repro_torch.core.planner import baselines as tbase
from repro_torch.core.planner.baselines import common as tcommon
from repro_torch.core.planner import objectives as tobj
from repro_torch.core.profiler import analytic as tanalytic
from repro_torch.core.profiler import hw_specs as thw
from repro_torch.core.profiler import kernel_costs as tkc

NAMES = sorted(tbase.REGISTRY)
METIS_LAYERS = 3
# a fitted "H100" (what calibrate_cpu_host registers on the card)
FIT = dict(peak_flops=1.12e14, efficiency=1.0)


@pytest.fixture(autouse=True)
def _h100_in_both_catalogs(monkeypatch):
    monkeypatch.setitem(jhw.ACCELERATORS, "H100", jhw.AcceleratorSpec(
        **dataclasses.asdict(thw.ACCELERATORS["H100"])))
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()
    yield
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()


def _job(an, get, name, arch="opt-350m", seq=2048, gbs=256):
    cfg = get(arch)
    if name == "metis":
        cfg = dataclasses.replace(cfg, n_layers=METIS_LAYERS)
    return an.TrainJob(cfg=cfg, seq_len=seq, global_batch=gbs)


def _fleet(cl, kind):
    if kind == "het":
        return cl.heterogeneous_zone({"A100-40": 16, "V100-16": 16})
    return cl.heterogeneous_zone({"H100": 8, "A100-40": 8, "V100-16": 16})


def _run(name, fleet):
    """Both packages' baseline ``name`` on ``fleet``: (name, meta, ranked
    plans as dicts, the first valid plan's SimResult as a dict, OOMs)."""
    out = []
    for base, common, an, get, cl, obj in (
            (tbase, tcommon, tanalytic, tget, tcluster, tobj),
            (jbase, jcommon, janalytic, jget, jcluster, jobj)):
        job = _job(an, get, name)
        cluster = _fleet(cl, fleet)
        res = base.REGISTRY[name](job, cluster)
        best, n_oom = common.evaluate_ranked(
            res, an.JobProfile(job), cluster,
            obj.Objective(obj.MAX_THROUGHPUT))
        out.append(dict(
            name=res.name, meta=res.meta,
            plans=[dataclasses.asdict(p) for p in res.ranked_plans],
            best=None if best is None else dataclasses.asdict(best),
            n_oom=n_oom))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_baseline_ranked_plans_equal(name):
    got, want = _run(name, "het")
    assert got["plans"], name
    assert (got["name"], got["plans"]) == (want["name"], want["plans"])
    assert got["meta"] == want["meta"]
    if name == "metis":
        assert got["meta"] == {"time_capped": False}


@pytest.mark.parametrize("name", NAMES)
def test_baseline_first_valid_plan_equal(name):
    got, want = _run(name, "het")
    assert got["best"] is not None and got["best"]["valid"], name
    assert (got["best"], got["n_oom"]) == (want["best"], want["n_oom"])


def test_varuna_memory_flaw_shows_in_both():
    """Varuna's top plans on 16 GB V100s pass its own memory model and fail
    the accurate one (paper §5.2.1), with the reference's OOM count."""
    n_ooms = []
    for base, common, an, get, cl, obj in (
            (tbase, tcommon, tanalytic, tget, tcluster, tobj),
            (jbase, jcommon, janalytic, jget, jcluster, jobj)):
        cluster = cl.single_zone("V100-16", 16)
        job = an.TrainJob(cfg=get("gpt-neo-2.7b"), seq_len=2048,
                          global_batch=2048)
        res = base.varuna.plan(job, cluster)
        assert res.ranked_plans
        _, n_oom = common.evaluate_ranked(res, an.JobProfile(job), cluster,
                                          obj.Objective(obj.MAX_THROUGHPUT))
        n_ooms.append(n_oom)
    assert n_ooms[0] == n_ooms[1] >= 1


@pytest.mark.parametrize("entry", ["datasheet", "fitted"])
@pytest.mark.parametrize("name", NAMES)
def test_baselines_on_an_h100_fleet_equal(monkeypatch, name, entry):
    """8 H100 + 8 A100-40 + 16 V100-16 in one zone (``chip_smoke.py``'s
    ``[plan]`` fleet), the H100 priced by the datasheet or by a fit
    registered in both catalogs."""
    if entry == "fitted":
        for hw in (thw, jhw):
            monkeypatch.setitem(hw.ACCELERATORS, "H100", dataclasses.replace(
                hw.ACCELERATORS["H100"], **FIT))
    got, want = _run(name, "h100")
    assert got == want
