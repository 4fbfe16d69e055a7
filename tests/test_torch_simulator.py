"""The port's simulator (event engine, memory model, timing, cost, the
``simulate`` facade, the serving simulator) and the paged-cache page
budget vs the reference's.

The port keeps plain-Python copies of ``core/cluster.py``,
``core/planner/plan.py`` and ``core/simulator/*.py``; on the same inputs
they must give the reference's results exactly (``==`` on every field:
the same Python arithmetic).  Each scenario is built once in each package
from the same arguments.  The port's ``"H100"`` entry is added to the
reference's catalog with ``monkeypatch`` (its file is not edited), so
plans over the port's card price alike in both.
"""
import dataclasses
import types

import pytest

from repro.configs import get_config as jget
from repro.core import cluster as jcluster
from repro.core.planner import plan as jplan
from repro.core.profiler import analytic as janalytic
from repro.core.profiler import hw_specs as jhw
from repro.core.profiler import kernel_costs as jkc
from repro.core.simulator import cost as jcost
from repro.core.simulator import engine as jeng
from repro.core.simulator import memory as jmem
from repro.core.simulator import serving as jserving
from repro.core.simulator import simulate as jsimulate
from repro.core.simulator import timing as jtiming
from repro.serve import paged_cache as jpaged
from repro_torch.configs import get_config as tget
from repro_torch.core import cluster as tcluster
from repro_torch.core.planner import plan as tplan
from repro_torch.core.profiler import analytic as tanalytic
from repro_torch.core.profiler import hw_specs as thw
from repro_torch.core.profiler import kernel_costs as tkc
from repro_torch.core.simulator import cost as tcost
from repro_torch.core.simulator import engine as teng
from repro_torch.core.simulator import memory as tmem
from repro_torch.core.simulator import serving as tserving
from repro_torch.core.simulator import simulate as tsimulate
from repro_torch.core.simulator import timing as ttiming
from repro_torch.serve import paged_cache as tpaged

J = types.SimpleNamespace(get=jget, cl=jcluster, plan=jplan, an=janalytic,
                          cost=jcost, eng=jeng, mem=jmem, serving=jserving,
                          sim=jsimulate, tim=jtiming, paged=jpaged)
T = types.SimpleNamespace(get=tget, cl=tcluster, plan=tplan, an=tanalytic,
                          cost=tcost, eng=teng, mem=tmem, serving=tserving,
                          sim=tsimulate, tim=ttiming, paged=tpaged)
ZONE = "us-central1-a"


@pytest.fixture(autouse=True)
def _h100_in_both_catalogs(monkeypatch):
    monkeypatch.setitem(jhw.ACCELERATORS, "H100", jhw.AcceleratorSpec(
        **dataclasses.asdict(thw.ACCELERATORS["H100"])))
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()
    yield
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()


def _asdict(x):
    """A result as plain data: dataclasses (nested) as dicts, lists and
    tuples of them element by element."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, (list, tuple)):
        return [_asdict(v) for v in x]
    return x


def _profile(P, arch="opt-350m", seq=2048, gbs=256, remat="full"):
    return P.an.JobProfile(P.an.TrainJob(cfg=P.get(arch), seq_len=seq,
                                         global_batch=gbs, remat=remat))


# --- the event engine ---------------------------------------------------------

def _hand_spec(P, n_stages, n_replicas, total_micro, seed):
    """A PipelineSpec with unequal, deterministic per-worker costs, fan-in /
    fan-out routing and per-bucket syncs."""
    cost = {}
    for s in range(n_stages):
        for r in range(n_replicas[s]):
            k = (seed * 7 + s * 3 + r) % 5
            cost[(s, r)] = P.eng.WorkerCost(fwd=1e-3 * (1 + k),
                                            bwd=2e-3 * (1 + k % 3),
                                            upd=1e-4 * (1 + s))
    sync = [[] if n_replicas[s] == 1 else [5e-4 * (1 + s), 2e-4]
            for s in range(n_stages)]
    return P.eng.PipelineSpec(
        n_stages=n_stages, n_replicas=tuple(n_replicas), cost=cost,
        total_micro=total_micro,
        assign=lambda s, m: m % n_replicas[s],
        p2p=lambda sa, sb, ra, rb: 1e-4 * (1 + (sa + ra + rb) % 3),
        sync=sync)


@pytest.mark.parametrize("n_stages,n_replicas,total_micro,seed", [
    (1, (1,), 4, 0), (2, (2, 2), 8, 1), (4, (1, 1, 1, 1), 8, 2),
    (3, (2, 1, 3), 6, 3), (4, (2, 2, 2, 2), 12, 4)])
@pytest.mark.parametrize("overlap", [True, False])
def test_run_1f1b_equals_reference(n_stages, n_replicas, total_micro, seed,
                                   overlap):
    got, want = (P.eng.run_1f1b(
        _hand_spec(P, n_stages, n_replicas, total_micro, seed),
        P.eng.EngineConfig(overlap_comm=overlap, record_timeline=True,
                           per_task_overhead_s=1e-5)) for P in (T, J))
    assert _asdict(got) == _asdict(want)


@pytest.mark.parametrize("P_,v,M", [(2, 2, 4), (4, 2, 8), (4, 2, 6),
                                    (2, 4, 8)])
def test_run_interleaved_equals_reference(P_, v, M):
    got, want = (P.eng.run_interleaved(
        _hand_spec(P, P_, (1,) * P_, M, v),
        P.eng.EngineConfig(schedule="interleaved", virtual_stages=v,
                           record_timeline=True)) for P in (T, J))
    assert _asdict(got) == _asdict(want)


@pytest.mark.parametrize("pp,dp,mbs,gbs,schedule", [
    (2, 2, 1, 256, "1f1b"), (4, 1, 8, 64, "1f1b"),
    (4, 1, 8, 64, "interleaved"), (4, 1, 1, 6, "interleaved")])
def test_engine_on_the_reference_tests_plans(pp, dp, mbs, gbs, schedule):
    """tests/test_engine.py's homogeneous A100 plans: the uniform spec the
    timing facade builds, run through ``run_pipeline``."""
    out = []
    for P in (T, J):
        prof = _profile(P, gbs=gbs)
        plan = P.plan.homogeneous_plan("A100-40", ZONE, pp, dp, 1,
                                       prof.n_partition_units, mbs, gbs)
        cfg = P.eng.EngineConfig(schedule=schedule,
                                 virtual_stages=2 if schedule != "1f1b"
                                 else 1)
        spec, reps, m, m_eff = P.tim._engine_spec_uniform(
            prof, plan, P.cl.single_zone("A100-40", 256), cfg)
        out.append((_asdict(P.eng.run_pipeline(spec, cfg)), reps, m, m_eff))
    assert out[0] == out[1]


def test_interleaved_refuses_uneven_dp_like_the_reference():
    for P in (T, J):
        prof = _profile(P)
        units = prof.n_partition_units
        s0 = P.plan.StageConfig(0, units // 2,
                                (P.plan.StageReplica("A100-40", 1, ZONE),) * 2)
        s1 = P.plan.StageConfig(units // 2, units,
                                (P.plan.StageReplica("A100-40", 1, ZONE),))
        cfg = P.eng.EngineConfig(schedule="interleaved", virtual_stages=2)
        spec, _, _ = P.tim._engine_spec_uneven(
            prof, P.plan.ParallelPlan((s0, s1), 1, 256),
            P.cl.single_zone("A100-40", 256), cfg)
        with pytest.raises(ValueError):
            P.eng.run_interleaved(spec, cfg)


# --- the memory model ---------------------------------------------------------

@pytest.mark.parametrize("arch", ["opt-350m", "smollm_360m"])
@pytest.mark.parametrize("mbs,tp,in_flight,phase,kv", [
    (1, 1, 4.0, "train", 0.0), (4, 2, 1.0, "train", 0.0),
    (8, 4, 0.0, "serve", 3.5e9)])
def test_stage_memory_components_equal(arch, mbs, tp, in_flight, phase, kv):
    got, want = (P.mem.stage_memory_components(
        _profile(P, arch, seq=1024), 0, 7, mbs, tp, in_flight,
        kv_bytes=kv, phase=phase) for P in (T, J))
    assert got == want


@pytest.mark.parametrize("schedule,v", [("1f1b", 1), ("interleaved", 2)])
def test_plan_memory_equal(schedule, v):
    out = []
    for P in (T, J):
        prof = _profile(P, gbs=64)
        plan = P.plan.homogeneous_plan("V100-16", ZONE, 4, 2, 2,
                                       prof.n_partition_units, 2, 64)
        mcfg = dataclasses.replace(P.mem.DEFAULT_MEM, schedule=schedule,
                                   virtual_stages=v)
        out.append((P.mem.plan_memory(prof, plan, mcfg),
                    P.mem.plan_fits(prof, plan, mcfg),
                    P.mem.min_tp_for_stage(prof, 4, 0, 0, 6, 2, "V100-16",
                                           (1, 2, 4, 8), mcfg)))
    assert out[0] == out[1]


@pytest.mark.parametrize("batch,ctx,page", [(1, 16, 16), (8, 549, 16),
                                            (3, 1, 32), (2, 4096, 8)])
def test_kv_cache_bytes_equal_dense(batch, ctx, page):
    for arch in ("smollm_360m", "qwen1_5_0_5b"):
        assert tmem.kv_cache_bytes(tget(arch), batch, ctx, page) == \
            jmem.kv_cache_bytes(jget(arch), batch, ctx, page)


def test_kv_cache_bytes_raises_for_an_unported_family():
    """The reference prices a mamba2 cache from its model's declarations;
    the port has no such model yet and raises as its ``get_module`` does."""
    assert jmem.kv_cache_bytes(jget("mamba2-130m"), 1, 64) > 0
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tmem.kv_cache_bytes(tget("mamba2-130m"), 1, 64)


# --- the paged cache's page budget ------------------------------------------------

def test_paged_cache_page_budget_equal():
    for arch in ("smollm_360m", "qwen1_5_0_5b"):
        for page in (8, 16, 64):
            assert tpaged.page_bytes(tget(arch), page) == \
                jpaged.page_bytes(jget(arch), page)
            for budget in (0.0, -1.0, 1e6, 3.3e9):
                assert tpaged.replica_page_budget(tget(arch), budget, page) \
                    == jpaged.replica_page_budget(jget(arch), budget, page)
    for gpu in ("A100-40", "H100", "V100-16"):
        for batch, tp in ((8, 1), (32, 2)):
            got, want = (P.paged.kv_headroom_bytes(
                P.an.JobProfile(P.an.ServeJob(cfg=P.get("smollm_360m"))),
                0, 32, batch, tp, gpu) for P in (T, J))
            assert got == want


# --- timing, cost and the simulate facade -----------------------------------------

def _hetero_plan(P, prof, gbs):
    units = prof.n_partition_units
    half = units // 2
    a = P.plan.StageReplica("A100-40", 1, ZONE)
    v = P.plan.StageReplica("V100-16", 2, ZONE)
    return P.plan.ParallelPlan(
        (P.plan.StageConfig(0, half, (a, v)),
         P.plan.StageConfig(half, units, (v, a))), 2, gbs)


def _geo_plan(P, prof, gbs):
    units = prof.n_partition_units
    return P.plan.ParallelPlan(
        (P.plan.StageConfig(0, units // 2, (
            P.plan.StageReplica("H100", 1, "za"),
            P.plan.StageReplica("H100", 1, "za"))),
         P.plan.StageConfig(units // 2, units, (
             P.plan.StageReplica("A100-40", 2, "zb"),
             P.plan.StageReplica("A100-40", 2, "zb")))), 1, gbs)


def _scenario(P, kind):
    gbs = 64
    prof = _profile(P, gbs=gbs)
    if kind == "homogeneous":
        return prof, P.plan.homogeneous_plan(
            "A100-40", ZONE, 2, 2, 1, prof.n_partition_units, 2, gbs), \
            P.cl.single_zone("A100-40", 64)
    if kind == "h100":
        prof = _profile(P, "smollm_360m", seq=1024, gbs=8)
        return prof, P.plan.homogeneous_plan(
            "H100", ZONE, 1, 1, 1, prof.n_partition_units, 4, 8), \
            P.cl.single_zone("H100", 1)
    if kind == "heterogeneous":
        return prof, _hetero_plan(P, prof, gbs), P.cl.heterogeneous_zone(
            {"A100-40": 8, "V100-16": 16})
    if kind == "geo":
        return prof, _geo_plan(P, prof, gbs), P.cl.multi_zone({
            "za": ("us-central1", {"H100": 8}),
            "zb": ("europe-west4", {"A100-40": 8})})
    if kind == "adaptive":
        plan = P.plan.adaptive_plan(_hetero_plan(P, prof, gbs), (1.0, 2.5))
        return prof, plan, P.cl.heterogeneous_zone(
            {"A100-40": 8, "V100-16": 16})
    raise ValueError(kind)


SCENARIOS = ["homogeneous", "h100", "heterogeneous", "geo", "adaptive"]


@pytest.mark.parametrize("kind", SCENARIOS)
def test_iteration_time_and_cost_equal(kind):
    out = []
    for P in (T, J):
        prof, plan, cluster = _scenario(P, kind)
        bd = P.tim.iteration_time(prof, plan, cluster)
        out.append((_asdict(bd), _asdict(
            P.tim.closed_form_iteration_time(prof, plan, cluster)),
            P.cost.iteration_cost(prof, plan, cluster, bd.t_iter)))
    assert out[0] == out[1]


@pytest.mark.parametrize("kind", SCENARIOS)
@pytest.mark.parametrize("engine", [None, "interleaved"])
def test_simulate_equals_reference_every_field(kind, engine):
    out = []
    for P in (T, J):
        prof, plan, cluster = _scenario(P, kind)
        cfg = None if engine is None or len({s.dp for s in plan.stages}) \
            != 1 else P.eng.EngineConfig(schedule="interleaved",
                                         virtual_stages=2)
        res = P.sim.simulate(prof, plan, cluster, engine_cfg=cfg)
        out.append(_asdict(res))
    assert out[0] == out[1]
    assert out[0]["t_iter"] > 0


def test_simulate_with_a_kernel_table_equals_reference(tmp_path):
    """A measured H100 table crosses to the reference through its JSON and
    prices the graphed train step's plan alike in both."""
    table = tkc.KernelCostTable(chip="H100")
    table.add("flash_attention", (60, 1024, 1024, 64, 1), "bfloat16", 4e-4)
    table.add("fused_add_rmsnorm", (4096, 960), "bfloat16", 1.4e-5)
    path = tmp_path / "H100.json"
    table.save(str(path))
    datasheet = tsimulate.simulate(*_scenario(T, "h100")).t_iter
    tkc.register_kernel_table(tkc.KernelCostTable.load(str(path)))
    jkc.register_kernel_table(jkc.KernelCostTable.load(str(path)))
    got, want = (_asdict(P.sim.simulate(*_scenario(P, "h100")))
                 for P in (T, J))
    assert got == want
    assert got["t_iter"] != datasheet


def test_simulate_serving_plan_equals_reference():
    out = []
    for P in (T, J):
        job = P.an.ServeJob(cfg=P.get("smollm_360m"), prompt_len=256,
                            max_new_tokens=64, decode_batch=8,
                            arrival_rps=4.0)
        rep = P.plan.StageReplica("A100-40", 1, ZONE)
        splan = P.plan.ServingPlan(decode=(rep, rep))
        res = P.sim.simulate(P.an.JobProfile(job), splan,
                             P.cl.single_zone("A100-40", 8))
        out.append(_asdict(res))
    assert out[0] == out[1]
