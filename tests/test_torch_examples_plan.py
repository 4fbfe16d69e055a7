"""The port's user entry points (``repro_torch/examples/``): their planner
halves against the reference's, their flags and their imports.

The reference's ``examples/geo_cost_planning.py`` and
``examples/quickstart.py`` run at import, so their calls are made here
again on the reference's package; ``examples/serve_batched.py`` guards
its ``main``, so its ``plan_placement`` is called as it is.  Every figure
an example returns must equal the reference's on the same inputs (``==``,
floats bit for bit; search times are not compared).  Neither fleet has an
H100, so the port's ``"H100"`` catalog entry must change nothing: the
reference's catalog is left without it.
"""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import pytest
import torch

from repro.configs import get_config as jget
from repro.core.cluster import multi_zone as jmulti_zone
from repro.core.planner.baselines import dtfm as jdtfm
from repro.core.planner.baselines.common import evaluate_ranked as jevaluate
from repro.core.planner.objectives import MAX_THROUGHPUT, MIN_COST
from repro.core.planner.objectives import Objective as JObjective
from repro.core.planner.search import plan_for as jplan_for
from repro.core.profiler.analytic import JobProfile as JJobProfile
from repro.core.profiler.analytic import TrainJob as JTrainJob
from repro.manager import AvailabilityMonitor as JMonitor
from repro.manager import IncrementalReplanner as JReplanner
from repro.manager import ListFeed as JListFeed
from repro.manager import NodeFailure as JNodeFailure
from repro.manager import PriceChange as JPriceChange
from repro_torch.examples import (elastic_reconfig, geo_cost_planning,
                                  quickstart, serve_batched, train_e2e)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = (geo_cost_planning, quickstart, train_e2e, elastic_reconfig,
            serve_batched)
ON_A_DEVICE = EXAMPLES[1:]      # the planner-only geo example takes none


def _quiet(fn, *args):
    """``fn(*args)`` with its printout kept: (result, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _no_times(x):
    """``x`` without its search and wall times."""
    if isinstance(x, dict):
        return {k: _no_times(v) for k, v in x.items()
                if k not in ("search_time_s", "seconds")}
    if isinstance(x, list):
        return [_no_times(v) for v in x]
    return x


def _reference_example(name):
    """The reference's ``examples/<name>.py`` as a module (its ``main``
    guarded, so importing it runs nothing)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --- geo_cost_planning -------------------------------------------------------------

def _geo_reference():
    """The reference script's calls, its figures in the port's layout."""
    cluster = jmulti_zone(geo_cost_planning.ZONES)
    model = jget(geo_cost_planning.MODEL)
    seq, gbs = geo_cost_planning.SEQ, geo_cost_planning.GBS
    out = {}
    res = jplan_for(model, cluster, JObjective(MAX_THROUGHPUT), seq, gbs)
    out["sailor"] = dict(throughput=res.best.throughput,
                         cost_per_iter=res.best.cost_per_iter,
                         cost_comm=res.best.cost_comm,
                         plan=res.best.plan.describe())
    job = JTrainJob(cfg=model, seq_len=seq, global_batch=gbs)
    bres = jdtfm.plan(job, cluster)
    best, n_oom = jevaluate(bres, JJobProfile(job), cluster,
                            JObjective(MAX_THROUGHPUT))
    out["dtfm"] = dict(throughput=best.throughput,
                       cost_per_iter=best.cost_per_iter, n_oom=n_oom,
                       plan=best.plan.describe(),
                       speedup=res.best.throughput / best.throughput,
                       saving=best.cost_per_iter / res.best.cost_per_iter)
    out["budget"] = []
    for cap in (0.10, 0.25, 0.50, 1.00):
        r = jplan_for(model, cluster,
                      JObjective(MAX_THROUGHPUT, max_cost_per_iter=cap),
                      seq, gbs)
        out["budget"].append(
            dict(cap=cap, throughput=r.best.throughput,
                 n_chips=r.best.plan.n_chips,
                 cost_per_iter=r.best.cost_per_iter) if r.best
            else dict(cap=cap, throughput=None))
    replanner = JReplanner(job, JObjective(
        MIN_COST, min_throughput=res.best.throughput * 0.2))
    base = replanner.replan(cluster)
    out["spot_baseline"] = dict(cost_per_iter=base.best.cost_per_iter,
                                n_chips=base.best.plan.n_chips,
                                cache=base.stats["cache"])
    west = cluster.with_price({("us-west1-a", "A100-40"): 1.20})
    feed = JListFeed([
        (600.0, west),
        (1200.0, west.with_capacity({("us-west1-a", "A100-40"): 16})),
        (1800.0, cluster)])
    out["spot"] = []
    for ev in JMonitor(cluster, [feed]).drain():
        if not isinstance(ev, (JPriceChange, JNodeFailure)):
            continue
        r = replanner.replan(ev.cluster)
        by_zone = {}
        for s in r.best.plan.stages:
            for rep in s.replicas:
                by_zone[rep.zone] = by_zone.get(rep.zone, 0) + rep.tp
        out["spot"].append(dict(event=ev.describe(),
                                cost_per_iter=r.best.cost_per_iter,
                                chips=by_zone, cache=r.stats["cache"]))
    out["replanner"] = dict(replanner.stats)
    return out


def test_geo_cost_planning_figures_equal_the_reference():
    got, text = _quiet(geo_cost_planning.main, [])
    assert _no_times(got) == _geo_reference()
    # the reference's report lines, in its order
    heads = [line for line in text.splitlines() if line.startswith("===")]
    assert heads == [
        "=== Sailor: max throughput across 5 zones / 2 regions ===",
        "=== DTFM baseline on the same fleet ===",
        "=== budget sweep: what does a $/iter cap cost in throughput? ===",
        "=== spot market: PriceChange events -> min-cost replans ==="]
    assert "Sailor vs DTFM: 2.3x throughput" in text
    assert [s["cache"] for s in got["spot"]] == ["warm", "warm", "hit"]


# --- quickstart's planning half ------------------------------------------------------

def test_quickstart_plans_equal_the_reference():
    got, text = _quiet(quickstart.plan)
    best = got.pop("best")
    cluster = jmulti_zone(quickstart.ZONES)
    model = jget(quickstart.MODEL)
    seq, gbs = quickstart.SEQ, quickstart.GBS
    res = jplan_for(model, cluster, JObjective(MAX_THROUGHPUT), seq, gbs)
    res2 = jplan_for(model, cluster, JObjective(MIN_COST, min_throughput=0.1),
                     seq, gbs, max_pp=8)
    jb, jb2, t = res.best, res2.best, res.best.timing
    want = dict(
        throughput=dict(throughput=jb.throughput,
                        samples_per_s=jb.samples_per_s,
                        cost_per_iter=jb.cost_per_iter,
                        plan=jb.plan.describe(), pp=jb.plan.pp,
                        n_evaluated=res.n_evaluated, n_oom=res.n_oom),
        min_cost=dict(throughput=jb2.throughput,
                      cost_per_iter=jb2.cost_per_iter,
                      n_chips=jb2.plan.n_chips, plan=jb2.plan.describe()),
        simulator=dict(t_iter=t.t_iter, t_pp=t.t_pp, t_sync=t.t_sync,
                       t_update=t.t_update,
                       straggler_stage=t.straggler_stage,
                       worst_peak_bytes=max(r["peak"] for row in jb.peak_mem
                                            for r in row)))
    assert _no_times(got) == want
    assert best.plan.describe() == jb.plan.describe()
    # the execute rule on 8 positions: the plan's 2 stages at tp 4 and 2
    assert quickstart.stage_tps(best.plan.pp, 8) == [4, 2]
    assert quickstart.stage_tps(best.plan.pp, 1) == [1]
    assert "[simulator] t_iter=" in text


def test_quickstart_execute_config_is_the_reference_cut():
    """The executed model: ``opt-350m`` untied at published widths and
    depth on the card, the reference's 4-layer reduced cut with
    ``--reduced``."""
    import dataclasses
    full = quickstart.execute_config(False)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.hd, full.d_ff, full.ffn_act, full.vocab_size,
            full.tie_embeddings) == (24, 1024, 16, 16, 64, 4096, "gelu",
                                     50272, False)
    want = dataclasses.replace(jget("opt-350m").reduced(), n_layers=4,
                               tie_embeddings=False)
    assert dataclasses.asdict(quickstart.execute_config(True)) == \
        dataclasses.asdict(want)


# --- serve_batched's planning half ---------------------------------------------------

def test_serve_plan_equals_the_reference():
    ref = _reference_example("serve_batched")
    jb, jtext = _quiet(ref.plan_placement)
    got, text = _quiet(serve_batched.plan_placement)
    best = got.pop("best")
    n_evaluated = int(re.search(r"\((\d+) candidates", jtext).group(1))
    assert _no_times(got) == dict(
        plan=jb.plan.describe(), decode_batch=jb.plan.decode_batch,
        ttft_p99=jb.ttft_p99, tpot_p99=jb.tpot_p99,
        tokens_per_s=jb.tokens_per_s, cost_per_token=jb.cost_per_token,
        n_evaluated=n_evaluated)
    assert best.plan.decode_batch == 8
    # the same report after the timing
    assert text.split("\n", 1)[1] == jtext.split("\n", 1)[1]


def test_train_e2e_config_is_the_reference_one():
    import dataclasses
    ref = _reference_example("train_e2e")
    assert dataclasses.asdict(train_e2e.CFG) == dataclasses.asdict(ref.CFG)


# --- flags and imports ---------------------------------------------------------------

@pytest.mark.parametrize("mod", ON_A_DEVICE, ids=lambda m: m.__name__)
@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]])
def test_examples_refuse_cuda_without_a_card(monkeypatch, mod, argv):
    """``--device`` defaults to cuda; with no card every example that
    runs a model raises before it plans or builds anything, and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv + ["--reduced"])
    assert buf.getvalue() == ""


_IMPORT = r"""
import importlib, sys
sys.path.insert(0, {src!r})
import torch
for name in {names!r}:
    importlib.import_module("repro_torch.examples." + name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "repro"
             or n.startswith("repro."))
assert not bad, bad
assert not torch.cuda.is_initialized()
print("ok")
"""


def test_importing_the_examples_runs_nothing():
    """Importing every example prints nothing but the script's own line,
    initialises no CUDA and loads neither JAX nor the reference."""
    names = [m.__name__.rsplit(".", 1)[1] for m in EXAMPLES] + ["common"]
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT.format(
            src=os.path.join(ROOT, "src"), names=names)],
        capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout == "ok\n", out.stdout


@pytest.mark.parametrize("mod", EXAMPLES, ids=lambda m: m.__name__)
def test_examples_run_as_modules(mod):
    """``python -m repro_torch.examples.<name> --help`` parses its flags
    and runs nothing else."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-m", mod.__name__, "--help"],
                         capture_output=True, text=True, check=True,
                         env=env, cwd=ROOT)
    assert ("--device" in out.stdout) == (mod in ON_A_DEVICE)
