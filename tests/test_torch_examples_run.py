"""The port's user entry points (``repro_torch/examples/``) run on CPU
positions at the reference's sizes, against the reference.

* quickstart's execute half on ``[cpu] * 8`` at tps ``[4, 2]``: its three
  losses against the reference's one-device jitted ``make_train_step``
  on the same numpy weights and batch (``test_torch_pipeline.py``'s
  1e-5; the reference's own pipeline fails on this jax: ``ROADMAP.md``
  §3, R2); ``opt-350m``'s gelu FFN on a ``[2, 1]`` mesh-stage pipeline,
  its loss and gradients against the reference's ``loss_and_grads``;
* train_e2e's first loss against the reference's jitted
  ``make_train_step`` on the same weights and batch (rtol 1e-5, as
  ``test_torch_train.py``; the reference's trainer fails: R1), and its
  resume check bit for bit;
* the elastic loop's decisions against the reference's ``Controller``
  over a stub trainer on the same trace (its real trainer fails: R1),
  and the trace's events and replans against the reference's;
* serve_batched's tokens and ``ServerStats`` against the reference's
  ``ContinuousBatchingServer`` on the same numpy weights and requests.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs import get_config as jget
from repro.core.cluster import AvailabilityTrace as JTrace
from repro.core.cluster import single_zone as jsingle_zone
from repro.core.planner.objectives import MAX_THROUGHPUT
from repro.core.planner.objectives import Objective as JObjective
from repro.core.profiler.analytic import TrainJob as JTrainJob
from repro.manager import (AvailabilityMonitor as JMonitor,
                           Controller as JController,
                           ControllerConfig as JControllerConfig,
                           IncrementalReplanner as JReplanner,
                           TraceFeed as JTraceFeed,
                           TransitionConfig as JTransitionConfig,
                           TransitionModel as JTransitionModel)
from repro.models import model as jm
from repro.serve.scheduler import ContinuousBatchingServer as JServer
from repro.serve.serve_step import Request as JRequest
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro.train.checkpoint import _flatten, _unflatten
from repro_torch import bridge
from repro_torch.core.planner.objectives import Objective
from repro_torch.core.profiler.analytic import TrainJob
from repro_torch.dist import pipeline as tpl
from repro_torch.dist import placement as pm
from repro_torch.examples import (elastic_reconfig, quickstart,
                                  serve_batched, train_e2e)
from repro_torch.manager import AvailabilityMonitor, IncrementalReplanner
from repro_torch.manager import TraceFeed
from repro_torch.models import model as tm
from repro_torch.train import optimizer as topt
from test_torch_examples_plan import _reference_example
from test_torch_manager import _decisions, _StubTrainer
from test_torch_model import numpy_params
from test_torch_pipeline import TOL, _close

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return fn(*args)


def _jparams(jcfg, flat):
    """The reference's params tree of the numpy weights ``flat``."""
    return jax.tree.map(jnp.asarray, _unflatten(jm.decls(jcfg), flat))


def _opt_configs():
    """The reference's executed cut of ``opt-350m`` in both packages."""
    jcfg = dataclasses.replace(jget("opt-350m").reduced(), n_layers=4,
                               tie_embeddings=False)
    return jcfg, quickstart.execute_config(True)


# --- quickstart's execute half -------------------------------------------------------

def test_quickstart_execute_matches_the_reference_step():
    """The reference's execute half on ``[cpu] * 8`` (tps ``[4, 2]``,
    tokens (2, 4, 33) from ``default_rng(0)``): each of the 3 losses
    within 1e-5 of the reference's jitted ``make_train_step`` from the
    same numpy weights, and falling."""
    jcfg, tcfg = _opt_configs()
    flat = numpy_params(jcfg, 3)
    batch = quickstart.tokens(tcfg, quickstart.REDUCED_BATCH)
    assert batch["tokens"].shape == (2, 4, 32)
    run = quickstart.execute(tcfg, [4, 2], CPU8, batch,
                             full=bridge.params_from_numpy(tcfg, flat,
                                                           device="cpu"))
    jp = _jparams(jcfg, flat)
    state = jopt.init_state(jp)
    step = jax.jit(jts.make_train_step(
        jcfg, jopt.OptimizerConfig(lr=quickstart.LR)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want = []
    for _ in range(3):
        jp, state, m = step(jp, state, jbatch)
        want.append(float(m["loss"]))
    for got, w in zip(run["losses"], want, strict=True):
        assert abs(got - w) <= TOL * abs(w), (run["losses"], want)
    assert run["losses"][-1] < run["losses"][0]
    assert run["graphed_stages"] == [False, False]


def test_quickstart_main_reduced_on_cpu():
    """``main(["--reduced", "--device", "cpu"])``: the plan's 2 stages at
    tps [4, 2] on 8 positions, losses falling."""
    out = _quiet(quickstart.main, ["--reduced", "--device", "cpu"])
    ex = out["execute"]
    assert (ex["tps"], ex["positions"], ex["n_layers"], ex["batch"]) == \
        ([4, 2], 8, 4, [2, 4, 32])
    assert ex["losses"][-1] < ex["losses"][0]
    assert out["throughput"]["pp"] == 2


def test_opt_gelu_ffn_on_mesh_stages_matches_the_reference():
    """``opt-350m``'s non-gated gelu FFN (``w_up`` / ``w_down``) split over
    'model' on a ``[2, 1]`` mesh-stage pipeline: the loss and every
    stage's gradients within 1e-5 of the reference's one-device
    ``loss_and_grads`` on the same numpy weights and batch."""
    jcfg, tcfg = _opt_configs()
    flat = numpy_params(jcfg, 4)
    full = bridge.params_from_numpy(tcfg, flat, device="cpu")
    pipe = tpl.MPMDPipeline(tcfg, tpl.even_stages(tcfg, [2, 1]),
                            topt.OptimizerConfig(), devices=["cpu"] * 3)
    pipe.full_params_like(full)
    up = dict(pm.tree_items(pipe.params[0]))["layers/w_up"]
    assert "model" in str(up.spec), up.spec
    batch = quickstart.tokens(tcfg, (2, 4, 16), seed=1)
    loss, grads = pipe.grad_step(batch)
    wl, wg = jts.loss_and_grads(jcfg, _jparams(jcfg, flat), {
        k: jnp.asarray(v) for k, v in batch.items()}, None)
    assert abs(loss - float(wl)) <= TOL * abs(loss)
    want = _flatten(wg)
    for st, g in zip(pipe.stages, grads):
        for k, x in pm.tree_items(g):
            w = want[k][st.start:st.stop] if k.startswith("layers/") \
                else want[k]
            _close(tpl._full(x), w, f"stage {st.index} {k}")


# --- train_e2e -----------------------------------------------------------------------

def test_train_e2e_reduced_first_loss_and_resume(tmp_path):
    """4 steps of the reduced config, a checkpoint every 2: the first
    loss within rtol 1e-5 of the reference's jitted step on the same
    weights (``model.init(cfg, 0)`` on the CPU, what ``build(1)`` draws)
    and batch; the resume at step 4, its 3 losses the uninterrupted
    trainer's bit for bit."""
    out = _quiet(train_e2e.main, [
        "--reduced", "--device", "cpu", "--steps", "4",
        "--checkpoint-every", "2", "--workdir", str(tmp_path)])
    assert (out["resumed_at"], out["latest_checkpoint"]) == (4, 4)
    assert out["bit_identical"] and out["resumed_losses"] == \
        out["uninterrupted_losses"]
    assert out["losses"][-1] < out["losses"][0]
    jcfg = _reference_example("train_e2e").CFG.reduced()
    tcfg = train_e2e.CFG.reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    flat = bridge.params_to_numpy(tm.init(tcfg, 0, device="cpu"))
    jp = _jparams(jcfg, flat)
    dc = jdata.DataConfig(seq_len=train_e2e.SEQ_LEN,
                          global_batch=train_e2e.GLOBAL_BATCH,
                          num_microbatches=train_e2e.NUM_MICRO)
    batch = jdata.SyntheticDataset(jcfg, dc).batch(0)
    step = jax.jit(jts.make_train_step(jcfg, jopt.OptimizerConfig(
        lr=6e-4, warmup_steps=20, total_steps=4)))
    _, _, m = step(jp, jopt.init_state(jp),
                   {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out["losses"][0], float(m["loss"]),
                               rtol=1e-5)


# --- elastic_reconfig ----------------------------------------------------------------

def _jtrace():
    return JTrace(jsingle_zone("cpu-host", elastic_reconfig.ZONE_DEVICES),
                  seed=4, step_s=60, horizon_s=3600, preempt_prob=0.25)


def test_elastic_trace_events_and_replans_equal_the_reference():
    """The monitor's events over the example's trace, and the
    replanner's plan at each change point, in order, against the
    reference's over its own trace."""
    def run(trace, monitor, feed, replanner, job, objective):
        out = []
        rp = replanner(job, objective)
        for ev in monitor(trace.cluster, [feed(trace)]).drain():
            r = rp.replan(ev.cluster)
            b = r.best          # None where no chip is left
            out.append((ev.describe(), r.stats["cache"]) + (() if b is None
                       else (b.plan.describe(), b.t_iter, b.cost_per_iter)))
        return out, dict(rp.stats)

    data = elastic_reconfig.DATA
    jcfg = jget(elastic_reconfig.ARCH).reduced()
    tcfg = elastic_reconfig.get_config(elastic_reconfig.ARCH).reduced()
    want = run(_jtrace(), JMonitor, JTraceFeed, JReplanner,
               JTrainJob(cfg=jcfg, seq_len=data["seq_len"],
                         global_batch=data["global_batch"]),
               JObjective(MAX_THROUGHPUT))
    got = run(elastic_reconfig.trace(), AvailabilityMonitor, TraceFeed,
              IncrementalReplanner,
              TrainJob(cfg=tcfg, seq_len=data["seq_len"],
                       global_batch=data["global_batch"]),
              Objective(MAX_THROUGHPUT))
    assert got == want
    assert len(got[0]) > 20


def _reference_on_a_stub(jcfg):
    """The reference's controller over a stub trainer (steps, checkpoints
    every 8 and rollbacks counted, no model) on the example's trace and
    data, its replanner pricing ``jcfg``: 60 steps."""
    data = elastic_reconfig.DATA
    trainer = _StubTrainer(data["global_batch"], 1,
                           elastic_reconfig.CHECKPOINT_EVERY)
    jtrace = _jtrace()
    ctl = JController(
        trainer, JMonitor(jtrace.cluster, [JTraceFeed(jtrace)]),
        JReplanner(JTrainJob(cfg=jcfg, seq_len=data["seq_len"],
                             global_batch=data["global_batch"]),
                   JObjective(MAX_THROUGHPUT)),
        transition=JTransitionModel(JTransitionConfig(hysteresis_s=120.0)),
        config=JControllerConfig(step_time_s=60.0,
                                 max_devices=elastic_reconfig.ZONE_DEVICES))
    ctl.run(elastic_reconfig.STEPS)
    return ctl, trainer


def test_manager_phase_holds_the_card_to_the_reference_decisions():
    """``chip_smoke.py``'s ``[manager]`` (a) runs the example's loop at
    published widths on the card and holds it to ``MANAGER_OUTCOMES``
    and ``MANAGER_RECONFIGS``: the reference controller's decisions and
    reconfigurations (kind, devices, step, resumed at) over a stub
    trainer on the same trace, its replanner pricing smollm-360M."""
    ctl, trainer = _reference_on_a_stub(jget(elastic_reconfig.ARCH))
    assert [d["action"] for d in _decisions(ctl)] == \
        list(chip_smoke.MANAGER_OUTCOMES)
    assert [(r["kind"], r["n_devices"], r["step"], r["resumed_at"])
            for r in trainer.reconfigs] == \
        [tuple(r) for r in chip_smoke.MANAGER_RECONFIGS]
    plans = {d["n_devices"] for d in ctl.decisions}
    assert plans <= set(chip_smoke.MANAGER_DP), plans


def test_elastic_reconfig_reduced_takes_the_reference_decisions(tmp_path):
    """The example on ``[cpu] * 8`` (the reduced smollm, 60 steps): its
    decisions (without straggler rows, which wall time flags) are the
    reference controller's over a stub trainer on the same trace, the
    reconfigurations follow them, every rollback resumes at a
    checkpoint's step and the loss falls."""
    out = _quiet(elastic_reconfig.main, [
        "--reduced", "--device", "cpu", "--workdir", str(tmp_path)])
    ctl, trainer = _reference_on_a_stub(
        jget(elastic_reconfig.ARCH).reduced())
    assert [d for d in out["decisions"] if not d.get("straggler")] == \
        _decisions(ctl)
    assert [(r["kind"], r["n_devices"], r["step"], r["resumed_at"])
            for r in out["reconfigs"]] == \
        [(r["kind"], r["n_devices"], r["step"], r["resumed_at"])
         for r in trainer.reconfigs]
    kinds = {r["kind"] for r in out["reconfigs"]}
    assert kinds == {"kill-free", "rollback"}
    assert all(r["resumed_at"] % 8 == 0 for r in out["reconfigs"]
               if r["kind"] == "rollback")
    assert len(out["losses"]) == 60 and out["positions"] == 8
    assert out["losses"][-1] < out["losses"][0]


# --- serve_batched -------------------------------------------------------------------

def test_serve_batched_reduced_equals_the_reference_server():
    """The reduced qwen on the same numpy weights and the reference's 8
    requests at the planned decode batch: tokens and ``ServerStats``
    equal to the reference's ``ContinuousBatchingServer``."""
    jcfg = jget(serve_batched.ARCH).reduced()
    tcfg = serve_batched.get_config(serve_batched.ARCH).reduced()
    flat = numpy_params(jcfg, 6)
    got = _quiet(serve_batched.serve_locally, tcfg,
                 bridge.params_from_numpy(tcfg, flat, device="cpu"), 8)
    reqs = [JRequest(rid=r.rid, prompt=r.prompt,
                     max_new_tokens=r.max_new_tokens)
            for r in serve_batched.requests(tcfg)]
    server = JServer(jcfg, _jparams(jcfg, flat), max_slots=8,
                     max_ctx=serve_batched.MAX_CTX)
    server.run(reqs)
    assert got["outputs"] == [list(map(int, r.output)) for r in reqs]
    assert got["stats"] == dataclasses.asdict(server.stats)
    assert [len(o) for o in got["outputs"]] == [4 + 2 * i for i in range(8)]


def test_serve_batched_main_reduced_on_cpu():
    out = _quiet(serve_batched.main, ["--reduced", "--device", "cpu"])
    assert out["decode_batch"] == 8 and not out["serve"]["graphed"]
    assert out["serve"]["tokens"] == sum(4 + 2 * i for i in range(8))
