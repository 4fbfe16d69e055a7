"""The port's elastic trainer (``repro_torch/train/elastic.py``) and
training entry point (``repro_torch/launch/train.py``), on CPU positions
(``devices=["cpu"] * n``: one process runs every mesh position).

The reference's own elastic scenarios fail on this jax (``ROADMAP.md``
§3, R1), so they are held to their stated invariants, not to its
numbers; the plain copies (``StragglerDetector``, ``RuntimePlan``) are
held ``==`` to the reference's.  A (1, 1) trainer is held against the
port's single-device ``make_train_step`` (loss 1e-5; params at the
reference's sharded test's rtol 2e-3 / atol 2e-4, as in
``test_torch_mesh.py``), and a kill-free reshard must leave the state
bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import elastic as jel
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JManager
from repro.train.checkpoint import _flatten as j_flatten
from repro.train.checkpoint import _unflatten as j_unflatten
from repro.models import model as jm
from repro_torch.configs import get_config
from repro_torch.core.cluster import heterogeneous_zone
from repro_torch.core.planner.objectives import MAX_THROUGHPUT, Objective
from repro_torch.core.planner.search import plan_for
from repro_torch.dist import placement as pm
from repro_torch.launch import train as launch_train
from repro_torch.models import model as tm
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts
from repro_torch.train.elastic import (ElasticTrainer, RuntimePlan,
                                       StragglerDetector)
from test_torch_model import numpy_params

LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4


def _cfg(**kw):
    return dataclasses.replace(get_config("smollm_360m").reduced(), **kw)


def _opt():
    return topt.OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=30)


def _state(tr):
    """The trainer's params, ``m``, ``v`` and step gathered whole."""
    return {k: pm.unshard(x, "cpu") for k, x in pm.tree_items(
        {"params": tr.params, "opt": tr.opt_state})}


def _plans(*shapes):
    """A ``plan_fn`` that hands out (dp, tp) plans in order."""
    it = iter(shapes)
    return lambda n: RuntimePlan(n, *next(it), num_microbatches=1)


# --- the plain copies ---------------------------------------------------------------

_STRAGGLER_CASES = [
    # tests/test_manager.py:227-270
    (dict(factor=3.0, window=10, warmup=5),
     [10.0] * 4 + [0.1, 40.0]),
    (dict(factor=3.0, window=5, warmup=5),
     [0.1] * 20 + [0.9, 0.35] + [0.9] * 3 + [0.35]),
    (dict(factor=3.0, window=5, warmup=5), [9.0] + [0.1] * 5 + [0.35]),
    # tests/test_system.py::test_straggler_detection
    (dict(factor=3.0), [0.1] * 10 + [0.5, 0.12]),
]


@pytest.mark.parametrize("case", range(len(_STRAGGLER_CASES) + 3))
def test_straggler_detector_equals_the_reference(case):
    if case < len(_STRAGGLER_CASES):
        kw, times = _STRAGGLER_CASES[case]
    else:
        rng = np.random.default_rng(case)
        kw = dict(factor=float(rng.uniform(1.5, 4)),
                  window=int(rng.integers(3, 25)),
                  warmup=int(rng.integers(1, 8)))
        times = list(rng.lognormal(0.0, 0.6, size=80))
    mine, ref = StragglerDetector(**kw), jel.StragglerDetector(**kw)
    for step, dt in enumerate(times):
        assert mine.observe(step, dt) == ref.observe(step, dt), (step, dt)
        assert mine.times == ref.times
    assert mine.events == ref.events


def test_runtime_plan_equals_the_reference():
    for fields in ((8, 4, 2, 2, None), (4, 4, 1, 2, (0.75, 0.25))):
        mine, ref = RuntimePlan(*fields), jel.RuntimePlan(*fields)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.mesh_shape() == ref.mesh_shape()
    with pytest.raises(AssertionError):
        RuntimePlan(4, 2, 1).mesh_shape()


# --- the reference's scenarios, held to their invariants -------------------------------

def test_elastic_resize_and_rollback(tmp_path):
    """``tests/test_distributed.py::test_elastic_resize_and_rollback`` on
    8 CPU positions: a kill-free resize to 4 at step 6, a failure down to
    8 at step 12 that rolls back to the step-10 checkpoint."""
    tr = ElasticTrainer(
        _cfg(), _opt(), data_lib.DataConfig(seq_len=16, global_batch=8,
                                            num_microbatches=1),
        workdir=str(tmp_path), checkpoint_every=5, devices=["cpu"] * 8)
    log = tr.train(16, events=[(6, 4, False), (12, 8, True)])
    kinds = [r["kind"] for r in tr.reconfigs]
    assert kinds == ["kill-free", "rollback"], tr.reconfigs
    # rollback at step 12 restored the step-10 checkpoint, so steps
    # 10-11 re-run: 16 unique steps + 2 replayed
    assert len(log) == 18, [r["step"] for r in log]
    assert log[-1]["loss"] < log[0]["loss"]
    assert tr.reconfigs[1]["step"] == 12
    assert tr.reconfigs[1]["resumed_at"] == 10
    assert [r["n_devices"] for r in log] == [8] * 6 + [4] * 6 + [8] * 6
    assert dict(tr.mesh.shape) == {"data": 8, "model": 1}
    # the replayed steps train from the same state on the same batches
    # (8 positions again), so they repeat the first run's losses
    first = {r["step"]: r["loss"] for r in log[:12]}
    for r in log[12:14]:
        assert abs(r["loss"] - first[r["step"]]) <= LOSS_RTOL * r["loss"]
    tr.ckpt.wait()
    assert tr.ckpt.steps() == [5, 10, 15]


def test_plan_then_train_then_restore(tmp_path):
    """``tests/test_system.py::test_plan_then_train_then_restore``: the
    port's planner picks a configuration for a simulated cluster; the
    elastic trainer runs the reduced model; a fresh trainer resumes from
    the step-10 checkpoint and reproduces step 10's loss (1e-4)."""
    cluster = heterogeneous_zone({"A100-40": 8, "V100-16": 8})
    res = plan_for(get_config("smollm_360m"), cluster,
                   Objective(MAX_THROUGHPUT), seq_len=2048, global_batch=256)
    assert res.best is not None and res.best.valid
    assert res.search_time_s < 120

    data_cfg = data_lib.DataConfig(seq_len=16, global_batch=4)
    tr = ElasticTrainer(_cfg(), _opt(), data_cfg, workdir=str(tmp_path),
                        checkpoint_every=5,
                        plan_fn=lambda n: RuntimePlan(1, 1, 1, 1),
                        devices=["cpu"])
    tr.build(1)
    log = tr.train(11)
    assert log[-1]["loss"] < log[0]["loss"]
    tr.ckpt.wait()
    loss_at_10 = [r for r in tr.log if r["step"] == 10][0]["loss"]

    tr2 = ElasticTrainer(_cfg(), _opt(), data_cfg, workdir=str(tmp_path),
                         checkpoint_every=100,
                         plan_fn=lambda n: RuntimePlan(1, 1, 1, 1),
                         devices=["cpu"])
    tr2.restore_from_checkpoint(1)
    assert tr2.step == 10
    log2 = tr2.train(1)
    assert abs(log2[-1]["loss"] - loss_at_10) < 1e-4


def test_same_step_events_apply_in_order(tmp_path):
    tr = ElasticTrainer(_cfg(), _opt(),
                        data_lib.DataConfig(seq_len=16, global_batch=4),
                        workdir=str(tmp_path), checkpoint_every=100,
                        plan_fn=lambda n: RuntimePlan(n, n, 1, 1),
                        devices=["cpu"] * 2)
    tr.build(1)
    tr.train(5, events=[(2, 2, False), (2, 1, False)])
    assert len(tr.reconfigs) == 2
    assert [r["kind"] for r in tr.reconfigs] == ["kill-free", "kill-free"]
    assert all(r["step"] == 2 for r in tr.reconfigs)
    assert [r["n_devices"] for r in tr.reconfigs] == [2, 1]
    assert tr.plan.n_devices == 1


# --- against the single-device step, and the reshard ----------------------------------

def test_one_position_trainer_matches_make_train_step(tmp_path):
    cfg = _cfg(sharding="fsdp_tp")
    dc = data_lib.DataConfig(seq_len=16, global_batch=4, num_microbatches=2)
    tr = ElasticTrainer(cfg, _opt(), dc, workdir=str(tmp_path),
                        checkpoint_every=100, devices=["cpu"])
    tr.build(1, init_seed=4)
    log = tr.train(3)
    params = tm.init(cfg, 4, device="cpu")
    state = topt.init_state(params)
    step = tts.make_train_step(cfg, _opt())
    for i in range(3):
        params, state, m = step(params, state, tr.data.batch(i))
        assert abs(log[i]["loss"] - m["loss"].item()) <= \
            LOSS_RTOL * abs(log[i]["loss"]), i
    got = _state(tr)
    for k, t in topt.tree_leaves(params):
        np.testing.assert_allclose(got["params/" + k].numpy(), t.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    assert int(got["opt/step"]) == 3


def test_kill_free_reshard_leaves_the_state_bit_for_bit(tmp_path):
    """(1, 1) -> (2, 2) -> (4, 1) on 4 CPU positions under ``fsdp_tp``:
    the unsharded params, ``m``, ``v`` and step equal bit for bit after
    each reshard, and the next step's loss matches a trainer that stayed
    on (1, 1) (1e-5)."""
    cfg = _cfg(sharding="fsdp_tp")
    dc = data_lib.DataConfig(seq_len=16, global_batch=4)
    tr = ElasticTrainer(cfg, _opt(), dc, workdir=str(tmp_path / "a"),
                        checkpoint_every=100, devices=["cpu"] * 4,
                        plan_fn=_plans((1, 1), (2, 2), (4, 1)))
    stay = ElasticTrainer(cfg, _opt(), dc, workdir=str(tmp_path / "b"),
                          checkpoint_every=100, devices=["cpu"],
                          plan_fn=_plans((1, 1)))
    tr.build(1)
    stay.build(1)
    tr.train(2)
    stay.train(2)
    before = _state(tr)
    for shape in ((2, 2), (4, 1)):
        tr.on_availability_change(4)
        assert dict(tr.mesh.shape) == dict(zip(("data", "model"), shape))
        after = _state(tr)
        assert after.keys() == before.keys()
        assert all(torch.equal(after[k], before[k]) for k in before)
        # the layout is the new mesh's: some leaf is really split
        assert any(len({b.data_ptr() for b in x.blocks}) > 1
                   and x.blocks[0].shape != tuple(x.shape)
                   for _, x in pm.tree_items(tr.params))
    assert [r["kind"] for r in tr.reconfigs] == ["kill-free"] * 2
    tr.train(1)
    stay.train(1)
    assert abs(tr.log[-1]["loss"] - stay.log[-1]["loss"]) <= \
        LOSS_RTOL * abs(stay.log[-1]["loss"])
    assert tr.log[-1]["n_devices"] == 4


def test_rollback_restores_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference's manager wrote (params and AdamW state
    at step 5) restores onto a (2, 1) mesh bit for bit, and training goes
    on from step 5."""
    cfg = _cfg()
    jcfg = dataclasses.replace(jax_reduced(), sharding=cfg.sharding)
    flat = numpy_params(jcfg, 6)
    jp = jax.tree.map(jnp.asarray, j_unflatten(jm.decls(jcfg), flat))
    jo = jopt.init_state(jp)
    jo["step"] = jnp.asarray(5, jnp.int32)
    JManager(str(tmp_path)).save(5, {"params": jp, "opt": jo}, blocking=True)
    tr = ElasticTrainer(cfg, _opt(), data_lib.DataConfig(seq_len=16,
                                                         global_batch=4),
                        workdir=str(tmp_path), checkpoint_every=100,
                        devices=["cpu"] * 2)
    tr.restore_from_checkpoint(2)
    assert tr.step == 5 and dict(tr.mesh.shape) == {"data": 2, "model": 1}
    got = _state(tr)
    for k, a in j_flatten({"params": jp, "opt": jo}).items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(a),
                                      err_msg=k)
    log = tr.train(1)
    assert log[0]["step"] == 5 and np.isfinite(log[0]["loss"])


def jax_reduced():
    from repro.configs import get_config as jget
    return jget("smollm_360m").reduced()


# --- telemetry ---------------------------------------------------------------------

def test_elastic_trainer_emits_telemetry(tmp_path):
    """The reference's ``test_elastic_trainer_emits_telemetry``
    (``tests/test_telemetry.py:445-470``) on the port, on two CPU
    positions: a ``step_time``, ``data_stall`` (>= 0) and heartbeat a
    step at the pinned clock, the heartbeat's ``chips`` the plan's
    positions, ``end_step`` a step; and the losses of a detached trainer
    from the same seed, bit for bit."""
    from repro_torch.telemetry import TelemetryBus
    cfg = _cfg()
    dc = data_lib.DataConfig(seq_len=16, global_batch=8)
    bus = TelemetryBus()
    ends = []
    bus.on_step(lambda step, t: ends.append((step, t)))
    tr = ElasticTrainer(cfg, _opt(), dc, str(tmp_path / "on"),
                        checkpoint_every=100, telemetry=bus,
                        devices=["cpu"] * 2)
    tr.clock = lambda: 123.0            # pinned clock (controller mode)
    tr.train(5)
    assert len(bus.values("step_time", ())) == 5
    assert len(bus.values("data_stall", ())) == 5
    hb = bus.latest("heartbeat", (0, 0))
    assert hb.meta == {"zone": "local", "acc_type": "host",
                       "chips": tr.plan.n_devices} and tr.plan.n_devices == 2
    assert hb.time_s == 123.0
    assert all(v >= 0 for v in bus.values("data_stall", ()))
    assert bus.values("step_time", ()) == [r["time_s"] for r in tr.log]
    assert ends == [(i, 123.0) for i in range(5)]
    off = ElasticTrainer(cfg, _opt(), dc, str(tmp_path / "off"),
                         checkpoint_every=100, devices=["cpu"] * 2)
    off.train(5)
    assert [r["loss"] for r in off.log] == [r["loss"] for r in tr.log]
    # without a pinned clock the samples carry the wall clock
    tr.clock = None
    tr.train(1)
    assert bus.latest("step_time", ()).time_s > 1e9


# --- what raises ---------------------------------------------------------------------

def test_elastic_refusals(tmp_path, monkeypatch):
    cfg, dc = _cfg(), data_lib.DataConfig(seq_len=16, global_batch=4)
    tr = ElasticTrainer(cfg, _opt(), dc, str(tmp_path), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="has 2 devices"):
        tr.build(3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticTrainer(cfg, _opt(), dc, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "smollm_360m", "--reduced",
                           "--workdir", str(tmp_path)])


# --- launch/train.py ------------------------------------------------------------------

def test_launch_train_plans_and_trains_on_the_cpu(tmp_path, capsys):
    res, tr = launch_train.main([
        "--arch", "smollm_360m", "--reduced", "--device", "cpu", "--plan",
        "--cluster", "H100:8", "--steps", "6", "--seq-len", "32",
        "--lr", "1e-2", "--checkpoint-every", "3",
        "--workdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res.best is not None and res.best.valid
    assert "H100" in res.best.plan.describe()
    lines = out.splitlines()
    assert lines[0].startswith("[planner] search=")
    assert any(ln.startswith("[train] 6 steps in ") for ln in lines)
    losses = [r["loss"] for r in tr.log]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert dict(tr.mesh.shape) == {"data": 1, "model": 1}
    tr.ckpt.wait()
    assert tr.ckpt.steps() == [3, 6]
    assert launch_train.parse_cluster("a100:8,H100:4") == \
        heterogeneous_zone({"A100-40": 8, "H100": 4})
