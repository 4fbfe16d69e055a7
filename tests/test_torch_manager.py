"""The port's control plane (``repro_torch/manager/``: events, the
availability monitor, the incremental replanner, the transition model,
the controller and the serving autoscaler) vs the reference's
``repro/manager/``.

The port keeps plain-Python copies; the cases of ``tests/test_manager.py``
and the autoscaler's of ``tests/test_serving.py`` are run through both
packages on the same inputs and must give the same events, plans, cache
outcomes, prices and decisions (``==``, floats bit for bit; replan
timings are not compared).  The port's ``"H100"`` is added to the
reference's catalog with ``monkeypatch``, as in ``test_torch_planner.py``.

The reference's own controller runs (``test_controller_end_to_end``,
``test_controller_audit_log_jsonl``, ``tests/test_system.py``) fail on
this jax (``ROADMAP.md`` §3, R1).  So both controllers drive the same
stub trainer (``_StubTrainer``: steps, checkpoints and rollbacks
counted, no model, neither JAX nor torch) and their decision logs must be
equal.  The port's controller then drives its real
``ElasticTrainer`` on CPU positions and must take the same decisions.
"""
import dataclasses
import importlib
import json
import math
import types

import numpy as np
import pytest

import chip_smoke
from repro.core.profiler import hw_specs as jhw
from repro.core.profiler import kernel_costs as jkc
from repro_torch.core.profiler import hw_specs as thw
from repro_torch.core.profiler import kernel_costs as tkc


def _pkg(root: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, cl=m("core.cluster"), an=m("core.profiler.analytic"),
        hw=m("core.profiler.hw_specs"), obj=m("core.planner.objectives"),
        search=m("core.planner.search"), plan=m("core.planner.plan"),
        get=m("configs").get_config, man=m("manager"),
        ev=m("manager.events"), tr=m("manager.transition"),
        ctl=m("manager.controller"), auto=m("manager.autoscale"))


J, T = _pkg("repro"), _pkg("repro_torch")


@pytest.fixture(autouse=True)
def _h100_in_both_catalogs(monkeypatch):
    monkeypatch.setitem(jhw.ACCELERATORS, "H100", jhw.AcceleratorSpec(
        **dataclasses.asdict(thw.ACCELERATORS["H100"])))
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()
    yield
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()


def _plain(x):
    """A package-free picture of ``x``: dataclasses as dicts of their
    fields (with the class name), clusters by fingerprint, mappings (a
    sample's meta) as dicts."""
    if hasattr(x, "fingerprint") and callable(x.fingerprint):
        return ("cluster", x.fingerprint())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"type": type(x).__name__, **{
            f.name: _plain(getattr(x, f.name))
            for f in dataclasses.fields(x)}}
    if isinstance(x, dict) or (hasattr(x, "items") and hasattr(x, "keys")):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def _both(case, *args):
    """``case`` run on the reference and on the port; equal pictures."""
    want, got = _plain(case(J, *args)), _plain(case(T, *args))
    assert got == want
    return got


# --- events and the monitor ---------------------------------------------------------

def _event_bus(P):
    bus = P.ev.EventBus()
    seen, failures = [], []
    bus.subscribe(seen.append)
    bus.subscribe(failures.append, P.ev.NodeFailure)
    bus.publish(P.ev.CapacityUp(time_s=1.0, zone="z", acc_type="a",
                                available=4, delta=2))
    bus.publish(P.ev.NodeFailure(time_s=2.0, zone="z", acc_type="a",
                                 available=0, lost=4))
    with pytest.raises(ValueError):
        bus.publish(P.ev.CapacityUp(time_s=1.5))
    return dict(seen=seen, failures=failures,
                of_type=bus.of_type(P.ev.NodeFailure),
                describe=[e.describe() for e in seen])


def test_event_bus_ordering_and_subscribe_equal():
    got = _both(_event_bus)
    assert [e["type"] for e in got["seen"]] == ["CapacityUp", "NodeFailure"]
    assert got["failures"] == got["of_type"] == [got["seen"][1]]


def _cpu(P, n=8, price=None):
    c = P.cl.single_zone("cpu-host", n)
    if price is not None:
        c = c.with_price({("us-central1-a", "cpu-host"): price})
    return c


def _classify(P):
    feed = P.man.ListFeed([(10.0, _cpu(P, 12)), (20.0, _cpu(P, 11)),
                           (30.0, _cpu(P, 4)), (40.0, _cpu(P, 4, 0.05))])
    mon = P.man.AvailabilityMonitor(_cpu(P), [feed])
    evs = mon.drain()
    return dict(evs=evs, describe=[e.describe() for e in evs],
                log=mon.bus.log, current=mon.current,
                chips=[e.cluster.total_chips() for e in evs])


def test_monitor_classification_equal():
    got = _both(_classify)
    assert [e["type"] for e in got["evs"]] == [
        "CapacityUp", "CapacityDown", "NodeFailure", "PriceChange"]
    assert got["evs"][2]["lost"] == 7 and got["chips"][2] == 4
    assert got["evs"][3]["price_per_hour"] == pytest.approx(0.05)
    assert got["log"] == got["evs"]


@pytest.mark.parametrize("seed,n,prob,horizon", [(3, 8, 0.3, 1800),
                                                 (11, 16, 0.1, 3600),
                                                 (12, 16, 0.1, 3600)])
def test_trace_feed_change_points_equal(seed, n, prob, horizon):
    def run(P):
        c = P.cl.single_zone("cpu-host", n)
        trace = P.cl.AvailabilityTrace(c, seed=seed, step_s=60,
                                       horizon_s=horizon, preempt_prob=prob)
        points = [(t, cl.fingerprint()) for t, cl in trace.change_points()]
        evs = P.man.AvailabilityMonitor(c, [P.man.TraceFeed(trace)]).drain()
        return dict(points=points, evs=evs, start=c.fingerprint())
    got = _both(run)
    # one event a change point that changes the pool (a trace may open
    # with its starting state)
    fps = [fp for _, fp in got["points"]]
    changes = sum(a != b for a, b in zip([got["start"]] + fps, fps))
    assert len(got["evs"]) == changes
    assert {e["type"] for e in got["evs"]} <= {"CapacityUp", "CapacityDown",
                                               "NodeFailure"}


def _poll(P):
    feed = P.man.ListFeed([(10.0, _cpu(P, 4)), (100.0, _cpu(P, 8))])
    mon = P.man.AvailabilityMonitor(_cpu(P), [feed])
    return [mon.poll(50.0), mon.poll(50.0), mon.poll(200.0)]


def test_monitor_poll_respects_time_equal():
    got = _both(_poll)
    assert [len(x) for x in got] == [1, 0, 1]


# --- the incremental replanner ------------------------------------------------------

def _geo(P):
    return P.cl.multi_zone({
        "us-central1-a": ("us-central1", {"A100-40": 16}),
        "us-west1-a":    ("us-west1",    {"A100-40": 16}),
    })


def _job(P, arch="smollm_360m", seq=512, gbs=64, reduced=False):
    cfg = P.get(arch)
    return P.an.TrainJob(cfg=cfg.reduced() if reduced else cfg, seq_len=seq,
                         global_batch=gbs)


def _result(res):
    """A ``PlanResult`` without its timings."""
    b = res.best
    stats = {k: v for k, v in res.stats.items()
             if k in ("cache", "certified", "restricted", "reused",
                      "incumbent")}
    return dict(plan=b.plan if b else None, t_iter=b.t_iter if b else None,
                cost=b.cost_per_iter if b else None, stats=stats,
                n_candidates=res.n_candidates)


def _cold_warm_hit(P):
    rp = P.man.IncrementalReplanner(_job(P), P.obj.Objective(
        P.obj.MAX_THROUGHPUT))
    geo = _geo(P)
    shrunk = geo.with_capacity({("us-central1-a", "A100-40"): 12})
    out = [_result(rp.replan(c)) for c in (geo, shrunk, geo)]
    return dict(out=out, stats=rp.stats,
                fits=P.search.plan_fits(out[1]["plan"], shrunk))


def test_replanner_cold_warm_hit_equal():
    got = _both(_cold_warm_hit)
    assert [o["stats"]["cache"] for o in got["out"]] == ["cold", "warm",
                                                         "hit"]
    assert got["out"][2]["plan"] == got["out"][0]["plan"] and got["fits"]


def _certify_and_price(P):
    rp = P.man.IncrementalReplanner(_job(P), P.obj.Objective(
        P.obj.MAX_THROUGHPUT))
    geo = _geo(P)
    r1 = rp.replan(geo)
    used = {r.zone for s in r1.best.plan.stages for r in s.replicas}
    out = [_result(r1)]
    for z in ("us-central1-a", "us-west1-a"):
        if z not in used:
            out.append(_result(rp.replan(geo.with_capacity({(z, "A100-40"):
                                                            2}))))
    floor = P.man.IncrementalReplanner(_job(P), P.obj.Objective(
        P.obj.MIN_COST, min_throughput=1e-6))
    p1 = floor.replan(geo)
    zones1 = {r.zone for s in p1.best.plan.stages for r in s.replicas}
    other = "us-west1-a" if zones1 <= {"us-central1-a"} else "us-central1-a"
    p2 = floor.replan(geo.with_price({(other, "A100-40"): 3.67 / 20}))
    return dict(out=out, used=sorted(used), price=[_result(p1), _result(p2)],
                other=other, stats=[rp.stats, floor.stats])


def test_replanner_certified_shrink_and_price_change_equal():
    got = _both(_certify_and_price)
    p1, p2 = got["price"]
    assert {r["zone"] for s in p2["plan"]["stages"]
            for r in s["replicas"]} <= {got["other"]}
    assert p2["cost"] < p1["cost"]


# --- the transition model -----------------------------------------------------------

def _costs(P):
    tm = P.man.TransitionModel()
    link = P.hw.LinkSpec("l", alpha=1e-4, beta=10e9)
    slow = P.hw.LinkSpec("s", alpha=1e-4, beta=1e9)
    return dict(
        cfg=tm.cfg,
        reshard=[tm.reshard_cost_s(b, lk, m) for b in (1e6, 1e8, 1e9, 1e10,
                                                      2.17e9, 3.618e9)
                 for lk in (link, slow) for m in (1, 2, 4, 8)],
        rollback=[tm.rollback_cost_s(b, k, t) for b in (1e9, 3.618e9)
                  for k in (0, 2, 5, 50) for t in (0.5, 2.0)])


def test_transition_costs_equal():
    got = _both(_costs)
    assert got["cfg"]["comm_setup_s"] == 2.0
    assert got["cfg"]["restore_bw"] == 1e9
    assert got["cfg"]["hysteresis_s"] == 120.0
    r = got["rollback"]
    assert r[0] <= r[2] <= r[4] <= r[6]


_DECIDE = [dict(mandatory=m, state_lost=s, t_iter_new_s=t, event_age_s=a,
                root_cause=rc, audit_failed=af, t_iter_rebalance_s=rb)
           for m, s in ((True, True), (True, False), (False, False))
           for t in (None, 1.0, 1.999, 2.5)
           for a in (10.0, 600.0)
           for rc in (None, "data-stall", "slow-chip", "slow-link")
           for af in (False, True)
           for rb in (None, 1.5)]


@pytest.mark.parametrize("chunk", range(4))
def test_transition_decide_grid_equal(chunk):
    """``decide`` over a grid of every flag (a quarter of it a case)."""
    cases = _DECIDE[chunk::4]

    def run(P):
        tm = P.man.TransitionModel(P.man.TransitionConfig(
            hysteresis_s=120.0, commit_horizon_s=1800.0))
        link = P.hw.LinkSpec("l", alpha=1e-4, beta=10e9)
        return [tm.decide(state_bytes=1e9, link=link, movers=8,
                          steps_since_ckpt=3, t_iter_old_s=2.0, **kw)
                for kw in cases]
    got = _both(run)
    kinds = {d["kind"] for d in got}
    assert kinds <= {"reshard", "rollback", "defer", "route-around",
                     "rebalance"}
    for kw, d in zip(cases, got):
        if kw["root_cause"] == "data-stall":
            assert d["kind"] == "defer"
        elif kw["state_lost"]:
            assert d["kind"] == "rollback"
        elif kw["mandatory"]:
            assert d["kind"] == "reshard"


def test_fit_runtime_plan_equal():
    def run(P):
        res = P.man.IncrementalReplanner(_job(P), P.obj.Objective(
            P.obj.MAX_THROUGHPUT)).replan(_geo(P))
        return [P.man.fit_runtime_plan(n, gbs, nm, plan)
                for n in (1, 2, 4, 8) for gbs in (4, 8, 64)
                for nm in (1, 2) for plan in (None, res.best.plan)]
    got = _both(run)
    assert all(p["dp"] * p["tp"] == p["n_devices"] for p in got)


# --- the serving autoscaler ---------------------------------------------------------

def _serve_job(P):
    return P.an.ServeJob(cfg=P.get("smollm_360m"), prompt_len=256,
                         max_new_tokens=128, decode_batch=8, arrival_rps=4.0)


def _two_zone(P, a100=8, rtx=16):
    return P.cl.multi_zone({
        "us-central1-a": ("us-central1", {"A100-40": a100}),
        "eu-west4-a": ("eu-west4", {"RTX-3090": rtx}),
    })


def _autoscale(P, scenario):
    job, base = _serve_job(P), _two_zone(P, a100=8, rtx=4)
    objective = P.obj.ServingObjective(slo_ttft_p99_s=2.0,
                                       slo_tpot_p99_s=0.2)
    cfg = P.man.AutoscaleConfig(replan_horizon_s=40.0)
    planner = P.search.SailorPlanner(job)
    if scenario == "price_and_capacity":
        cheap = base.with_price({("us-central1-a", "A100-40"): 0.40})
        feed = P.man.ListFeed([
            (60.0, cheap),
            (120.0, cheap.with_capacity({("us-central1-a", "A100-40"): 16}))])
        moves = []
        ctl = P.man.ServingController(
            planner, objective, P.man.AvailabilityMonitor(base, [feed]), cfg,
            resize_fn=lambda old, new, ev: moves.append(new))
        ctl.run(until_s=200.0)
        return dict(decisions=ctl.decisions, moves=len(moves),
                    ok=objective.satisfies(ctl.current))
    ctl = P.man.ServingController(
        planner, objective,
        P.man.AvailabilityMonitor(base, [P.man.ListFeed([])]), cfg)
    ctl.start()
    plan = ctl.current.plan
    dead = base.with_capacity({(r.zone, r.gpu_type): 0
                               for r in plan.decode + plan.prefill})
    return dict(decisions=ctl.decisions, plan=plan,
                fits=[P.man.plan_fits_capacity(plan, c)
                      for c in (dead, base)])


@pytest.mark.parametrize("scenario", ["price_and_capacity",
                                      "capacity_loss"])
def test_serving_controller_equal(scenario):
    """``tests/test_serving.py:280,307``'s scenarios."""
    got = _both(_autoscale, scenario)
    d = got["decisions"]
    assert d[0]["action"] == "start"
    if scenario == "capacity_loss":
        assert got["fits"] == [False, True]
        return
    assert got["ok"] and len(d) >= 3
    adopted = [x for x in d if x["action"] != "defer"]
    assert len(adopted) >= 2 and got["moves"] == len(adopted)
    assert all(x["cost_per_token"] < math.inf and x["n_replicas"] >= 1
               for x in d)


# --- the controller -----------------------------------------------------------------

class _StubTrainer:
    """What ``Controller`` touches of ``ElasticTrainer``, with no model:
    a step counter, a checkpoint every ``checkpoint_every`` steps, a
    rollback resuming at the latest one (0 before any), and no straggler
    flags."""

    def __init__(self, global_batch, num_microbatches, checkpoint_every):
        self.data_cfg = types.SimpleNamespace(
            global_batch=global_batch, num_microbatches=num_microbatches)
        self.checkpoint_every = checkpoint_every
        self.plan_fn = None
        self.plan = self.mesh = None
        self.step = self.saved = 0
        self.log, self.reconfigs = [], []
        self.detector = types.SimpleNamespace(times=[])
        self.ckpt = types.SimpleNamespace(wait=lambda: None)
        self.telemetry = self.clock = None

    def build(self, n_devices):
        self.plan = self.plan_fn(n_devices)
        self.mesh = self.plan.mesh_shape()

    def on_availability_change(self, n_devices, failure=False):
        at = self.step
        self.build(n_devices)
        if failure:
            self.step = self.saved
        self.reconfigs.append({"step": at, "resumed_at": self.step,
                               "n_devices": n_devices,
                               "kind": "rollback" if failure
                               else "kill-free"})

    def train(self, num_steps):
        for _ in range(num_steps):
            self.log.append({"step": self.step, "time_s": 1.0, "loss": 0.0,
                             "n_devices": self.plan.n_devices,
                             "straggler_flag": False})
            self.step += 1
            if self.step % self.checkpoint_every == 0:
                self.saved = self.step
        return self.log


# 4 H100s, a step every 60 feed seconds; the feed's (time_s, H100s
# available): a graceful drop to 3 (runs on 2), the 4 back (clears the
# hysteresis at t = 360), a bulk preemption to 2, and a blip to 4 that
# reverts before the hysteresis ends
MANAGER_FEED = ((120.0, 3), (240.0, 4), (480.0, 2), (540.0, 4), (600.0, 2))
# the reference Controller's outcomes and reconfigurations on it
MANAGER_OUTCOMES = ("start", "reshard", "defer", "reshard", "rollback",
                    "defer", "defer")
MANAGER_RECONFIGS = (("kill-free", 2), ("kill-free", 4), ("rollback", 2))

_FEEDS = {
    # MANAGER_FEED on chip_smoke.py's train job (smollm-360M, seq 1024)
    "manager": dict(
        start=4, feed=[(t, ("H100", n)) for t, n in MANAGER_FEED],
        job=dict(seq=chip_smoke.TRAIN_DATA["seq_len"],
                 gbs=chip_smoke.TRAIN_DATA["global_batch"]),
        nm=chip_smoke.TRAIN_DATA["num_microbatches"], every=3, hyst=120.0,
        max_devices=4, steps=11),
    # the same feed on the reduced model
    "manager_reduced": dict(
        start=4, feed=[(t, ("H100", n)) for t, n in MANAGER_FEED],
        job=dict(seq=16, gbs=8, reduced=True), nm=1, every=3, hyst=120.0,
        max_devices=4, steps=11),
    # tests/test_manager.py::test_controller_end_to_end's feed
    "end_to_end": dict(
        start=4, feed=[(60.0, ("cpu-host", 8)), (120.0, ("cpu-host", 4)),
                       (300.0, ("cpu-host", 8)), (720.0, ("cpu-host", 2))],
        job=dict(seq=16, gbs=8, reduced=True), nm=1, every=3, hyst=120.0,
        max_devices=8, steps=16, acc="cpu-host"),
    # tests/test_manager.py::test_controller_price_blip_dropped's feed
    "price_blip": dict(
        start=1, feed=[(60.0, ("price", 0.01)), (120.0, ("price", None))],
        job=dict(seq=16, gbs=4, reduced=True), nm=1, every=100, hyst=600.0,
        max_devices=1, steps=5, acc="cpu-host"),
}


def _feed_clusters(P, spec):
    acc = spec.get("acc", "H100")
    start = P.cl.single_zone(acc, spec["start"])
    snaps = []
    for t, (kind, v) in spec["feed"]:
        if kind == "price":
            c = start if v is None else start.with_price(
                {("us-central1-a", acc): v})
        else:
            c = P.cl.single_zone(kind, v)
        snaps.append((t, c))
    return start, snaps


def _controller(P, spec, trainer, **cfg_kw):
    start, snaps = _feed_clusters(P, spec)
    job = _job(P, **spec["job"])
    return P.man.Controller(
        trainer, P.man.AvailabilityMonitor(start, [P.man.ListFeed(snaps)]),
        P.man.IncrementalReplanner(job, P.obj.Objective(
            P.obj.MAX_THROUGHPUT)),
        transition=P.man.TransitionModel(P.man.TransitionConfig(
            hysteresis_s=spec["hyst"])),
        config=P.man.ControllerConfig(step_time_s=60.0,
                                      max_devices=spec["max_devices"],
                                      **cfg_kw))


def _decisions(ctl):
    """The decision log without replan timings and straggler rows (whose
    flags come from wall time)."""
    return [{k: v for k, v in d.items() if k != "search_ms"}
            for d in ctl.decisions if not d.get("straggler")]


def _stub_run(P, name):
    spec = _FEEDS[name]
    tr = _StubTrainer(spec["job"]["gbs"], spec["nm"], spec["every"])
    ctl = _controller(P, spec, tr)
    log = ctl.run(spec["steps"])
    return dict(decisions=_decisions(ctl), outcomes=ctl.outcomes(),
                reconfigs=tr.reconfigs, summary_lines=len(
                    ctl.summary().splitlines()),
                plans=[(r["n_devices"], r["step"]) for r in log],
                pending=(ctl.pending, ctl.pending_price),
                stats=ctl.replanner.stats, state_bytes=ctl._state_bytes())


@pytest.mark.parametrize("name", sorted(_FEEDS))
def test_controller_decisions_equal_on_a_stub_trainer(name):
    got = _both(_stub_run, name)
    kinds = [r["kind"] for r in got["reconfigs"]]
    if name == "manager":
        assert got["outcomes"] == list(MANAGER_OUTCOMES)
        assert [(r["kind"], r["n_devices"]) for r in got["reconfigs"]] == \
            list(MANAGER_RECONFIGS)
        assert got["reconfigs"][-1]["resumed_at"] == 6
    if name == "end_to_end":
        blips = [d for d in got["decisions"] if d.get("blip")]
        assert "kill-free" in kinds and "rollback" in kinds
        assert len(blips) == 1
        assert {n for n, _ in got["plans"]} == {2, 4, 8}
    if name == "price_blip":
        d = got["decisions"]
        assert any(x.get("pending") and "PriceChange" in x["event"]
                   for x in d)
        assert any(x.get("blip") and "PriceChange" in x["event"] for x in d)
        assert got["pending"][1] is None and got["reconfigs"] == []


def test_controller_drives_the_elastic_trainer_on_cpu(tmp_path):
    """The port's ``Controller`` over its real ``ElasticTrainer`` on four
    CPU positions (reduced smollm-360M, seq 16, global batch 8 in 2
    microbatches) on ``MANAGER_FEED``, its replanner pricing the
    ``"manager"`` feed's job (smollm-360M at seq 1024): the stub trainer's
    decisions, an audit file equal to them, telemetry on the
    sim clock, a rollback to the step-6 checkpoint and finite losses.
    The counterpart of the reference's ``test_controller_end_to_end`` and
    ``test_controller_audit_log_jsonl``, which fail on this jax (R1)."""
    from repro_torch.telemetry import TelemetryBus, read_jsonl
    from repro_torch.train import data as data_lib
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.elastic import ElasticTrainer

    spec = _FEEDS["manager"]
    cfg = T.get("smollm_360m").reduced()
    trainer = ElasticTrainer(
        cfg, opt_lib.OptimizerConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=40),
        data_lib.DataConfig(seq_len=16, global_batch=8, num_microbatches=2),
        workdir=str(tmp_path / "ckpt"), checkpoint_every=3,
        devices=["cpu"] * 4)
    audit = tmp_path / "audit.jsonl"
    ctl = _controller(T, spec, trainer, audit_path=str(audit))
    bus = TelemetryBus()
    ctl.attach_telemetry(bus)
    log = ctl.run(spec["steps"])
    stub = _stub_run(T, "manager")
    assert _decisions(ctl) == stub["decisions"]
    assert [{k: r[k] for k in ("step", "resumed_at", "n_devices", "kind")}
            for r in trainer.reconfigs] == stub["reconfigs"]
    assert ctl.outcomes() == list(MANAGER_OUTCOMES)
    assert trainer.reconfigs[-1]["kind"] == "rollback"
    assert trainer.reconfigs[-1]["resumed_at"] == 6
    assert [r["step"] for r in log] == [s for _, s in stub["plans"]]
    assert all(np.isfinite(r["loss"]) for r in log)
    # the audit file: every decision, in order, with its wall time
    recs = read_jsonl(str(audit))
    assert all(r.pop("kind") == "decision" and r.pop("wall_time_s") > 1e9
               for r in recs)
    assert recs == json.loads(json.dumps(ctl.decisions))
    # telemetry through the trainer, on the controller's sim clock
    times = [s.time_s for s in bus.series("step_time", ())]
    assert times == [60.0 * i for i in range(spec["steps"])]
    assert max(times) <= ctl.sim_time
    assert len(bus.values("data_stall", ())) == spec["steps"]
    assert bus.latest("heartbeat", (0, 0)).meta["chips"] == 2
    assert ctl.det_bank is not None and ctl.rca is not None


def test_manager_reexports_equal():
    """``repro_torch.manager`` re-exports the reference's names."""
    names = [n for n in dir(J.man) if not n.startswith("_")
             and not isinstance(getattr(J.man, n), types.ModuleType)]
    assert names and all(hasattr(T.man, n) for n in names)
    assert (T.man.DEFER, T.man.RESHARD, T.man.ROLLBACK, T.man.ROUTE_AROUND) \
        == (J.man.DEFER, J.man.RESHARD, J.man.ROLLBACK, J.man.ROUTE_AROUND)
