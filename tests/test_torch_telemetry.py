"""The port's telemetry (``repro_torch/telemetry/``: the bus, the online
detectors, root-cause analysis, fault injection and the chaos loop) vs
the reference's ``repro/telemetry/``.

The port keeps plain-Python copies; every case of
``tests/test_telemetry.py`` that runs without a device is run through
both packages on the same inputs (the same seeded streams, faults and
clusters) and must give the same samples, anomalies, events, verdicts,
noise draws and chaos report rows (``==``, floats bit for bit).  The
reference's own assertions are then held on the port's result.  The
runtime hooks (``MPMDPipeline.attach_telemetry``, ``ElasticTrainer(
telemetry=)``) are held in ``test_torch_pipeline.py`` and
``test_torch_elastic.py``.
"""
import importlib
import json
import types

import numpy as np
import pytest

from test_torch_manager import _plain


def _pkg(root: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return types.SimpleNamespace(
        root=root, cl=m("core.cluster"), an=m("core.profiler.analytic"),
        get=m("configs").get_config, ev=m("manager.events"),
        mon=m("manager.monitor"), bus=m("telemetry.bus"),
        det=m("telemetry.detectors"), rca=m("telemetry.rca"),
        faults=m("telemetry.faults"), tel=m("telemetry"))


J, T = _pkg("repro"), _pkg("repro_torch")


def _both(case, *args):
    """``case`` run on the reference and on the port; equal pictures."""
    want, got = _plain(case(J, *args)), _plain(case(T, *args))
    assert got == want
    return got


def _geo(P):
    return P.cl.multi_zone({
        "us-central1-a": ("us-central1", {"A100-40": 16}),
        "us-west1-a":    ("us-west1",    {"A100-40": 16}),
    })


def _job(P):
    return P.an.TrainJob(cfg=P.get("smollm_360m"), seq_len=512,
                         global_batch=64)


# --- bus ----------------------------------------------------------------------------

def _bus_rings(P):
    bus = P.bus.TelemetryBus(capacity=4)
    for i in range(10):
        bus.emit(P.bus.Sample("step_time", (), float(i), i, 0.1 * i))
    return dict(n=bus.n_samples, values=bus.values("step_time", ()),
                latest=bus.latest("step_time", ()),
                fwd=bus.series("fwd_time", (0, 0)))


def _bus_subscribe(P):
    bus = P.bus.TelemetryBus()
    all_s, fwd_s, steps = [], [], []
    bus.subscribe(all_s.append)
    bus.subscribe(fwd_s.append, metric="fwd_time")
    bus.on_step(lambda step, t: steps.append((step, t)))
    bus.emit(P.bus.Sample("fwd_time", (0, 0), 1.0, 0, 0.5))
    bus.emit(P.bus.Sample("step_time", (), 1.0, 0, 1.5))
    bus.end_step(0, 1.0)
    return dict(all=all_s, fwd=fwd_s, steps=steps, keys=bus.keys("fwd_time"),
                metrics=P.bus.METRICS)


def _bus_jsonl(P, tmp):
    export = tmp / f"{P.root}-trace.jsonl"
    stream = tmp / f"{P.root}-stream.jsonl"
    bus = P.bus.TelemetryBus(writer=P.bus.JsonlWriter(str(stream)))
    bus.emit(P.bus.Sample("step_time", (), 2.0, 1, 0.2))
    bus.emit(P.bus.Sample("fwd_time", (0, 0), 1.0, 0, 0.1, {"zone": "z"}))
    n = bus.export_jsonl(str(export))
    return dict(n=n, export=P.bus.read_jsonl(str(export)),
                stream=P.bus.read_jsonl(str(stream)),
                first=json.loads(stream.read_text().splitlines()[0]))


def test_bus_rings_are_bounded_equal():
    got = _both(_bus_rings)
    assert got["n"] == 10 and got["latest"]["step"] == 9
    assert got["values"] == pytest.approx([0.6, 0.7, 0.8, 0.9])
    assert got["fwd"] == []


def test_bus_subscribe_and_step_boundaries_equal():
    got = _both(_bus_subscribe)
    assert len(got["all"]) == 2 and len(got["fwd"]) == 1
    assert got["steps"] == [(0, 1.0)] and got["keys"] == [(0, 0)]


def test_bus_jsonl_export_and_streaming_equal(tmp_path):
    got = _both(_bus_jsonl, tmp_path)
    assert got["n"] == 2
    assert [r["time_s"] for r in got["export"]] == [1.0, 2.0]
    assert got["export"][0]["meta"] == {"zone": "z"}
    assert [r["time_s"] for r in got["stream"]] == [2.0, 1.0]
    assert got["first"]["step"] == 1


def _event_bus_ties(P):
    bus = P.ev.EventBus()
    seen = []
    bus.subscribe(seen.append)
    evs = [P.ev.CapacityUp(time_s=5.0, zone="za", acc_type="x", available=4,
                           delta=2),
           P.ev.NodeFailure(time_s=5.0, zone="zb", acc_type="x", available=0,
                            lost=4),
           P.ev.Straggler(time_s=5.0, step=3, t_step_s=2.0, t_median_s=1.0)]
    seqs = [bus.publish(e) for e in evs]
    return dict(seqs=seqs, log=bus.log, seen=seen, bus_seqs=bus.seqs,
                describe=[e.describe() for e in bus.log])


def test_event_bus_same_timestamp_insertion_order_equal():
    got = _both(_event_bus_ties)
    assert got["seqs"] == sorted(got["seqs"]) == got["bus_seqs"]
    assert got["log"] == got["seen"]


# --- detectors ----------------------------------------------------------------------

def _stream(P, cfg_kw, values, start=0):
    """Anomalies (None where none) and the final state of one detector
    fed ``values`` at steps ``start, start + 1, ...``."""
    det = P.det.StreamDetector(P.det.DetectorConfig(**cfg_kw))
    out = [det.observe(start + i, float(start + i), x)
           for i, x in enumerate(values)]
    return dict(out=out, state=det.state, n=det.n_events,
                median=det.median(), mad=det.mad(), baseline=det.baseline)


def _noisy(n=500, seed=7, frac=0.04):
    rng = np.random.default_rng(seed)
    return [0.1 * float(np.exp(rng.normal(0.0, frac))) for _ in range(n)]


_OSC = ([0.1] * 20 + [0.3] * 3 + [0.3 if j % 2 else 0.13 for j in range(10)]
        + [0.1] * 3 + [0.4] * 10)
_STREAMS = {
    # tests/test_telemetry.py:104-176
    "warmup": (dict(warmup=12), [1.0 + (i % 3) * 5.0 for i in range(12)]),
    "single_spike": ({}, [0.1] * 30 + [1.0] + [0.1] * 29),
    "sustained": (dict(persist=3), [0.1] * 20 + [0.25] * 10),
    "oscillation": (dict(persist=3, release_rel=1.15, cooldown=20), _OSC),
    "noisy_500": ({}, _noisy()),
    # beyond the reference's cases: a step, a ramp, a dip, recovery
    "step_up_then_back": (dict(persist=2), [0.2] * 15 + [0.5] * 6
                          + [0.2] * 30 + [0.6] * 5),
    "ramp": ({}, [0.1 * (1.0 + 0.05 * i) for i in range(60)]),
    "dip": ({}, [0.1] * 20 + [0.01] * 10),
    "noisy_then_2x": ({}, _noisy(40, seed=3) + [0.2] * 8),
}


@pytest.mark.parametrize("name", sorted(_STREAMS))
def test_stream_detector_equal(name):
    cfg_kw, values = _STREAMS[name]
    got = _both(_stream, cfg_kw, values)
    fired = [a for a in got["out"] if a is not None]
    assert got["n"] == len(fired)
    if name in ("warmup", "single_spike", "noisy_500"):
        assert got["n"] == 0
    if name == "sustained":
        assert len(fired) == 1 and got["out"][22] is not None
        assert fired[0]["factor"] == pytest.approx(2.5, rel=0.05)
        assert got["state"] == "degraded"
    if name == "oscillation":
        assert got["n"] == 1 and got["state"] == "healthy"


def _heartbeats(P):
    hb = P.det.HeartbeatDetector(miss_limit=3)
    for s in range(5):
        hb.beat((0, 0), s, {"zone": "z"})
        hb.beat((1, 0), s, {"zone": "z"})
    out = [hb.missing(6), hb.missing(7), hb.missing(8)]
    hb.beat((0, 0), 9, {"zone": "z"})
    out.append(hb.missing(12))
    return out


def test_heartbeat_detector_fires_once_per_silence_equal():
    got = _both(_heartbeats)
    assert got[0] == [] and sorted(k for k, _ in got[1]) == [(0, 0), (1, 0)]
    assert got[2] == [] and [k for k, _ in got[3]] == [(0, 0)]


# --- detector bank ------------------------------------------------------------------

def _feed(P, bus, streams, start, n):
    for step in range(start, start + n):
        t = float(step)
        for (metric, key), (fn, meta) in streams.items():
            bus.emit(P.bus.Sample(metric, key, t, step, fn(step), meta))
        bus.end_step(step, t)


def _base(with_stall=False):
    base = {
        ("fwd_time", (0, 0)): (lambda s: 0.10, {"zone": "za",
                                                "acc_type": "A100-40"}),
        ("p2p_time", (0, 1, 0, 0)): (lambda s: 0.02,
                                     {"zone": "za", "zone_b": "zb"}),
        ("step_time", ()): (lambda s: 0.3, {}),
    }
    if with_stall:
        base[("data_stall", ())] = (lambda s: 0.0, {})
    return base


def _bank_events(P):
    bus, events = P.bus.TelemetryBus(), P.ev.EventBus()
    bank = P.det.DetectorBank(bus, events)
    base = _base()
    _feed(P, bus, base, 0, 20)
    quiet = list(events.log)
    hot = dict(base)
    hot[("p2p_time", (0, 1, 0, 0))] = (lambda s: 0.16,
                                       {"zone": "za", "zone_b": "zb"})
    _feed(P, bus, hot, 20, 5)
    hot2 = dict(base)
    hot2[("fwd_time", (0, 0))] = (lambda s: 0.5, {"zone": "za",
                                                  "acc_type": "A100-40"})
    bank.reset()
    _feed(P, bus, base, 25, 15)
    _feed(P, bus, hot2, 40, 5)
    return dict(quiet=quiet, log=events.log, anomalies=bank.anomalies,
                factor=[e.factor for e in events.log
                        if isinstance(e, P.ev.LinkDegraded)])


def test_bank_maps_streams_to_typed_events_equal():
    got = _both(_bank_events)
    assert got["quiet"] == []
    links = [e for e in got["log"] if e["type"] == "LinkDegraded"]
    assert len(links) == 1
    assert (links[0]["zone_a"], links[0]["zone_b"],
            links[0]["boundary"]) == ("za", "zb", 0)
    assert got["factor"][0] == pytest.approx(8.0, rel=0.1)
    assert sum(e["type"] == "Straggler" for e in got["log"]) == 1


def _bank_heartbeat(P):
    cluster = P.cl.single_zone("A100-40", 8)
    bus, events = P.bus.TelemetryBus(), P.ev.EventBus()
    monitor = P.mon.AvailabilityMonitor(cluster, feeds=[], bus=events)
    P.det.DetectorBank(bus, events, monitor=monitor, heartbeat_miss=3)
    meta = {"zone": "us-central1-a", "acc_type": "A100-40", "chips": 4}
    for step in range(5):
        bus.emit(P.bus.Sample("heartbeat", (0, 0), float(step), step, 1.0,
                              meta))
        bus.end_step(step, float(step))
    for step in range(5, 9):
        bus.end_step(step, float(step))
    fails = events.of_type(P.ev.NodeFailure)
    return dict(fails=fails, same=[f.cluster is monitor.current
                                   for f in fails],
                left=monitor.current.zone("us-central1-a")
                .capacity["A100-40"])


def test_bank_heartbeat_loss_shrinks_monitor_snapshot_equal():
    got = _both(_bank_heartbeat)
    assert len(got["fails"]) == 1 and got["fails"][0]["lost"] == 4
    assert got["left"] == 4 and got["same"] == [True]


# --- RCA ----------------------------------------------------------------------------

def _fwd(v):
    return (lambda s: v, {"zone": "za", "acc_type": "A100-40"})


def _p2p(v):
    return (lambda s: v, {"zone": "za", "zone_b": "zb"})


def _const(v):
    return (lambda s: v, {})


_RCA = {
    # tests/test_telemetry.py:276-325
    "slow_chip": {("fwd_time", (0, 0)): _fwd(0.4),
                  ("step_time", ()): _const(0.6)},
    "slow_link": {("p2p_time", (0, 1, 0, 0)): _p2p(0.2),
                  ("step_time", ()): _const(0.5)},
    "data_stall": {("data_stall", ()): _const(0.3),
                   ("step_time", ()): _const(0.6)},
    "unknown": {},
    "node_failure": {},
    # beyond them: both families up, the step alone up
    "ambiguous": {("fwd_time", (0, 0)): _fwd(0.35),
                  ("p2p_time", (0, 1, 0, 0)): _p2p(0.1),
                  ("step_time", ()): _const(0.8)},
    "step_only": {("step_time", ()): _const(0.6)},
}


def _rca(P, name):
    bus, events = P.bus.TelemetryBus(), P.ev.EventBus()
    bank = P.det.DetectorBank(bus, events)
    base = _base(with_stall=True)
    hot = dict(base)
    hot.update(_RCA[name])
    _feed(P, bus, base, 0, 20)
    _feed(P, bus, hot, 20, 5)
    an = P.rca.RootCauseAnalyzer(bank)
    if name == "node_failure":
        ev = P.ev.NodeFailure(time_s=9.0, zone="za", acc_type="A100-40",
                              available=0, lost=8)
    else:
        ev = events.log[0] if events.log and name in ("slow_chip",
                                                      "slow_link") else None
    v = an.classify(ev)
    return dict(verdict=v, remediation=v.remediation, describe=v.describe(),
                events=events.log)


_RCA_WANT = {"slow_chip": ("slow-chip", "route-around"),
             "slow_link": ("slow-link", "route-around"),
             "data_stall": ("data-stall", "defer"),
             "unknown": ("unknown", "defer"),
             "node_failure": ("node-failure", "rollback-replan")}


@pytest.mark.parametrize("name", sorted(_RCA))
def test_root_cause_equal(name):
    got = _both(_rca, name)
    if name in _RCA_WANT:
        assert (got["verdict"]["kind"], got["remediation"]) == \
            _RCA_WANT[name]
    if name == "slow_chip":
        assert got["verdict"]["target"] == (0, 0)
        assert got["verdict"]["factor"] > 2.0
    if name == "slow_link":
        assert got["verdict"]["target"] == (0, 1, 0, 0)
    if name == "unknown":
        assert got["verdict"]["confidence"] == 0.0
    if name == "node_failure":
        assert got["verdict"]["target"] == ("za", "A100-40")


# --- fault injection ----------------------------------------------------------------

def _fault_queries(P):
    F = P.faults
    f = F.FaultSpec("compute_delay", zone="z", acc_type="a", start_step=10,
                    duration=5, factor=3.0)
    inj = F.FaultInjector([f], seed=3, noise_frac=0.05)
    link = F.FaultInjector([F.FaultSpec("link_degrade", zone="za",
                                        zone_b="zb", factor=4.0)])
    hang = F.FaultInjector([F.FaultSpec("worker_hang", zone="z",
                                        acc_type="a", start_step=2)])
    stall = F.FaultInjector([F.FaultSpec("data_stall", factor=0.5)])
    with pytest.raises(ValueError):
        F.FaultSpec("bad_kind")
    return dict(
        active=[f.active(s) for s in range(8, 17)],
        forever=F.FaultSpec("data_stall", start_step=4).active(10 ** 6),
        describe=[f.describe()] + [x.faults[0].describe()
                                   for x in (link, hang, stall)],
        factor=[inj.compute_factor(s, z, "a") for s in (9, 12, 20)
                for z in ("z", "other")],
        delay=[inj.compute_delay_s(s, "z", "a", 0.125) for s in (9, 12)],
        link=[link.link_factor(0, a, b) for a, b in
              (("za", "zb"), ("zb", "za"), ("za", "zc"))],
        hung=[hang.hung(s, "z", "a") for s in (1, 2, 9)],
        stall=stall.stall_s(0, 2.0),
        off=F.FaultInjector([], seed=3, noise_frac=0.0).noise(1, ("x",)))


def test_fault_spec_windows_and_injector_queries_equal():
    got = _both(_fault_queries)
    assert got["active"] == [False, False, True, True, True, True, True,
                             False, False]
    assert got["forever"] and got["off"] == 1.0
    assert got["factor"] == [1.0, 1.0, 3.0, 1.0, 1.0, 1.0]
    assert got["link"] == [4.0, 4.0, 1.0]
    assert got["hung"] == [False, True, True]
    assert got["stall"] == pytest.approx(1.0)


_STREAM_KEYS = [("F", 0, 0), ("F", 0, 1), ("B", 1, 0), ("P", 0, 1, 0, 0),
                ("x",), ()]


@pytest.mark.parametrize("seed,frac", [(0, 0.04), (3, 0.05), (7, 0.2),
                                       (12345, 0.01)])
def test_fault_injector_noise_bit_for_bit(seed, frac):
    """Seeded noise keyed by (seed, step, stream), drawn by numpy as the
    reference draws it: every draw equal, bit for bit."""
    def draws(P):
        inj = P.faults.FaultInjector([], seed=seed, noise_frac=frac)
        return [inj.noise(step, key) for step in range(0, 40, 3)
                for key in _STREAM_KEYS]
    got = _both(draws)
    assert len(set(got)) == len(got)          # every (step, stream) differs


def _degrade(P):
    geo = _geo(P)
    slow_c = P.faults.degrade_link(geo, "us-central1-a", "us-west1-a", 4.0)
    fast = geo.link_between("us-central1-a", "us-west1-a")
    slow = slow_c.link_between("us-central1-a", "us-west1-a")
    return dict(fast=fast, slow=slow, links=slow_c.links,
                t=(fast.time(1 << 20), slow.time(1 << 20)))


def test_degrade_link_slows_the_link_class_equal():
    got = _both(_degrade)
    assert got["slow"]["alpha"] == pytest.approx(got["fast"]["alpha"] * 4.0)
    assert got["slow"]["beta"] == pytest.approx(got["fast"]["beta"] / 4.0)
    assert got["t"][1] > got["t"][0]


# --- the chaos loop -----------------------------------------------------------------

_CHAOS = {
    # tests/test_telemetry.py:373-404
    "compute_delay": (dict(kind="compute_delay", zone="us-central1-a",
                           acc_type="A100-40", start_step=16, factor=2.5),
                      30),
    "worker_hang": (dict(kind="worker_hang", zone="us-central1-a",
                         acc_type="A100-40", start_step=16), 30),
    "clean": (None, 25),
}


def _chaos(P, name):
    spec, steps = _CHAOS[name]
    fault = P.faults.FaultSpec(**spec) if spec else None
    h = P.faults.ChaosHarness(_job(P), _geo(P), fault=fault, seed=7,
                              max_steps=steps)
    rep = h.run()
    return dict(row=rep.row(), verdict=rep.verdict, event=rep.event,
                decisions=h.decisions,
                expected=P.faults.EXPECTED_VERDICT,
                kinds=P.faults.FAULT_KINDS)


@pytest.mark.parametrize("name", sorted(_CHAOS))
def test_chaos_harness_report_equal(name):
    got = _both(_chaos, name)
    row = got["row"]
    if name == "clean":
        assert row["n_events"] == 0 and got["verdict"] is None
        assert row["detected_step"] is None and row["decision"] == "-"
        return
    assert row["verdict"] == got["expected"][name]
    assert row["detect_delay"] is not None and row["detect_delay"] <= 6
    assert row["ratio"] <= 1.2, row
    if name == "compute_delay":
        assert row["decision"] == "route-around"
        assert "slow-chip" in got["decisions"][0]["verdict"]
    else:
        assert row["decision"] == "rollback"
        assert "NodeFailure" in got["event"]


def test_telemetry_reexports_equal():
    """``repro_torch.telemetry`` re-exports the reference's names."""
    names = [n for n in dir(J.tel) if not n.startswith("_")
             and not isinstance(getattr(J.tel, n), types.ModuleType)]
    assert names and all(hasattr(T.tel, n) for n in names)
    assert T.tel.METRICS == J.tel.METRICS
    assert T.tel.EXPECTED_VERDICT == J.tel.EXPECTED_VERDICT
    assert T.tel.REMEDIATION == J.tel.REMEDIATION
