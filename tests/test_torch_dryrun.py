"""The port's dry run (``launch/shapes.py``, ``launch/dryrun.py``,
``launch/program_cost.py``, ``launch/comm.py``), the kernel wrappers'
fake route and the collective record, on the CPU.

The reference's dry run of a mesh cell (``test_dryrun_small_mesh_cell``)
and its audit demo (``test_audit_demo_end_to_end``) fail on jax 0.9.0
(ROADMAP §3, R1), so the port's mesh cells are held against the port's
own real step on ``[cpu] * n`` (the fake record equals the real one
entry for entry; the record leaves a step's bits alone), and against
the reference where it runs in-process: the shape cells, the stand-ins'
shapes, dtypes and specs (``param_sds`` & co. on a one-device mesh, the
specs through the rules on a ``_FakeMesh``), and the FLOPs of a
one-device train step (``hlo_cost.analyze`` of the compiled
``make_train_step``).
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget
from repro.dist import sharding as jshd
from repro.launch import hlo_cost as jhlo_cost
from repro.launch import shapes as jshapes
from repro.models import config as jconfig
from repro.serve import serve_step as jserve_step
from repro.train import optimizer as jopt
from repro.train import train_step as jts
from repro_torch.configs import get_config as tget
from repro_torch.device import meta_stands_for_cuda
from repro_torch.dist import mesh as tmesh
from repro_torch.dist import placement as pm
from repro_torch.dist.sharding import param_specs
from repro_torch.kernels import ops
from repro_torch.launch import comm, dryrun
from repro_torch.launch import program_cost as pc
from repro_torch.launch import shapes as tshapes
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel
from repro_torch.serve import serve_step as tss
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import train_step as tts



@pytest.fixture(autouse=True)
def _one_thread():
    """These tiny models' ops run on one thread in a fraction of the CPU
    time the default pool spends on them, which the workers of a parallel
    test run share; the pool's size is restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

class _FakeMesh:
    """dict-shaped mesh stand-in (the sharding rules read only .shape)."""

    def __init__(self, shape):
        self.shape = shape


def _cuda_mesh(dp, tp):
    return tmesh.data_model_mesh(dp, tp, dryrun.fake_devices(dp * tp))


def _reduced_overrides(arch):
    """The reduced config's fields as ``run_cell`` overrides."""
    cfg = tget(arch)
    full, small = dataclasses.asdict(cfg), dataclasses.asdict(cfg.reduced())
    return {k: v for k, v in small.items() if k != "name" and v != full[k]}


# --- shapes ------------------------------------------------------------------------

def test_shape_cells_are_the_reference_cells():
    assert [dataclasses.asdict(s) for s in tconfig.SHAPES] == \
        [dataclasses.asdict(s) for s in jconfig.SHAPES]
    assert dataclasses.asdict(tconfig.get_shape("decode_32k")) == \
        dataclasses.asdict(jconfig.get_shape("decode_32k"))
    with pytest.raises(KeyError):
        tconfig.get_shape("nope")


def _one_device_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): x
            for path, x in flat}


def _port_leaves(tree):
    return dict(pm.tree_items(tree))


def _same_stand_ins(ref, port, ref_specs, label):
    """Global shapes and dtypes equal the reference's stand-ins', specs
    the reference's rules on the same mesh shape."""
    r, t = _ref_leaves(ref), _port_leaves(port)
    assert sorted(r) == sorted(t), label
    for k, x in t.items():
        assert tuple(x.shape) == tuple(r[k].shape), (label, k)
        assert str(x.dtype).split(".")[-1] == str(r[k].dtype), (label, k)
        assert tuple(x.spec) == tuple(ref_specs[k]), (label, k)


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_130m",
                                  "whisper_tiny", "internvl2_26b"])
def test_stand_ins_are_the_references(arch):
    """``build_cell``'s stand-ins (params, AdamW state, both batches, the
    decode cache with its fp32 SSM state) have the reference's global
    shapes, dtypes and specs on a (2, 4) mesh: shapes and dtypes from the
    reference's ``*_sds`` on a one-device mesh, specs from its rules on a
    ``_FakeMesh`` of the same shape."""
    jcfg, tcfg = jget(arch), tget(arch)
    jm1 = _one_device_mesh()
    fm = _FakeMesh({"data": 2, "model": 4})
    mesh, _ = tshapes.stand_in_mesh(_cuda_mesh(2, 4))
    shape = tconfig.ShapeConfig("t", "train", 256, 16)
    jshape = jconfig.ShapeConfig("t", "train", 256, 16)
    from repro.models import model as jmodel
    pspecs = _ref_leaves(jshd.param_specs(jmodel.decls(jcfg), jcfg.sharding,
                                          fm))
    with FakeTensorMode():
        _same_stand_ins(jshapes.param_sds(jcfg, jm1),
                        tshapes.param_fakes(tcfg, mesh), pspecs, "params")
        ref_opt = jshapes.opt_sds(jcfg, jm1)
        port_opt = tshapes.opt_fakes(tcfg, mesh)
        for k in ("m", "v"):
            _same_stand_ins(ref_opt[k], port_opt[k], pspecs, k)
        assert port_opt["step"].dtype == torch.int32
        assert port_opt["step"].shape == () and port_opt["step"].spec == ()
        dp = jshd.batch_spec(fm, 8)[0]
        bspecs = {"tokens": (None, dp, None), "labels": (None, dp, None),
                  "frames": (None, dp, None, None),
                  "patches": (None, dp, None, None)}
        _same_stand_ins(jshapes.batch_sds(jcfg, jshape, jm1, 2),
                        tshapes.batch_fakes(tcfg, shape, mesh, 2),
                        bspecs, "batch")
        dp = jshd.batch_spec(fm, 16)[0]
        ispecs = {"tokens": (dp, None), "frames": (dp, None, None),
                  "patches": (dp, None, None)}
        _same_stand_ins(jshapes.infer_batch_sds(jcfg, jshape, jm1),
                        tshapes.infer_batch_fakes(tcfg, shape, mesh),
                        ispecs, "infer batch")
        cspecs = jserve_step.cache_specs(jcfg, 16, 256, fm)
        _same_stand_ins(jshapes.cache_sds(jcfg, jshape, jm1),
                        tshapes.cache_fakes(tcfg, shape, mesh), cspecs,
                        "cache")


def test_build_cell_blocks_and_skips():
    """A train cell's blocks are fakes on the stand-ins, one a position
    with its own storage; serving cells on more than one position build
    (the decode cache laid out by ``cache_specs``), and so do encdec's and
    vlm's train and serving cells (their frames and patches laid out as
    the batch); only long_500k skips, as in the reference."""
    mesh = _cuda_mesh(2, 4)
    cfg = tget("smollm_360m")
    cell = tshapes.build_cell(cfg, "train_4k", mesh, nm_override=2)
    assert cell.skip_reason is None and cell.num_microbatches == 2
    assert cell.devices == {f"meta:{i}": f"cuda:{i}" for i in range(8)}
    wq = cell.args[0]["layers"]["wq"]
    assert [str(b.device) for b in wq.blocks] == \
        [f"meta:{i}" for i in range(8)]
    assert len({b.untyped_storage()._cdata for b in wq.blocks}) == 8
    for name in ("prefill_32k", "decode_32k"):
        cell = tshapes.build_cell(cfg, name, mesh)
        assert cell.skip_reason is None and cell.kind == name[:-4]
    assert cell.args[1]["k"].spec == (None, "data", "model", None, None)
    for arch, stub in (("whisper_tiny", "frames"),
                       ("internvl2_26b", "patches")):
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            cell = tshapes.build_cell(tget(arch), name, mesh)
            assert cell.skip_reason is None
            assert cell.kind == name.split("_")[0]
            if name == "decode_32k":
                assert ("ck" in cell.args[1]) == (stub == "frames")
            else:
                # (micro, batch, n, D) or (batch, n, D)
                assert cell.args[-1][stub].spec[-3] == "data"
    assert "sub-quadratic" in tshapes.build_cell(
        cfg, "long_500k", _cuda_mesh(1, 1)).skip_reason
    assert tshapes.build_cell(cfg, "prefill_32k",
                              _cuda_mesh(1, 1)).skip_reason is None


# --- the fake route ----------------------------------------------------------------

def _cases(dtype):
    q = (2, 64, 4, 64)
    kv = (2, 64, 2, 64)
    return {
        "flash_attention": ((q, kv, kv), lambda t: ops.flash_attention(*t)),
        "flash_attention_decode": (
            ((2, 1, 4, 64), kv, kv),
            lambda t: ops.flash_attention_decode(*t, cache_len=40)),
        "rmsnorm": (((2, 8, 96), (96,)), lambda t: ops.rmsnorm(*t)),
        "add": (((16, 96), (16, 96)), lambda t: ops.add(*t)),
        "fused_add_rmsnorm": (((2, 8, 96), (2, 8, 96), (96,)),
                              lambda t: ops.fused_add_rmsnorm(*t)),
        "ssd_scan": (((1, 32, 2, 16), "f32:1,32,2", "f32:2", (1, 32, 8),
                      (1, 32, 8)), lambda t: ops.ssd_scan(*t)),
    }


def _inputs(shapes, dtype, device):
    out = []
    for s in shapes:
        if isinstance(s, str):
            dims = tuple(int(x) for x in s[4:].split(","))
            out.append(torch.rand(dims, device=device) * 0.1)
        else:
            out.append(torch.randn(s, device=device).to(dtype))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_route_gives_the_plain_shapes(dtype, monkeypatch):
    """Every forward wrapper on fake tensors returns its plain version's
    shapes and dtypes (on the fake's device), counts into ``FAKE_CALLS``
    (never ``LAUNCHES``), tunes nothing under ``REPRO_KERNEL_AUTOTUNE``
    and hands the sinks the planner's FLOPs and bytes."""
    wants = {}
    for name, (shapes, call) in _cases(dtype).items():
        with torch.no_grad():
            wants[name] = call(_inputs(shapes, dtype, "cpu"))
    monkeypatch.setenv("REPRO_KERNEL_AUTOTUNE", "1")
    monkeypatch.setattr(ops.at, "autotune", lambda *a, **k: pytest.fail(
        "a fake call tuned"))
    got = []
    ops.FAKE_SINKS.append(lambda *a: got.append(a))
    try:
        for name, (shapes, call) in _cases(dtype).items():
            want = wants[name]
            ops.reset_launches()
            ops.reset_fake_calls()
            with FakeTensorMode(), torch.no_grad():
                out = call(_inputs(shapes, dtype, "meta:3"))
            want = want if isinstance(want, tuple) else (want,)
            out = out if isinstance(out, tuple) else (out,)
            assert [(tuple(o.shape), o.dtype) for o in out] == \
                [(tuple(w.shape), w.dtype) for w in want], name
            assert all(str(o.device) == "meta:3" for o in out), name
            assert ops.FAKE_CALLS[name] == 1 and sum(
                ops.FAKE_CALLS.values()) == 1, name
            assert not any(ops.LAUNCHES.values()), name
            assert got[-1][0] == name and got[-1][1] > 0 and got[-1][2] > 0
    finally:
        ops.FAKE_SINKS.pop()


def test_fake_route_backward_shapes():
    """The differentiable forms under autograd on fakes: the forward keeps
    the LSE, both backward kernels take their fake route, and each input's
    gradient has its shape and dtype."""
    def grads(device, mode):
        torch.manual_seed(0)
        q, k, v = (torch.randn(s, device=device).to(torch.bfloat16)
                   .requires_grad_() for s in
                   ((2, 64, 4, 64), (2, 64, 2, 64), (2, 64, 2, 64)))
        x, r = (torch.randn(2, 8, 96, device=device).requires_grad_()
                for _ in range(2))
        w = torch.ones(96, device=device).requires_grad_()
        o = ops.flash_attention(q, k, v)
        h, y = ops.fused_add_rmsnorm(x, r, w)
        loss = o.float().sum() + h.sum() + y.sum()
        return [(tuple(g.shape), g.dtype) for g in
                torch.autograd.grad(loss, [q, k, v, x, r, w])]
    want = grads("cpu", None)
    ops.reset_fake_calls()
    with FakeTensorMode():
        got = grads("meta:0", True)
    assert got == want
    assert ops.FAKE_CALLS == dict(ops.FAKE_CALLS, flash_attention=1,
                                  flash_attention_bwd=1, fused_add_rmsnorm=1,
                                  fused_add_rmsnorm_bwd=1)
    assert sum(ops.FAKE_CALLS.values()) == 4


# --- the collective record ---------------------------------------------------------

_DATA = dict(seq_len=16, global_batch=8, num_microbatches=2)


def _small_cfg(remat="full"):
    return dataclasses.replace(tget("smollm_360m").reduced(),
                               sharding="fsdp_tp", remat=remat)


def _real_step(cfg, mesh, record: bool):
    full = tmodel.init(cfg, 0, device="cpu")
    from repro_torch.dist.sharding import param_specs
    params = pm.shard_tree(full, param_specs(tmodel.decls(cfg), cfg.sharding,
                                             mesh), mesh)
    state = topt.init_sharded_state(params)
    batch = tdata.SyntheticDataset(cfg, tdata.DataConfig(**_DATA)).batch(0)
    step = tts.jit_train_step(cfg, topt.OptimizerConfig(), mesh, 2, 4)
    if not record:
        return step(params, state, batch), None
    with pm.record_collectives() as rec:
        out = step(params, state, batch)
    return out, rec


def test_record_leaves_the_step_bit_for_bit():
    """One (2, 2) ``fsdp_tp`` step with the record on equals the step with
    it off: loss, grad norm, every block of params and AdamW moments."""
    cfg, mesh = _small_cfg(), tmesh.data_model_mesh(2, 2, ["cpu"] * 4)
    (p0, s0, m0), _ = _real_step(cfg, mesh, False)
    (p1, s1, m1), rec = _real_step(cfg, mesh, True)
    assert rec.entries
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    for tree0, tree1 in ((p0, p1), (s0["m"], s1["m"]), (s0["v"], s1["v"])):
        for (_, a), (_, b) in zip(pm.tree_items(tree0), pm.tree_items(tree1)):
            assert all(torch.equal(x, y) for x, y in zip(a.blocks, b.blocks))


def test_fake_record_equals_the_real_record():
    """The same reduced fp32 step on a (2, 4) mesh: traced on fakes
    (``build_cell`` + ``trace_cell``) and run for real on ``[cpu] * 8``,
    record the same collectives entry for entry (kind, axes, groups,
    bytes, dtype, phase, order); the record holds forward, recompute and
    backward entries of every kind the step runs."""
    cfg = _small_cfg()
    _, real = _real_step(cfg, tmesh.data_model_mesh(2, 4, ["cpu"] * 8),
                         True)
    shape = tconfig.ShapeConfig("small", "train", _DATA["seq_len"],
                                _DATA["global_batch"], 2)
    cell = tshapes.build_cell(cfg, shape, _cuda_mesh(2, 4))
    trace = dryrun.trace_cell(cell)
    assert trace.record.entries == real.entries
    kinds = {(e.kind, e.phase) for e in real.entries}
    assert {("all-gather", "fwd"), ("all-gather", "recompute"),
            ("reduce-scatter", "bwd"), ("all-reduce", "fwd"),
            ("all-reduce", "bwd"), ("all-reduce-max", "fwd")} <= kinds
    # the kernels the card would launch, as fake calls: per position and
    # layer, the forward twice (remat) and each backward once
    per = cfg.n_layers * 2 * 8
    assert trace.kernel_calls == dict.fromkeys(ops.FAKE_CALLS, 0) | dict(
        flash_attention=2 * per, fused_add_rmsnorm=2 * per,
        flash_attention_bwd=per, fused_add_rmsnorm_bwd=per)


@pytest.mark.parametrize("arch,shape", [("whisper_tiny", (2, 2)),
                                        ("internvl2_26b", (2, 4))])
def test_fake_family_train_record_equals_the_real_record(arch, shape):
    """A reduced encdec and vlm train cell (full remat, two microbatches)
    on an ``fsdp_tp`` mesh (whisper's heads all split over 2, internvl2's
    query heads over 4 and its K/V heads whole): traced on fakes, it
    records what the real step records on ``[cpu] * n``, entry for entry,
    forward, recompute and backward; its fake kernel calls are the card's
    launches: the vlm's attention and fused norm twice a layer a
    microbatch a position (remat) and each backward once, whisper's
    none."""
    cfg = dataclasses.replace(_small_cfg(), **{
        k: v for k, v in dataclasses.asdict(tget(arch).reduced()).items()
        if k not in ("sharding", "remat")})
    n = shape[0] * shape[1]
    _, real = _real_step(cfg, tmesh.data_model_mesh(*shape, ["cpu"] * n),
                         True)
    cell = tconfig.ShapeConfig("small", "train", _DATA["seq_len"],
                               _DATA["global_batch"], 2)
    trace = dryrun.trace_cell(tshapes.build_cell(cfg, cell,
                                                 _cuda_mesh(*shape)))
    assert trace.record.entries == real.entries
    assert {("all-gather", "recompute"), ("reduce-scatter", "bwd"),
            ("all-reduce", "bwd")} <= {(e.kind, e.phase)
                                       for e in real.entries}
    calls = {k: v for k, v in trace.kernel_calls.items() if v}
    per = cfg.n_layers * 2 * n
    assert calls == ({} if cfg.family == "encdec" else dict(
        flash_attention=2 * per, fused_add_rmsnorm=2 * per,
        flash_attention_bwd=per, fused_add_rmsnorm_bwd=per))


def _real_serving(cfg, mesh, kind, batch, seq):
    """A real prefill (a vlm's ``seq`` counting its patches, with the
    stubbed frontend's zero input), or one decode step on a zeroed
    ``seq``-slot cache (its SSD state fp32, as ``cache_fakes`` lays it
    out), with the record on."""
    full = tmodel.init(cfg, 0, device="cpu")
    params = pm.shard_tree(full, param_specs(tmodel.decls(cfg), cfg.sharding,
                                             mesh), mesh)
    text = seq - cfg.n_patches if cfg.family == "vlm" else seq
    toks = torch.zeros((batch, text if kind == "prefill" else 1),
                       dtype=torch.int32)
    cache = tmodel.init_cache(cfg, batch, seq, mesh=mesh)
    if "ssm" in cache:
        cache["ssm"] = cache["ssm"].with_blocks(
            [b.float() for b in cache["ssm"].blocks])
    cache["len"] = seq - 1
    with torch.no_grad(), pm.record_collectives() as rec:
        if kind == "prefill":
            tss.make_prefill(cfg, mesh)(params, {
                "tokens": toks, **tmodel.stub_inputs(cfg, batch, "cpu")})
        else:
            tss.make_decode(cfg, mesh)(params, cache, toks)
    return rec


@pytest.mark.parametrize("arch,shape", [
    ("granite_20b", (2, 2)),     # the K/V sequence split, query heads split
    ("zamba2_2_7b", (1, 2)),     # the K/V head split, the SSD heads split
    ("whisper_tiny", (1, 4)),    # the slots split, ck/cv whole
    ("internvl2_26b", (2, 2))])  # the K/V head split after the patches
def test_fake_serving_record_equals_the_real_record(arch, shape):
    """The prefill and decode cells traced on fakes record what the real
    steps record on ``[cpu] * n``, entry for entry; the prefill's fake
    kernel calls are the card's launches (a layer a position; encdec's
    none), the decode step's none."""
    cfg = dataclasses.replace(tget(arch).reduced(), sharding="fsdp_tp")
    n = shape[0] * shape[1]
    for kind in ("prefill", "decode"):
        cell = tshapes.build_cell(cfg, tconfig.ShapeConfig(
            "small", kind, 16, 4), _cuda_mesh(*shape))
        trace = dryrun.trace_cell(cell)
        real = _real_serving(cfg, tmesh.data_model_mesh(*shape, ["cpu"] * n),
                             kind, 4, 16)
        assert trace.record.entries == real.entries, kind
        assert real.entries, kind
        calls = {k: v for k, v in trace.kernel_calls.items() if v}
        if kind == "decode" or cfg.family == "encdec":
            assert calls == {}
        elif cfg.family == "hybrid":
            assert calls == {"flash_attention": n * cfg.n_layers
                             // cfg.attn_every, "ssd_scan": n * cfg.n_layers}
        else:
            assert calls == {"flash_attention": n * cfg.n_layers,
                             "fused_add_rmsnorm": n * cfg.n_layers}


def test_collective_bytes_by_kind():
    entries = [pm.CollectiveEntry("all-reduce", ("model",), ((0, 1), (2, 3)),
                                  1024, "float32", "fwd"),
               pm.CollectiveEntry("all-gather", ("data",), ((0, 2), (1, 3)),
                                  512, "float32", "fwd"),
               pm.CollectiveEntry("all-reduce-max", ("model",),
                                  ((0, 1, 2, 3),), 64, "float32", "fwd")]
    stats = comm.collective_bytes(entries)
    assert stats.by_kind == {"all-reduce": (1, 1024, 1024.0),
                             "all-gather": (1, 512, 256.0),
                             "all-reduce-max": (1, 64, 96.0)}
    assert stats.total_bytes == 1600 and stats.total_traffic == 1376.0
    from repro.launch.hlo import ring_traffic as jring
    for kind in ("all-reduce", "all-gather", "reduce-scatter",
                 "collective-permute"):
        for k in (1, 2, 8):
            assert comm.ring_traffic(kind, 4096, k) == jring(kind, 4096, k)


# --- costs -------------------------------------------------------------------------

def test_program_cost_counts_flops_bytes_and_peak():
    """A matmul's FLOPs by the registered formula, its operands and output
    as bytes, views and allocations as none, and the peak of live storage
    with the base counted from the start and freed storage taken off."""
    with FakeTensorMode():
        a = torch.empty(64, 32, device="meta:1")
        b = torch.empty(32, 16, device="meta:1")
        with pc.ProgramCost(base=[a, b]) as cost:
            c = a @ b                       # 4 KiB out
            d = c.t()                       # a view: no bytes, no storage
            e = torch.empty(1024, device="meta:1")
            del e
            f = torch.relu(c)
    s = cost.summary()["meta:1"]
    assert s.flops == 2 * 64 * 32 * 16
    assert s.bytes_accessed == (64 * 32 + 32 * 16 + 64 * 16) * 4 + \
        2 * 64 * 16 * 4
    assert cost.base["meta:1"] == (64 * 32 + 32 * 16) * 4
    assert s.peak_bytes == cost.base["meta:1"] + 64 * 16 * 4 + 4096
    assert d.shape == (16, 64) and f.shape == (64, 16)


def test_dryrun_flops_near_the_references():
    """The reduced smollm config's one-device train step (fp32, remat
    none, seq 128, one microbatch): the dry run's FLOPs against
    ``hlo_cost.analyze`` of the reference's compiled ``make_train_step``.
    The gap is the attention: the port prices its kernel by the planner's
    formula, causal halved (forward 2 b h s^2 d, backward 2.5 times that,
    the recomputed scores included), where XLA's plain attention
    multiplies the full score matrix (forward 4 b h s^2 d, backward 8);
    5 b h s^2 d a layer.  Every other product is the same, so with the
    gap added back the two agree within 1% (18% apart without it, the
    port below; remat is none on both, so no recompute enters)."""
    over = dict(head_dim=64)
    jcfg = dataclasses.replace(jget("smollm_360m").reduced(), **over)
    tcfg = dataclasses.replace(tget("smollm_360m").reduced(), **over)
    b, s = 4, 128
    from repro.models import model as jmodel
    params = jax.eval_shape(lambda: jmodel.init(jcfg, jax.random.PRNGKey(0)))
    opt_state = jax.eval_shape(jopt.init_state, params)
    batch = {"tokens": jax.ShapeDtypeStruct((1, b, s), np.int32),
             "labels": jax.ShapeDtypeStruct((1, b, s), np.int32)}
    step = jts.make_train_step(jcfg, jopt.OptimizerConfig())
    txt = jax.jit(step).lower(params, opt_state, batch).compile().as_text()
    ref = jhlo_cost.analyze(txt).flops
    shape = tconfig.ShapeConfig("small", "train", s, b, 1)
    cell = tshapes.build_cell(tcfg, shape, _cuda_mesh(1, 1))
    per = dryrun.device_costs(cell, dryrun.trace_cell(cell))
    got = per["cuda:0"].flops
    gap = 5.0 * tcfg.n_layers * b * tcfg.n_heads * s * s * tcfg.hd
    assert abs(got + gap - ref) / ref < 0.01, (got, gap, ref)
    assert got < ref


# --- run_cell and the CLI ----------------------------------------------------------

def test_run_cell_small_mesh_train_cell(tmp_path):
    """``run_cell`` on an 8-position mesh of fake ``cuda:i`` devices, as the
    reference's ``test_dryrun_small_mesh_cell`` calls it: the record's
    fields, the audit under ``audit=True``; the serving cells run
    (the sharded prefill through the kernels' fake route, the decode step
    on the plain route), their audit left out as in the reference."""
    mesh = _cuda_mesh(2, 4)
    over = dict(_reduced_overrides("smollm_360m"), num_microbatches=1,
                sharding="fsdp_tp")
    rec = dryrun.run_cell("smollm_360m", "train_4k", False, str(tmp_path),
                          mesh=mesh, overrides=over, audit=True)
    assert rec["ok"] and not rec["skipped"], rec.get("traceback")
    for key in ("flops", "bytes_accessed", "peak_bytes", "argument_bytes"):
        assert rec["per_device"][key] > 0, key
    assert rec["n_chips"] == 8 and rec["mesh_shape"] == {"data": 2,
                                                         "model": 4}
    assert set(rec["by_device"]) == {f"cuda:{i}" for i in range(8)}
    assert rec["fits_hbm"] is True
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert {"all-reduce", "all-gather", "reduce-scatter"} <= \
        set(rec["collectives_raw"])
    assert rec["model_flops_total"] > 0 and rec["useful_flops_ratio"] > 0
    assert rec["audit"]["tag"] == "smollm_360m__train_4k__single"
    assert "rel_diff" in rec["audit"]["summary"]
    saved = json.load(open(tmp_path / "smollm_360m__train_4k__single.json"))
    assert saved["per_device"] == rec["per_device"]
    # the serving cells on (2, 2) (the K/V head split; the sequence
    # split's record: test_fake_serving_record_equals_the_real_record)
    n = over["n_layers"] * 4
    for name, calls in (("prefill_32k", {"flash_attention": n,
                                         "fused_add_rmsnorm": n}),
                        ("decode_32k", {})):
        r = dryrun.run_cell("smollm_360m", name, False, str(tmp_path),
                            mesh=_cuda_mesh(2, 2), overrides=over,
                            audit=True)
        assert r["ok"] and not r["skipped"], r.get("traceback")
        assert r["kernel_calls"] == calls and "audit" not in r
        assert r["per_device"]["flops"] > 0 and r["fits_hbm"] is True
        assert {"all-reduce", "all-gather"} <= set(r["collectives_raw"])


@pytest.mark.parametrize("arch", ["whisper_tiny", "internvl2_26b"])
def test_run_cell_traces_the_stub_families_cells(arch, tmp_path):
    """The named ``train_4k``, ``prefill_32k`` and ``decode_32k`` cells of
    the reduced whisper and internvl2 (one microbatch) run on a (2, 2)
    ``fsdp_tp`` mesh of fake ``cuda:i`` with no skip: the vlm's fake
    kernel calls are the attention and fused norm (and each backward in
    the train cell) once a layer a position, whisper's none, and no
    decode step calls a kernel."""
    over = dict(_reduced_overrides(arch), num_microbatches=1,
                sharding="fsdp_tp")
    n = over["n_layers"] * 4
    fwd = {} if arch == "whisper_tiny" else dict(flash_attention=n,
                                                 fused_add_rmsnorm=n)
    bwd = {} if arch == "whisper_tiny" else dict(flash_attention_bwd=n,
                                                 fused_add_rmsnorm_bwd=n)
    for name, calls in (("train_4k", dict(fwd, **bwd)),
                        ("prefill_32k", fwd), ("decode_32k", {})):
        rec = dryrun.run_cell(arch, name, False, str(tmp_path),
                              mesh=_cuda_mesh(2, 2), overrides=over)
        assert rec["ok"] and not rec["skipped"], rec.get("traceback")
        assert rec["kernel_calls"] == calls, name
        assert rec["per_device"]["flops"] > 0, name
        assert "all-gather" in rec["collectives_raw"], name


def test_run_cell_serving_on_one_position_and_fail(tmp_path):
    """Prefill and decode run on a one-position mesh (the decode cache on
    fakes, the SSM family's prefill through the SSD kernel's fake route);
    an exception is a FAIL in the record and the CLI exits non-zero."""
    one = _cuda_mesh(1, 1)
    over = _reduced_overrides("mamba2_130m")
    for name in ("prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("mamba2_130m", name, False, str(tmp_path),
                              mesh=one, overrides=over)
        assert rec["ok"] and not rec["skipped"], rec.get("traceback")
    assert rec["kernel_calls"] == {}            # decode: the plain step
    pre = json.load(open(tmp_path / "mamba2_130m__prefill_32k__single.json"))
    assert pre["kernel_calls"] == {"ssd_scan": over["n_layers"]}
    bad = dryrun.run_cell("smollm_360m", "train_4k", False, str(tmp_path),
                          mesh=one, overrides={"sharding": "bogus"})
    assert not bad["ok"] and "KeyError" in bad["error"]
    assert dryrun.main(["--arch", "smollm_360m", "--shape", "long_500k",
                        "--mesh", "single", "--out", str(tmp_path)]) == 0


def test_stand_ins_keep_the_card_routes():
    """Inside ``meta_stands_for_cuda`` a ``meta`` device picks the card's
    routes, outside it the CPU's."""
    from repro_torch.models import layers, mamba2
    assert layers.pick_attn_impl("auto", 128, "meta:0") == "naive"
    with meta_stands_for_cuda():
        assert layers.pick_attn_impl("auto", 128, "meta:0") == "kernel"
        assert mamba2.pick_ssd_impl("meta:2", prefill=True,
                                    grad=False) == "kernel"
        assert layers.pick_attn_impl("auto", 128, "cpu") == "naive"
    assert mamba2.pick_ssd_impl("meta:2", prefill=True,
                                grad=False) == "chunked"


# --- the replay (trip counts) ------------------------------------------------------

# one reduced config a family, every loop of its step at a count of 2 or
# more: 3 layers (the hybrid 2 groups of 2; whisper 3 encoder layers too),
# 2 microbatches, and the dense and vlm losses in chunks (16 positions in
# chunks of 5: the last one padded); the (2, 2) mesh has its positions on
# one device, as chip_smoke's [dryrun] cell (members of a group then share
# a collective's result), the (1, 2) mesh one device a position
_REPLAY = {"dense": ("smollm_360m", dict(n_layers=3, logits_chunk=5)),
           "moe": ("dbrx_132b", dict(n_layers=3)),
           "ssm": ("mamba2_130m", dict(n_layers=3)),
           "hybrid": ("zamba2_2_7b", dict(n_layers=4, attn_every=2)),
           "encdec": ("whisper_tiny", dict(n_layers=3, n_encoder_layers=3)),
           "vlm": ("internvl2_26b", dict(n_layers=3, logits_chunk=5))}


def _replay_cell(family, kind, policy, shape, deeper=False):
    arch, over = _REPLAY[family]
    n = shape[0] * shape[1]
    devices = dryrun.fake_devices(1) * n if shape == (2, 2) \
        else dryrun.fake_devices(n)
    over = dict(over)
    if deeper:
        for k in ("n_layers", "n_encoder_layers"):
            if k in over:
                over[k] *= 2
    cfg = dataclasses.replace(tget(arch).reduced(), sharding=policy, **over)
    cell = tconfig.ShapeConfig("small", kind, 16, 8 if kind == "train" else 4,
                               2 if kind == "train" else 0)
    return tshapes.build_cell(cfg, cell,
                              tmesh.data_model_mesh(*shape, devices))


@pytest.mark.parametrize("policy,shape", [("fsdp_tp", (2, 2)),
                                          ("tp", (1, 2))])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", list(_REPLAY))
def test_replay_equals_the_full_trace(family, kind, policy, shape):
    """Each loop replayed as one trip of its count (``trace_cell``'s
    default, ``program_cost.replay``) gives the full trace's program: per
    device FLOPs and bytes within 1e-9 relative, the peak live bytes
    exactly, the same fake kernel calls and the same collective record
    entry for entry, every loop of the step having replayed (its trip in
    ``trips``).  On (1, 2) the replay dispatches as many ops at twice the
    depth."""
    full = dryrun.trace_cell(_replay_cell(family, kind, policy, shape),
                             replay=False)
    rep = dryrun.trace_cell(_replay_cell(family, kind, policy, shape))
    assert full.trips == {}
    want = {"layers"} | ({"microbatches"} if kind == "train" else set())
    if family == "hybrid":
        want = want - {"layers"} | {"groups", "layers_per_group"}
    if family == "encdec" and kind != "decode":
        want |= {"encoder_layers"}
    if kind == "train" and family in ("dense", "vlm"):
        want |= {"loss_chunks"}
    assert set(rep.trips) == want and min(rep.trips.values()) >= 2, \
        rep.trips
    fs, rs = full.cost.summary(), rep.cost.summary()
    assert sorted(fs) == sorted(rs)
    for dev, f in fs.items():
        r = rs[dev]
        assert r.flops == pytest.approx(f.flops, rel=1e-9, abs=0), dev
        assert r.bytes_accessed == pytest.approx(f.bytes_accessed, rel=1e-9,
                                                 abs=0), dev
        assert r.peak_bytes == f.peak_bytes, dev
    assert rep.kernel_calls == full.kernel_calls
    assert rep.record.entries == full.record.entries
    assert rep.cost.dispatched < full.cost.dispatched
    if shape == (1, 2):
        deeper = dryrun.trace_cell(_replay_cell(family, kind, policy, shape,
                                                deeper=True))
        assert deeper.cost.dispatched == rep.cost.dispatched


@pytest.mark.parametrize("family,shape", [
    ("dense", (1, 4)), ("ssm", (1, 4)), ("hybrid", (1, 4)),
    ("encdec", (1, 4)), ("vlm", (1, 4)), ("dense", (1, 3))])
def test_replay_equals_the_full_trace_where_the_loss_reads_some_positions(
        family, shape):
    """A train cell whose logits the 'model' axis does not split (vocab
    250 on 4, or nothing split on 3): the loss reads only 'model' index
    0's last layer, the next layer every position's, so each layer loop
    replays its last layer apart (``spmd.last_apart``); on (1, 3) the
    other positions are read nowhere.  The replay equals the full trace
    as ``test_replay_equals_the_full_trace`` holds it."""
    arch, over = _REPLAY[family]
    over = dict(over, sharding="tp", vocab_size=250 if shape == (1, 4)
                else 256)
    cfg = dataclasses.replace(tget(arch).reduced(), **over)
    cell = tconfig.ShapeConfig("small", "train", 16, 8, 2)

    def trace(replay):
        mesh = tmesh.data_model_mesh(*shape, dryrun.fake_devices(shape[1]))
        return dryrun.trace_cell(tshapes.build_cell(cfg, cell, mesh),
                                 replay=replay)
    assert dryrun.trace_differences(trace(False), trace(True)) == []
