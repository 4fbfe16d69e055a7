"""The port's profiler (catalog, kernel cost tables, analytic profile,
kernel calibration) vs the reference's.

The port keeps copies of ``hw_specs``, ``network``, ``kernel_costs`` and
``analytic``; they must give the reference's numbers exactly (``==``: the
same Python arithmetic on the same inputs), for every registered arch and
accelerator, including the port's ``"H100"`` entry, which the tests add to
the reference's catalog with ``monkeypatch`` (its file is not edited).
Cost tables cross between the packages through their shared JSON schema.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.profiler import analytic as janalytic
from repro.core.profiler import hw_specs as jhw
from repro.core.profiler import kernel_costs as jkc
from repro.core.profiler import measured as jmeasured
from repro.core.simulator import network as jnet
from repro_torch.bench import kernels_bench
from repro_torch.configs import ARCH_IDS, PAPER_IDS
from repro_torch.configs import get_config as tget
from repro_torch.core.profiler import analytic as tanalytic
from repro_torch.core.profiler import hw_specs as thw
from repro_torch.core.profiler import kernel_costs as tkc
from repro_torch.core.profiler import measured as tmeasured
from repro_torch.core.simulator import network as tnet
from repro_torch.kernels import autotune as tat

ARCHS = ARCH_IDS + PAPER_IDS
OP_SHAPES = {"flash_attention": [(4, 256, 256, 64, 1), (120, 512, 512, 64, 1),
                                 (8, 130, 70, 80, 0)],
             "flash_decode": [(4, 256, 64), (120, 549, 64)],
             "rmsnorm": [(512, 256), (4096, 960)],
             "fused_add_rmsnorm": [(512, 256), (4096, 960)],
             "ssd_scan": [(1, 128, 2, 32, 16), (1, 2048, 24, 64, 128)]}


@pytest.fixture(autouse=True)
def _both_catalogs_and_clean_registries(monkeypatch):
    monkeypatch.setitem(jhw.ACCELERATORS, "H100", jhw.AcceleratorSpec(
        **dataclasses.asdict(thw.ACCELERATORS["H100"])))
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()
    yield
    jkc.clear_kernel_tables()
    tkc.clear_kernel_tables()


# --- catalog and network ----------------------------------------------------------

def test_catalog_is_the_reference_catalog_plus_h100():
    h100 = thw.get_accelerator("H100")
    assert (h100.peak_flops, h100.mem_bytes, h100.mem_bw, h100.intra_node_bw,
            h100.chips_per_node, h100.efficiency) == \
        (989e12, 80e9, 3.35e12, 900e9, 8, 0.45)
    assert h100.price_per_hour > 0
    assert sorted(thw.ACCELERATORS) == sorted(jhw.ACCELERATORS)
    for name, spec in thw.ACCELERATORS.items():
        assert dataclasses.asdict(spec) == \
            dataclasses.asdict(jhw.ACCELERATORS[name])
        assert spec.roofline_time(3e12, 5e9) == \
            jhw.ACCELERATORS[name].roofline_time(3e12, 5e9)
    assert {k: dataclasses.asdict(v) for k, v in thw.LINKS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jhw.LINKS.items()}
    assert str(thw.kernel_table_path("H100")) == \
        str(jhw.kernel_table_path("H100"))


@pytest.mark.parametrize("fn", ["all_reduce_time", "all_gather_time",
                                "reduce_scatter_time", "all_to_all_time"])
def test_network_models_equal(fn):
    for link in thw.LINKS:
        for nbytes in (0.0, 1e3, 7.5e8):
            for k in (1, 2, 8):
                assert getattr(tnet, fn)(thw.LINKS[link], nbytes, k) == \
                    getattr(jnet, fn)(jhw.LINKS[link], nbytes, k)
    assert tnet.hierarchical_all_reduce_time(
        thw.LINKS["intra-node"], thw.LINKS["dcn"], 1e8, 4, 3) == \
        jnet.hierarchical_all_reduce_time(
            jhw.LINKS["intra-node"], jhw.LINKS["dcn"], 1e8, 4, 3)


# --- kernel cost tables ------------------------------------------------------------

@pytest.mark.parametrize("op", tkc.KERNEL_OPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_roofline_equal(op, dtype):
    for shape in OP_SHAPES[op]:
        assert tkc.op_flops_bytes(op, shape, dtype) == \
            jkc.op_flops_bytes(op, shape, dtype)
        for chip in thw.ACCELERATORS:
            assert tkc.roofline_time(op, shape, dtype,
                                     thw.ACCELERATORS[chip]) == \
                jkc.roofline_time(op, shape, dtype, jhw.ACCELERATORS[chip])
    with pytest.raises(ValueError, match="unknown kernel op"):
        tkc.op_flops_bytes("gemm", (1,), dtype)


def _tables(seed=0):
    """The same measured points in a reference and a port table."""
    rng = np.random.default_rng(seed)
    jt, tt = jkc.KernelCostTable(chip="H100"), tkc.KernelCostTable(chip="H100")
    for op, shapes in OP_SHAPES.items():
        for dtype in ("float32", "bfloat16"):
            for shape in shapes:
                for f in (0.5, 1.0, 3.0):
                    sh = (max(1, int(shape[0] * f)),) + tuple(shape[1:])
                    t = float(rng.uniform(1e-6, 1e-3))
                    jt.add(op, sh, dtype, t)
                    tt.add(op, sh, dtype, t)
    return jt, tt


def _probe_shapes():
    for op, shapes in OP_SHAPES.items():
        for shape in shapes:
            for f in (0.25, 0.5, 0.7, 1.0, 1.9, 3.0, 5.0):
                yield op, (max(1, int(shape[0] * f)),) + tuple(shape[1:])


def test_lookup_equal():
    jt, tt = _tables()
    assert tt.n_points() == jt.n_points()
    hits = 0
    for op, shape in _probe_shapes():
        for dtype in ("float32", "bfloat16", "float16"):
            got = tt.lookup(op, shape, dtype)
            assert got == jt.lookup(op, shape, dtype), (op, shape, dtype)
            hits += got is not None
    assert hits > 0


def test_tables_round_trip_between_the_packages(tmp_path):
    jt, tt = _tables(1)
    tt.save(tmp_path / "port.json")
    jt.save(tmp_path / "ref.json")
    into_ref = jkc.KernelCostTable.load(tmp_path / "port.json")
    into_port = tkc.KernelCostTable.load(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    assert into_ref.chip == into_port.chip == "H100"
    for op, shape in _probe_shapes():
        for dtype in ("float32", "bfloat16"):
            want = jt.lookup(op, shape, dtype)
            assert into_ref.lookup(op, shape, dtype) == want
            assert into_port.lookup(op, shape, dtype) == want


# --- the analytic profile -------------------------------------------------------

def _profile_pairs(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    train = (janalytic.JobProfile(janalytic.TrainJob(jcfg, 512, 8)),
             tanalytic.JobProfile(tanalytic.TrainJob(tcfg, 512, 8)))
    serve = (janalytic.JobProfile(janalytic.ServeJob(jcfg, prompt_len=256)),
             tanalytic.JobProfile(tanalytic.ServeJob(tcfg, prompt_len=256)))
    return train, serve


def _register_block_tables(*profiles):
    """Exact hits at 3x the roofline for every kernel op the port's
    ``profiles`` price, in both registries."""
    jt, tt = (jkc.KernelCostTable(chip="H100"),
              tkc.KernelCostTable(chip="H100"))
    acc = thw.ACCELERATORS["H100"]
    dtype = profiles[0].cfg.dtype
    ops = set()
    for prof in profiles:
        for kind in ("block", "head"):
            for tp in (1, 2):
                for mbs in (1, 4, 8):
                    ops.update(prof._layer_kernel_ops(kind, tp, mbs))
                    ops.update(prof._decode_kernel_ops(kind, tp, mbs, 300))
    for op, shape, _ in sorted(ops):
        t = 3.0 * tkc.roofline_time(op, shape, dtype, acc)
        jt.add(op, shape, dtype, t)
        tt.add(op, shape, dtype, t)
    jkc.register_kernel_table(jt)
    tkc.register_kernel_table(tt)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("with_table", [False, True])
def test_job_profile_equal(arch, with_table):
    (jtr, ttr), (jsv, tsv) = _profile_pairs(arch)
    if with_table:
        _register_block_tables(ttr, tsv)
    assert ttr.layer_kinds() == jtr.layer_kinds()
    n = ttr.n_partition_units
    for gpu in thw.ACCELERATORS:
        for tp in (1, 2):
            for mbs in (1, 4):
                for kind in ("embed", "block", "head"):
                    assert ttr.cost(kind, gpu, tp, mbs).__dict__ == \
                        jtr.cost(kind, gpu, tp, mbs).__dict__
                    assert tsv.decode_cost(kind, gpu, tp, mbs, 300) == \
                        jsv.decode_cost(kind, gpu, tp, mbs, 300)
                assert ttr.stage_cost(0, n, gpu, tp, mbs) == \
                    jtr.stage_cost(0, n, gpu, tp, mbs)
                assert ttr.replica_rate(1, n - 1, gpu, tp, mbs) == \
                    jtr.replica_rate(1, n - 1, gpu, tp, mbs)
                assert tsv.stage_decode_time(0, n, gpu, tp, mbs, 549) == \
                    jsv.stage_decode_time(0, n, gpu, tp, mbs, 549)
                assert tsv.stage_prefill_time(0, n, gpu, tp, mbs) == \
                    jsv.stage_prefill_time(0, n, gpu, tp, mbs)
    for mbs in (1, 4):
        assert ttr.stage_params(0, n) == jtr.stage_params(0, n)
        assert ttr.stage_act_store(0, n, mbs) == jtr.stage_act_store(0, n, mbs)
        for phase in ("train", "serve"):
            assert ttr.stage_act_work(0, n, mbs, 4, phase) == \
                jtr.stage_act_work(0, n, mbs, 4, phase)
        assert ttr.boundary_bytes(mbs) == jtr.boundary_bytes(mbs)


def test_registered_table_moves_the_price():
    """A table on the chip being priced changes ``cost`` and
    ``decode_cost``; clearing it restores the roofline price."""
    (jtr, ttr), (jsv, tsv) = _profile_pairs("smollm_360m")
    base = ttr.cost("block", "H100", 1, 8).fwd
    base_dec = tsv.decode_cost("block", "H100", 1, 8, 300)
    _register_block_tables(ttr, tsv)
    assert ttr.cost("block", "H100", 1, 8).fwd > base
    assert tsv.decode_cost("block", "H100", 1, 8, 300) > base_dec
    tkc.clear_kernel_tables()
    assert ttr.cost("block", "H100", 1, 8).fwd == base


# --- kernel calibration and the benchmark ----------------------------------------

_GRID = dict(attn_shapes=((2, 64, 32),), decode_shapes=((2, 64, 32),),
             norm_shapes=((64, 64), (256, 64)),
             ssd_shapes=((1, 64, 1, 32, 16),))


def test_calibrate_kernels_registers_and_saves(tmp_path):
    p = tmp_path / "costs.json"
    cal = tmeasured.calibrate_kernels("cpu-host", iters=1, register=True,
                                      path=p, device="cpu", **_GRID)
    assert cal.table.n_points() == 7   # fused rides with the norm grid
    assert tkc.get_kernel_table("cpu-host") is cal.table
    assert all(r["time_s"] > 0 and r["roofline_s"] > 0 for r in cal.points)
    assert cal.table.lookup("rmsnorm", (128, 64), "float32") is not None
    ref = jmeasured.calibrate_kernels("cpu-host", iters=1, register=False,
                                      **_GRID)
    assert {(op, dt, sh) for (op, dt), rows in cal.table.entries.items()
            for sh, _ in rows} == \
        {(op, dt, sh) for (op, dt), rows in ref.table.entries.items()
         for sh, _ in rows}
    assert [(r["op"], r["shape"], r["roofline_s"]) for r in cal.points] == \
        [(r["op"], r["shape"], r["roofline_s"]) for r in ref.points]
    loaded = jkc.KernelCostTable.load(p)          # the reference reads it
    assert loaded.lookup("rmsnorm", (64, 64), "float32") == \
        cal.table.lookup("rmsnorm", (64, 64), "float32")


def test_calibrate_kernels_refuses_what_is_not_ported(monkeypatch):
    with pytest.raises(NotImplementedError, match="autotuner"):
        tmeasured.calibrate_kernels(device="cpu", autotune_blocks=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmeasured.calibrate_kernels("H100")


def test_default_chip(monkeypatch):
    assert tat.default_chip() == "cpu-host"
    assert tat.default_chip("cpu") == "cpu-host"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert tat.default_chip("cuda") == "H100"
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA A100-SXM4-80GB")
    assert tat.default_chip("cuda") == "nvidia-a100-sxm4-80gb"
    # the catalog's "H100" is the SXM card's data sheet: other H100s keep
    # their own names, as the reference keys a chip by its device kind
    for name, key in (("NVIDIA H100 PCIe", "nvidia-h100-pcie"),
                      ("NVIDIA H100 NVL", "nvidia-h100-nvl"),
                      (tat.H100_SXM_NAME, "H100")):
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
        assert tat.default_chip("cuda") == key


def test_bench_time_on_the_cpu_is_a_median():
    calls = []
    t = tat.bench_time(lambda: calls.append(1), warmup=2, iters=5)
    assert len(calls) == 7 and t >= 0


def test_kernels_bench_on_the_cpu():
    """The benchmark's two sections run end to end on the plain versions."""
    fu = kernels_bench.fused_vs_unfused(64, 128, iters=1, device="cpu")
    assert fu["fused_s"] > 0 and fu["unfused_s"] > 0
    assert fu["speedup"] == fu["unfused_s"] / fu["fused_s"]
    cal = tmeasured.calibrate_kernels("cpu-host", iters=1, register=False,
                                      device="cpu", **{
                                          **_GRID,
                                          "attn_shapes": ((2, 64, 32),
                                                          (2, 128, 32))})
    acc = kernels_bench.cost_table_accuracy(
        cal.table, [("flash_attention", (2, 96, 96, 32, 1)),
                    ("rmsnorm", (128, 64)), ("fused_add_rmsnorm", (128, 64))],
        iters=1, device="cpu")
    res = acc["float32"]
    assert len(res["rows"]) == 3
    for key in ("median_table_err", "median_roofline_err",
                "suite_table_err", "suite_roofline_err"):
        assert np.isfinite(res[key]) and res[key] >= 0
    with pytest.raises(ValueError, match="outside"):
        kernels_bench.cost_table_accuracy(
            cal.table, [("rmsnorm", (4096, 64))], iters=1, device="cpu")


# --- the block-time fit: measure_block, calibrate_cpu_host ---------------------------

_ROWS = [[(1, 2e-3, 7e-3), (2, 3.5e-3, 1.3e-2), (4, 7e-3, 2.4e-2)],
         [(1, 0.0, 4e-4), (2, 5e-4, 1e-12)]]


@pytest.mark.parametrize("arch", ["smollm_360m", "opt-350m"])
@pytest.mark.parametrize("rows", _ROWS)
@pytest.mark.parametrize("seq_len", [128, 1024])
def test_calibrate_cpu_host_equals_reference_on_the_same_rows(
        monkeypatch, arch, rows, seq_len):
    """The same measured rows give the reference's spec (its arithmetic,
    its ``cpu-host`` base on the CPU)."""
    seen = []
    monkeypatch.setattr(jmeasured, "measure_block",
                        lambda cfg, s, *a, **kw: seen.append(s) or rows)
    monkeypatch.setattr(tmeasured, "measure_block",
                        lambda cfg, s, *a, **kw: seen.append(kw) or rows)
    got = tmeasured.calibrate_cpu_host(tget(arch), seq_len, device="cpu")
    want = jmeasured.calibrate_cpu_host(jget(arch), seq_len)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.name, got.efficiency) == ("cpu-host", 1.0)
    assert seen == [{"dtype": "float32", "device": torch.device("cpu")},
                    seq_len]


def test_calibrate_cpu_host_fits_the_entry_of_the_device(monkeypatch):
    """The base entry is the catalog's for ``default_chip`` of the device:
    ``"H100"`` on an H100, with only ``peak_flops`` and ``efficiency``
    replaced; ``dtype`` reaches ``measure_block``."""
    seen = []
    monkeypatch.setattr(tmeasured, "measure_block",
                        lambda cfg, s, *a, **kw: seen.append(kw) or _ROWS[0])
    monkeypatch.setattr(tmeasured.at, "default_chip", lambda dev: "H100")
    got = tmeasured.calibrate_cpu_host(tget("smollm_360m"), 1024,
                                       dtype="bfloat16", device="cpu")
    h100 = thw.ACCELERATORS["H100"]
    assert dataclasses.asdict(got) == dataclasses.asdict(dataclasses.replace(
        h100, peak_flops=got.peak_flops, efficiency=1.0))
    assert got.peak_flops != h100.peak_flops
    assert seen[0]["dtype"] == "bfloat16"
    tmeasured.register_calibrated(got, "H100")
    try:
        assert thw.get_accelerator("H100") == got
    finally:
        tmeasured.register_calibrated(h100, "H100")


def test_calibrate_cpu_host_refuses_a_card_without_an_entry(monkeypatch):
    """A card the catalog has no entry for raises ``ValueError`` naming it
    and the catalog's keys, before anything is measured."""
    monkeypatch.setattr(tmeasured, "measure_block",
                        lambda *a, **kw: pytest.fail("measured"))
    monkeypatch.setattr(tmeasured.at, "default_chip",
                        lambda dev: "nvidia-a100-sxm4-40gb")
    with pytest.raises(ValueError, match="nvidia-a100-sxm4-40gb.*H100"):
        tmeasured.calibrate_cpu_host(tget("smollm_360m"), device="cpu")


@pytest.mark.parametrize("name,key", [
    ("NVIDIA H100 PCIe", "nvidia-h100-pcie"),
    ("NVIDIA H100 NVL", "nvidia-h100-nvl")])
def test_catalog_entry_refuses_an_h100_that_is_not_the_sxm(monkeypatch, name,
                                                          key):
    """An H100 other than the SXM card has no catalog entry: the SXM's
    is not fitted or priced in its place.  ``catalog_entry`` raises
    ``ValueError`` naming the card's own key, and ``calibrate_cpu_host``
    raises before anything is measured."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)
    monkeypatch.setattr(tmeasured, "measure_block",
                        lambda *a, **kw: pytest.fail("measured"))
    with pytest.raises(ValueError, match=f"'{key}'"):
        tmeasured.catalog_entry("cuda")
    with pytest.raises(ValueError, match=f"'{key}'.*H100"):
        tmeasured.calibrate_cpu_host(tget("smollm_360m"), device="cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_measure_block_runs_the_one_layer_model_on_the_cpu(monkeypatch,
                                                           dtype):
    """The reference's one-layer model (n_layers 1, vocab at most 1024, no
    remat, ``dtype`` throughout), timed eagerly by the host clock."""
    cfg = dataclasses.replace(tget("smollm_360m").reduced(), vocab_size=4096)
    made = []
    init = tmeasured.model_lib.init
    monkeypatch.setattr(tmeasured.model_lib, "init",
                        lambda one, seed, device: made.append(
                            (one, seed, device)) or init(one, seed,
                                                         device=device))
    rows = tmeasured.measure_block(cfg, 32, (1, 2), dtype=dtype,
                                   device="cpu")
    assert [r[0] for r in rows] == [1, 2]
    assert all(np.isfinite(t) and t > 0 for r in rows for t in r[1:])
    (one, seed, device), = made
    assert (one.n_layers, one.vocab_size, one.remat, one.dtype,
            one.param_dtype, seed, device.type) == \
        (1, 1024, "none", dtype, dtype, 0, "cpu")


def test_measure_block_programs_match_the_reference():
    """The two programs ``measure_block`` times compute the reference's
    ``jax.jit`` forward and ``jax.grad`` of ``loss_fn`` on the same
    one-layer model and batch (fp32: logits 1e-5, every gradient leaf 1e-4
    of its max |g|).  ``block_batch`` is the reference's all-zero batch;
    on it every position sees the same key, so the attention weights'
    gradients are rounding noise, and the programs are held on seeded
    tokens of the same shape instead."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as jm
    from repro.train.checkpoint import _flatten
    from repro_torch import graphs
    from test_torch_model import both_params, configs

    jcfg, tcfg = configs("smollm_360m", n_layers=1, remat="none")
    jp, tp = both_params(jcfg, tcfg, seed=4)
    tb = tmeasured.block_batch(tcfg, 2, 24, "cpu")
    assert {k: tuple(v.shape) for k, v in tb.items()} == \
        {"tokens": (2, 24), "labels": (2, 24)}
    assert all(v.dtype == torch.int32 and not v.any() for v in tb.values())
    rng = np.random.default_rng(4)
    tb = {k: torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 24),
                                           dtype=np.int32)) for k in tb}
    fwd, grad = tmeasured.block_programs(tcfg, tp, tb)
    batch = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    want = np.asarray(jm.forward(jcfg, jp, batch))
    np.testing.assert_allclose(fwd().numpy(), want, rtol=0, atol=1e-5)
    wg = _flatten(jax.grad(lambda p: jm.loss_fn(jcfg, p, batch)[0])(jp))
    got = grad()
    paths = [k for k, _ in graphs.tree_leaves(tp)]
    assert sorted(paths) == sorted(wg) and len(got) == len(paths)
    for k, g in zip(paths, got):
        w = np.asarray(wg[k], np.float32)
        assert g.shape == w.shape and g.dtype == torch.float32, k
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), k
    assert all(p.grad is None and not p.requires_grad
               for _, p in graphs.tree_leaves(tp))


# --- the engine and memory calibrations ---------------------------------------------

# measured pipeline steps (pp, n_micro) -> seconds, handed to both packages
_PIPE_T = {(1, 1): 0.12, (1, 2): 0.19, (1, 4): 0.36,
           (2, 1): 0.21, (2, 2): 0.32, (2, 4): 0.55}


def _untied(P):
    return dataclasses.replace(P("smollm_360m").reduced(),
                               tie_embeddings=False)


def test_pipeline_ops_equal():
    for pp in (1, 2, 3, 4):
        for n_micro in (1, 2, 4, 8):
            assert tmeasured._pipeline_ops(pp, n_micro) == \
                jmeasured._pipeline_ops(pp, n_micro)


@pytest.mark.parametrize("n_dev", [1, 2])
def test_calibrate_engine_equals_reference_on_the_same_rows(monkeypatch,
                                                            n_dev):
    """With ``measure_block`` and ``measure_pipeline_step`` patched to the
    same rows in both packages, the fitted ``EngineConfig``, the points
    and the registered accelerator are the reference's.  ``pp`` runs over
    the distinct devices: 1 on the CPU; 2 cards (the count patched, and
    the card keyed ``"cpu-host"`` so both price one entry) give the
    reference's 2-device grid."""
    for hw in (jhw, thw):
        monkeypatch.setitem(hw.ACCELERATORS, "cpu-host",
                            hw.ACCELERATORS["cpu-host"])
    rows = _ROWS[0]
    monkeypatch.setattr(jmeasured, "measure_block",
                        lambda cfg, s, *a, **kw: rows)
    monkeypatch.setattr(tmeasured, "measure_block",
                        lambda cfg, s, *a, **kw: rows)
    seen = []
    monkeypatch.setattr(jmeasured, "measure_pipeline_step",
                        lambda cfg, pp, nm, mbs, s: _PIPE_T[pp, nm])
    monkeypatch.setattr(tmeasured, "measure_pipeline_step",
                        lambda cfg, pp, nm, mbs, s, **kw: seen.append(
                            (pp, nm, mbs, s, cfg.tie_embeddings,
                             kw["device"].type)) or _PIPE_T[pp, nm])
    monkeypatch.setattr(jmeasured.jax, "devices", lambda *a: [None] * n_dev)
    device = "cpu"
    if n_dev == 2:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(tmeasured.at, "default_chip",
                            lambda dev: "cpu-host")
        device = "cuda"
    got = tmeasured.calibrate_engine(_untied(tget), device=device)
    want = jmeasured.calibrate_engine(_untied(jget))
    assert dataclasses.asdict(got.engine_cfg) == \
        dataclasses.asdict(want.engine_cfg)
    assert got.engine_cfg.fixed_overhead_s > 0
    assert got.points == want.points and len(got.points) == 3 * n_dev
    assert dataclasses.asdict(got.accelerator) == \
        dataclasses.asdict(want.accelerator)
    assert thw.ACCELERATORS["cpu-host"] == got.accelerator
    assert seen == [(pp, nm, 2, 32, False, device)
                    for pp in range(1, n_dev + 1) for nm in (1, 2, 4)]


def test_measure_pipeline_step_runs_the_eager_pipeline_on_the_cpu():
    t = tmeasured.measure_pipeline_step(_untied(tget), 2, 2, 2, 16, iters=1,
                                        device="cpu")
    assert np.isfinite(t) and t > 0


def test_memory_points_and_fit_equal_the_reference(monkeypatch):
    """The reference's ``calibrate_memory`` on its own compiled programs
    (reduced smollm, untied, fp32: ``test_memory.py``'s call), each XLA
    peak recorded; the port's points on the same config, their truth
    patched to those peaks in the same order, give its ``static``, ``act``
    and ``raw_pred``, and ``fit_memory`` on its rows its
    ``MemoryModelConfig``."""
    peaks = []
    real = jmeasured.xla_peak_bytes
    monkeypatch.setattr(jmeasured, "xla_peak_bytes",
                        lambda c: peaks.append(real(c)) or peaks[-1])
    want = jmeasured.calibrate_memory([_untied(jget)], seq_len=32,
                                      mbs_grid=(1, 2))
    truth, calls = iter(peaks), []
    monkeypatch.setattr(tmeasured, "_train_peak",
                        lambda cfg, s, mbs, nm, dev: calls.append(
                            ("train", s, mbs, nm)) or next(truth))
    monkeypatch.setattr(tmeasured, "_stage_peak",
                        lambda cfg, st, s, mbs, dev: calls.append(
                            ("stage", st.index, s, mbs)) or next(truth))
    tcfg = _untied(tget)
    rows = (tmeasured._train_memory_points(tcfg, 32, (1, 2))
            + tmeasured._stage_memory_points(tcfg, 32, 2))
    assert rows == want.points and len(rows) == 4
    assert calls == [("train", 32, 1, 2), ("train", 32, 2, 2),
                     ("stage", 0, 32, 2), ("stage", 1, 32, 2)]
    base = tmeasured._host_mem_base(tcfg)
    assert dataclasses.asdict(base) == \
        dataclasses.asdict(jmeasured._host_mem_base())
    assert dataclasses.asdict(tmeasured.fit_memory(rows, base)) == \
        dataclasses.asdict(want.mem_cfg)


def test_memory_base_takes_the_runtime_dtypes():
    """bf16 params and activations are priced at 2 bytes; gradient sums
    and AdamW's moments stay fp32 (the port's buffers)."""
    cfg = dataclasses.replace(tget("smollm_360m"), tie_embeddings=False)
    base = tmeasured._host_mem_base(cfg)
    assert (base.param_bytes, base.grad_bytes, base.opt_bytes,
            base.act_bytes) == (2, 4, 8, 2)
    assert (base.fragmentation, base.act_fragmentation,
            base.runtime_overhead, base.dp_bucket_frac) == (1.0, 1.0, 0.0,
                                                            0.0)


def test_calibrate_memory_raises_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tmeasured, "_train_peak",
                        lambda *a: pytest.fail("measured"))
    with pytest.raises(ValueError, match="allocator"):
        tmeasured.calibrate_memory([_untied(tget)], device="cpu")
    with pytest.raises(ValueError, match="allocator"):
        tmeasured.program_peak_bytes(lambda: None, 0, "cpu")
